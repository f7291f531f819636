"""Cluster state model: workloads, placements, GPUs (paper Sec 2.1).

A *workload* is one replica of an LLM-inferencing deployment, matched to a
partition profile.  A *configuration* (paper terminology) is the set of
partitions + workload assignments on a GPU; here a ``GPUState`` holds the
placements directly (partition == placement, since under DRA a partition is
created per workload placement).

Performance model
-----------------
``GPUState`` keeps an incrementally-maintained occupancy cache (memory
position -> wid, plus used-slice / media-extension counters) so feasibility
checks are O(profile span) instead of O(placements x span) rebuilds.  The
cache survives direct mutation of ``placements`` (some callers backtrack by
editing the list) by keying it on a tuple snapshot of the list.

``ClusterState.transaction()`` provides an O(1)-per-op apply/undo journal so
trial placements (compaction vacate search, baseline replays, online
what-ifs) no longer need ``clone()`` of the whole cluster: mutate in place,
then ``rollback()`` to restore byte-identical state, or commit by falling
off the end of the ``with`` block.  Inside a transaction, use the
*cluster-level* ``place`` / ``remove`` / ``add_workload`` mutators — direct
``GPUState`` mutation is legal but bypasses the journal.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from .profiles import A100_80GB, DeviceModel, Profile

__all__ = [
    "Workload",
    "Placement",
    "GPUState",
    "ClusterState",
    "Transaction",
    "HEALTH_STATES",
]


@dataclasses.dataclass(frozen=True)
class Workload:
    """One model replica to be hosted in a MIG partition."""

    wid: str
    profile_id: int
    #: model tag, used by the serving layer; irrelevant to placement math.
    model: str = ""
    #: per-workload placement reward p_w and migration penalty gamma^M_w.
    reward: float = 100.0
    migration_cost: float = 1.0
    #: device-model name this workload's profile_id refers to; blank means
    #: "whatever the (homogeneous) cluster runs".  Heterogeneous fleets set
    #: it so the placement engine can route to compatible GPUs only.
    device_kind: str = ""

    def profile(self, device: DeviceModel = A100_80GB) -> Profile:
        return device.profile(self.profile_id)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A workload placed at a concrete slice index on a GPU."""

    wid: str
    profile_id: int
    index: int

    def spans(self, device: DeviceModel) -> Tuple[range, range]:
        return device.profile(self.profile_id).span(self.index, device.n_gpu_slices)


#: GPU health marks (fault injection / recovery control plane).  Anything
#: but "healthy" quarantines the GPU: the placement engine excludes it from
#: every device group, so no policy — scalar, fabric, or MIP — can land new
#: placements on it.  "degraded" (a failed memory slice) keeps surviving
#: placements serving; the other marks mean the GPU was evicted.
HEALTH_STATES = ("healthy", "failed", "draining", "maintenance", "degraded")


@dataclasses.dataclass
class GPUState:
    """One GPU (bin) with its current placements."""

    gid: str
    device: DeviceModel = A100_80GB
    placements: List[Placement] = dataclasses.field(default_factory=list)
    health: str = "healthy"

    def __post_init__(self) -> None:
        self._occ: List[Optional[str]] = []
        self._snap: Optional[Tuple[Placement, ...]] = None  # cache key
        self._used_cmp = 0
        self._used_mem = 0
        self._me_used = 0

    # ---- occupancy cache -------------------------------------------------
    def _rebuild_cache(self, snap: Tuple[Placement, ...]) -> None:
        occ: List[Optional[str]] = [None] * self.device.n_memory_slices
        cmp_ = mem_ = me_ = 0
        for pl in snap:
            prof = self.device.profile(pl.profile_id)
            span, _ = prof.span(pl.index, self.device.n_gpu_slices)
            for pos in span:
                if occ[pos] is not None:
                    raise ValueError(
                        f"{self.gid}: overlapping placements at memory pos {pos}"
                    )
                occ[pos] = pl.wid
            cmp_ += prof.compute_slices
            mem_ += prof.memory_slices
            me_ += prof.media_extensions
        self._occ = occ
        self._used_cmp, self._used_mem, self._me_used = cmp_, mem_, me_
        self._snap = snap

    def _occupancy(self) -> List[Optional[str]]:
        """The cached occupancy array (do not mutate)."""
        snap = tuple(self.placements)
        if snap != self._snap:
            self._rebuild_cache(snap)
        return self._occ

    # ---- occupancy -------------------------------------------------------
    def memory_occupancy(self) -> List[Optional[str]]:
        """memory position -> wid or None."""
        return list(self._occupancy())

    def gpu_slice_occupancy(self) -> List[Optional[str]]:
        """GPU slice -> wid or None (positions 0..n_gpu_slices-1)."""
        return list(self._occupancy()[: self.device.n_gpu_slices])

    def free_gpu_slices(self) -> List[int]:
        occ = self._occupancy()
        return [i for i in range(self.device.n_gpu_slices) if occ[i] is None]

    def used_compute_slices(self) -> int:
        self._occupancy()
        return self._used_cmp

    def used_memory_slices(self) -> int:
        self._occupancy()
        return self._used_mem

    def media_extensions_used(self) -> int:
        self._occupancy()
        return self._me_used

    def is_empty(self) -> bool:
        return not self.placements

    @property
    def schedulable(self) -> bool:
        """Eligible for NEW placements (existing ones may keep serving)."""
        return self.health == "healthy"

    # ---- feasibility -----------------------------------------------------
    def can_place_at(self, profile: Profile, index: int) -> bool:
        """Is placing ``profile`` at ``index`` feasible in the current state?"""
        if self.health != "healthy":
            return False  # quarantined: failed / draining / maintenance
        if index not in profile.allowed_indexes:
            return False
        stop = index + profile.memory_slices
        if stop > self.device.n_memory_slices:
            return False
        occ = self._occupancy()
        if any(occ[pos] is not None for pos in range(index, stop)):
            return False
        if (
            profile.media_extensions
            and self._me_used + profile.media_extensions
            > self.device.max_media_extensions
        ):
            return False
        return True

    def first_feasible_index(
        self, profile: Profile, order: Optional[Iterable[int]] = None
    ) -> Optional[int]:
        """First feasible index in ``order`` (default: Table-1 preference)."""
        for idx in profile.allowed_indexes if order is None else order:
            if self.can_place_at(profile, idx):
                return idx
        return None

    def place(self, wid: str, profile_id: int, index: int) -> Placement:
        profile = self.device.profile(profile_id)
        if not self.can_place_at(profile, index):
            raise ValueError(f"{self.gid}: cannot place {profile.name} at {index}")
        pl = Placement(wid, profile_id, index)
        self.placements.append(pl)
        # can_place_at validated the cache; extend it incrementally.
        for pos in range(index, index + profile.memory_slices):
            self._occ[pos] = wid
        self._used_cmp += profile.compute_slices
        self._used_mem += profile.memory_slices
        self._me_used += profile.media_extensions
        self._snap = self._snap + (pl,)
        return pl

    def remove(self, wid: str) -> Placement:
        for i, pl in enumerate(self.placements):
            if pl.wid == wid:
                self._occupancy()  # ensure cache is valid pre-mutation
                self.placements.pop(i)
                self._shrink_cache(pl)
                return pl
        raise KeyError(f"{self.gid}: workload {wid} not placed here")

    def _shrink_cache(self, pl: Placement) -> None:
        prof = self.device.profile(pl.profile_id)
        for pos in range(pl.index, pl.index + prof.memory_slices):
            self._occ[pos] = None
        self._used_cmp -= prof.compute_slices
        self._used_mem -= prof.memory_slices
        self._me_used -= prof.media_extensions
        self._snap = tuple(self.placements)

    # ---- journal undo primitives (Transaction only) ----------------------
    def _undo_place(self, pl: Placement) -> None:
        """Reverse a journaled place(); the placement is still last."""
        self._occupancy()
        last = self.placements.pop()
        assert last == pl, f"{self.gid}: journal out of sync ({last} != {pl})"
        self._shrink_cache(pl)

    def _undo_remove(self, pl: Placement, at: int) -> None:
        """Reverse a journaled remove(), restoring list order exactly."""
        self._occupancy()
        self.placements.insert(at, pl)
        prof = self.device.profile(pl.profile_id)
        for pos in range(pl.index, pl.index + prof.memory_slices):
            self._occ[pos] = pl.wid
        self._used_cmp += prof.compute_slices
        self._used_mem += prof.memory_slices
        self._me_used += prof.media_extensions
        self._snap = tuple(self.placements)

    # ---- wastage (index-level; Table 3 semantics) -------------------------
    def compute_waste(self) -> int:
        """GPU slices blocked by placements but not backed by compute."""
        return sum(
            self.device.profile(p.profile_id).compute_waste_at(
                p.index, self.device.n_gpu_slices
            )
            for p in self.placements
        )

    def memory_waste(self) -> int:
        """Stranded extra memory position (m7 unusable; paper 3.2.3)."""
        if not self.device.extra_memory:
            return 0
        occ = self._occupancy()
        last_gpu_slice = self.device.n_gpu_slices - 1  # slice 6
        extra_pos = self.device.n_memory_slices - 1  # m7
        holder = occ[last_gpu_slice]
        if holder is not None and occ[extra_pos] is None:
            # slice 6 is held by a partition that does not extend into m7
            # (e.g. profile 19 at index 6) -> m7 is unusable.
            return 1
        return 0

    def fragmentation(self) -> float:
        """Free-slice fragmentation in [0, 1) (Ting et al.'s free-space health).

        ``1 - largest_free_run / total_free`` over memory positions: 0.0 when
        the free space is one contiguous run (or the GPU is full), approaching
        1 as the free space shatters into many small runs that cannot host
        large profiles.
        """
        occ = self._occupancy()
        total = best = run = 0
        for pos in range(self.device.n_memory_slices):
            if occ[pos] is None:
                total += 1
                run += 1
                if run > best:
                    best = run
            else:
                run = 0
        if total == 0:
            return 0.0
        return 1.0 - best / total

    def joint_slice_utilization(self) -> float:
        """(s_m + s_c) / (S_m + S_c) — heuristic GPU sort key (Sec 4.2)."""
        self._occupancy()
        return (self._used_mem + self._used_cmp) / (
            self.device.n_memory_slices + self.device.n_gpu_slices
        )

    def clone(self) -> "GPUState":
        return GPUState(self.gid, self.device, list(self.placements), self.health)


# ---------------------------------------------------------------------------
# transactions
# ---------------------------------------------------------------------------
class Transaction:
    """Undo journal over a ClusterState (O(1) record per mutation).

    Obtained from ``ClusterState.transaction()``.  Mutations made through the
    cluster-level mutators while the transaction is the innermost open one
    are journaled.  ``rollback()`` restores the exact pre-transaction state
    (placement list order included); falling off the ``with`` block commits
    (an inner transaction's ops are spliced into its parent so an outer
    rollback still undoes them).  An exception rolls back automatically.
    """

    def __init__(self, state: "ClusterState", parent: Optional["Transaction"]):
        self._state = state
        self._parent = parent
        self._ops: List[Tuple] = []
        self.closed = False

    # -- recording (ClusterState only) --
    def _record(self, op: Tuple) -> None:
        if not self.closed:
            self._ops.append(op)

    # -- lifecycle --
    def rollback(self) -> None:
        """Undo every journaled op, newest first; the txn becomes inert."""
        if self.closed:
            return
        st = self._state
        for op in reversed(self._ops):
            kind = op[0]
            if kind == "place":
                _, gid, pl = op
                st.gpus[gid]._undo_place(pl)
            elif kind == "remove":
                _, gid, pl, at = op
                st.gpus[gid]._undo_remove(pl, at)
            elif kind == "add_wl":
                _, wid, prev = op
                if prev is None:
                    st.workloads.pop(wid, None)
                else:
                    st.workloads[wid] = prev
            elif kind == "health":
                _, gid, prev = op
                st.gpus[gid].health = prev
            else:  # pragma: no cover - journal is internal
                raise AssertionError(f"unknown journal op {kind}")
        self._ops.clear()
        self.closed = True

    def commit(self) -> None:
        """Keep the mutations; splice ops into the parent txn if any.

        A root transaction on a *linked* state (an engine sub-view, see
        ``ClusterState.link_journal_parent``) forwards its ops to the parent
        state's innermost open transaction, so an engine-level rollback can
        undo policy work done through per-group views.
        """
        if self.closed:
            return
        if self._parent is not None:
            self._parent._ops.extend(self._ops)
        else:
            parent_state = self._state.__dict__.get("_journal_parent")
            if parent_state is not None:
                for op in self._ops:
                    parent_state._journal(op)
        self._ops.clear()
        self.closed = True

    # -- context manager --
    def __enter__(self) -> "Transaction":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.rollback()
        else:
            self.commit()
        assert self._state._txns and self._state._txns[-1] is self
        self._state._txns.pop()
        return False


@dataclasses.dataclass
class ClusterState:
    """A cluster of (possibly heterogeneous) MIG-capable GPUs."""

    gpus: Dict[str, GPUState] = dataclasses.field(default_factory=dict)
    workloads: Dict[str, Workload] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self._txns: List[Transaction] = []

    @classmethod
    def homogeneous(
        cls, n_gpus: int, device: DeviceModel = A100_80GB, prefix: str = "gpu"
    ) -> "ClusterState":
        return cls(
            gpus={
                f"{prefix}{i}": GPUState(f"{prefix}{i}", device)
                for i in range(n_gpus)
            }
        )

    # ---- lookups ----------------------------------------------------------
    def gpu_of(self, wid: str) -> Optional[str]:
        for gid, gpu in self.gpus.items():
            if any(p.wid == wid for p in gpu.placements):
                return gid
        return None

    def placement_of(self, wid: str) -> Optional[Tuple[str, Placement]]:
        for gid, gpu in self.gpus.items():
            for p in gpu.placements:
                if p.wid == wid:
                    return gid, p
        return None

    def used_gpus(self) -> List[GPUState]:
        return [g for g in self.gpus.values() if not g.is_empty()]

    def free_gpus(self) -> List[GPUState]:
        return [g for g in self.gpus.values() if g.is_empty()]

    def placed_workloads(self) -> List[Workload]:
        out = []
        for gpu in self.gpus.values():
            for p in gpu.placements:
                out.append(self.workloads[p.wid])
        return out

    def ordered_gids(self) -> List[str]:
        return sorted(self.gpus.keys())

    # ---- transactional mutators -------------------------------------------
    def transaction(self) -> Transaction:
        """Open a (nestable) undo journal; use as ``with state.transaction() as txn``."""
        txn = Transaction(self, self._txns[-1] if self._txns else None)
        self._txns.append(txn)
        return txn

    def _journal(self, op: Tuple) -> None:
        # Nearest OPEN transaction: after an inner rollback() (closed but not
        # yet exited), subsequent ops must still journal to the ancestor so an
        # outer rollback stays byte-identical.
        for txn in reversed(self._txns):
            if not txn.closed:
                txn._record(op)
                return
        # No open txn here: forward to a linked parent state (engine
        # sub-views share GPUState objects and the workload dict with their
        # parent, so the parent's journal can undo these ops directly).
        parent = self.__dict__.get("_journal_parent")
        if parent is not None:
            parent._journal(op)

    def link_journal_parent(self, parent: Optional["ClusterState"]) -> None:
        """Forward journal ops to ``parent`` when no local txn is open.

        Used for engine sub-views: the view shares ``GPUState`` objects and
        the workloads dict with ``parent``, so ops recorded on the view are
        undoable through the parent's transactions.
        """
        self.__dict__["_journal_parent"] = parent

    def add_workload(self, w: Workload) -> None:
        self._journal(("add_wl", w.wid, self.workloads.get(w.wid)))
        self.workloads[w.wid] = w

    def forget_workload(self, wid: str) -> Optional[Workload]:
        """Journaled deregistration (fault eviction: the replica leaves the
        system, but a transaction rollback restores it byte-identically)."""
        prev = self.workloads.pop(wid, None)
        if prev is not None:
            self._journal(("add_wl", wid, prev))
        return prev

    def set_health(self, gid: str, health: str) -> None:
        """Journaled GPU health mark (see ``HEALTH_STATES``)."""
        if health not in HEALTH_STATES:
            raise ValueError(
                f"health must be one of {HEALTH_STATES}, got {health!r}"
            )
        gpu = self.gpus[gid]
        if gpu.health == health:
            return
        self._journal(("health", gid, gpu.health))
        gpu.health = health

    def place(
        self, wid: str, gid: str, index: int, profile_id: Optional[int] = None
    ) -> Placement:
        if profile_id is None:
            profile_id = self.workloads[wid].profile_id
        pl = self.gpus[gid].place(wid, profile_id, index)
        self._journal(("place", gid, pl))
        return pl

    def remove(self, wid: str, gid: Optional[str] = None) -> Placement:
        """Journaled unplacement (the workload stays registered)."""
        if gid is None:
            gid = self.gpu_of(wid)
            if gid is None:
                raise KeyError(f"workload {wid} is not placed")
        gpu = self.gpus[gid]
        at = next((i for i, p in enumerate(gpu.placements) if p.wid == wid), None)
        if at is None:
            raise KeyError(f"{gid}: workload {wid} not placed here")
        pl = gpu.remove(wid)
        self._journal(("remove", gid, pl, at))
        return pl

    def adopt(self, layout: "ClusterState") -> None:
        """Diff-apply ``layout``'s placements onto this state, journaled.

        Solver policies (MIP, patterns, fresh-replay reconfigurations) build
        their result in a scratch state; ``adopt`` lands it here through the
        cluster-level mutators, so the change is (a) journaled — an engine
        transaction can reject the whole plan with an O(ops) rollback — and
        (b) identity-preserving: ``GPUState`` objects are never swapped out,
        which keeps sub-views and fabric mirrors valid.

        Workloads registered in ``layout`` are registered here; placements
        present here but moved/absent in ``layout`` are removed before the
        new spots are filled.
        """
        want: Dict[str, Tuple[str, Placement]] = {
            p.wid: (gid, p)
            for gid, g in layout.gpus.items()
            for p in g.placements
        }
        have: Dict[str, Tuple[str, Placement]] = {
            p.wid: (gid, p)
            for gid, g in self.gpus.items()
            for p in g.placements
        }
        for wid, w in layout.workloads.items():
            if self.workloads.get(wid) != w:
                self.add_workload(w)
        for wid, (gid, pl) in have.items():
            if want.get(wid) != (gid, pl):
                self.remove(wid, gid)
        for wid, (gid, pl) in want.items():
            if have.get(wid) != (gid, pl):
                self.place(wid, gid, pl.index, profile_id=pl.profile_id)

    def clone(self) -> "ClusterState":
        return ClusterState(
            gpus={gid: g.clone() for gid, g in self.gpus.items()},
            workloads=dict(self.workloads),
        )

    def validate(self) -> None:
        """Raise if any GPU has overlapping/illegal placements."""
        for gpu in self.gpus.values():
            gpu._occupancy()
            for p in gpu.placements:
                prof = gpu.device.profile(p.profile_id)
                if p.index not in prof.allowed_indexes:
                    raise ValueError(
                        f"{gpu.gid}: {prof.name} at illegal index {p.index}"
                    )
