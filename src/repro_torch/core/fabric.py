"""Vectorized placement fabric: batched feasibility/scoring (fleet scale).

The scalar placement core (``state.py`` / ``baselines.py`` / ``heuristic.py``)
checks one (gpu, index, profile) candidate at a time — fine for the paper's
8–80 GPU evaluation, quadratic pain for fleets of thousands of
devices.  This module keeps a *dense array mirror* of the whole fleet and
answers feasibility/scoring queries for **all** (gpu, start-index, profile)
triples in one batched sweep:

  * ``FleetFabric``   — one row per GPU, padded across heterogeneous
                        ``DeviceModel``s: occupancy bitmask ``occ[g, m]``,
                        per-row slice counts, media-extension budgets, and
                        per-device profile tables (memory/compute spans,
                        Table-1 allowed-index masks, preference ranks).
  * feasibility       — a batched sweep (numpy, or torch ops on a device)
                        reproducing
                        ``GPUState.can_place_at`` exactly: allowed-index,
                        span-fit (incl. the m7 attachment rule, which falls
                        out of the span arithmetic), overlap, and
                        media-extension constraints.
  * scoring           — fragmentation-aware placement scores per Ting et al.
                        ("An Online Fragmentation-Aware Scheduler ..."):
                        post-placement free-run fragmentation delta plus
                        compute/memory wastage (slice-6 truncation, m7
                        stranding).
  * fast paths        — ``fabric_first_fit`` / ``fabric_load_balanced`` /
                        ``fabric_initial_deployment`` are placement-identical
                        to their scalar references (tie-breaks included) but
                        replace the per-candidate Python scan with one
                        sweep per workload; ``fabric_frag_aware_*`` implement
                        the new ``frag_aware`` policy.

Parity contract
---------------
For any ``ClusterState``, ``FleetFabric(state).feasible_all()[g, p, i]`` is
True iff ``state.gpus[gid_g].can_place_at(profile_p, i)`` — property-tested
in ``tests/test_fabric.py`` on randomized heterogeneous fleets.  The fast
paths must pick byte-identical (gid, index) spots to the scalar policies.

Where the full sweeps run is ``device`` on ``FleetFabric``,
``fleet_fabric`` and every ``fabric_*`` entry point:

  * a torch device, ``"cuda"`` by default (resolved by
    ``repro_torch.resolve_device``: ``"cuda"`` without a GPU raises, and
    ``"cpu"`` runs the same ops on the host) — ``_feasible_all_torch`` /
    ``_score_all_torch``, one chain of tensor ops per device kind over the
    whole ``(G, P, I)`` slab, broadcast over the profile axis as
    ``(G, P, I, M)`` where the reference ``vmap``s its jitted kernels (which
    run on its accelerator whenever JAX is installed).  The mirror stays on
    the host: each full sweep copies the occupancy, the per-row vectors and
    the profile tables to the device once and brings the slabs back,
    bit-identical to the numpy sweep (bools and int32s);
  * ``None``, asked for explicitly — the numpy sweeps, written against an
    ``xp`` array module and looped over profiles: the reference's own
    JAX-free path.

The single-row refresh after ``apply``/``unapply`` is numpy on the host
whatever the device, as it is in the reference.  The placement engine
turns the fabric on only at 128 or more GPUs in ``"auto"`` mode.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..obs import get_telemetry
from .profiles import DeviceModel, Profile
from .state import ClusterState, Placement, Workload

__all__ = [
    "FleetFabric",
    "fleet_fabric",
    "fabric_first_fit",
    "fabric_load_balanced",
    "fabric_initial_deployment",
    "fabric_frag_aware_deploy",
    "fabric_frag_aware_compact",
    "fabric_frag_aware_reconfigure",
    "replay_fresh_deploy",
]

#: preference rank sentinel for disallowed (profile, index) pairs.
_NO_RANK = np.int32(32767)


# ---------------------------------------------------------------------------
# kernels (written against an ``xp`` array module; numpy here, and
# broadcast over every profile at once in the torch sweeps below)
# ---------------------------------------------------------------------------
def _feasible_kernel(xp, occ, n_mem, me_used, me_cap, mem_sl, me_req, allowed, mask):
    """Feasibility of one profile at every (gpu, index).

    occ (G, M) bool, n_mem/me_used/me_cap (G,), mem_sl/me_req scalars,
    allowed (I,) bool, mask (G,) bool (candidate rows) -> (G, I) bool.

    Reproduces ``GPUState.can_place_at``: index allowed, span inside the
    device's memory positions, span free, media-extension budget respected.
    """
    M = occ.shape[1]
    idx = xp.arange(M)
    pos = xp.arange(M)
    span = (pos[None, :] >= idx[:, None]) & (pos[None, :] < idx[:, None] + mem_sl)
    overlap = (occ[:, None, :] & span[None, :, :]).any(axis=-1)  # (G, I)
    fits = idx[None, :] + mem_sl <= n_mem[:, None]  # (G, I)
    me_ok = me_used + me_req <= me_cap  # (G,)
    return allowed[None, :] & fits & ~overlap & me_ok[:, None] & mask[:, None]


def _score_kernel(xp, occ, n_mem, n_gpu, extra_mem, mem_sl, cmp_sl):
    """Fragmentation/wastage scores of one profile at every (gpu, index).

    Returns (waste_delta, frag_runs_after), both (G, I) int32:

    * ``waste_delta``    — compute slices blocked-but-unusable by the span
                           (slice-6 truncation, paper 3.2.3) plus the change
                           in m7 stranding this placement causes.
    * ``frag_runs_after``— number of maximal free runs in the post-placement
                           occupancy (fewer/longer runs = less fragmented,
                           Ting et al.'s free-space health).

    Only meaningful where the placement is feasible; callers mask.
    """
    M = occ.shape[1]
    idx = xp.arange(M)
    pos = xp.arange(M)
    span = (pos[None, :] >= idx[:, None]) & (pos[None, :] < idx[:, None] + mem_sl)
    post = occ[:, None, :] | span[None, :, :]  # (G, I, M)

    # free runs after placement (padding rows of occ are pre-marked occupied,
    # so runs never cross the device's real memory boundary).
    free = ~post
    prev = xp.concatenate(
        [xp.zeros_like(free[..., :1]), free[..., :-1]], axis=-1
    )
    runs_after = (free & ~prev).sum(axis=-1).astype(xp.int32)  # (G, I)

    # compute wastage of the span itself: GPU slices covered minus compute.
    gpu_cover = xp.minimum(idx[None, :] + mem_sl, n_gpu[:, None]) - idx[None, :]
    waste_c = (gpu_cover - cmp_sl).astype(xp.int32)  # (G, I)

    # m7 stranding delta (extra-memory devices only): slice n_gpu-1 held
    # while position n_mem-1 stays free -> 1 stranded memory position.
    last_gpu = xp.take_along_axis(
        post, (n_gpu - 1)[:, None, None], axis=2
    )[..., 0]
    extra_pos = xp.take_along_axis(
        post, (n_mem - 1)[:, None, None], axis=2
    )[..., 0]
    stranded_after = (last_gpu & ~extra_pos) & extra_mem[:, None]
    occ_last = xp.take_along_axis(occ, (n_gpu - 1)[:, None], axis=1)[..., 0]
    occ_extra = xp.take_along_axis(occ, (n_mem - 1)[:, None], axis=1)[..., 0]
    stranded_before = (occ_last & ~occ_extra) & extra_mem
    waste_delta = waste_c + stranded_after.astype(xp.int32) - stranded_before[
        :, None
    ].astype(xp.int32)
    return waste_delta, runs_after


_feasible_np = functools.partial(_feasible_kernel, np)
_score_np = functools.partial(_score_kernel, np)


def _feasible_all_np(occ, n_mem, me_used, me_cap, mem_sl, me_req, allowed, mask):
    return np.stack(
        [
            _feasible_np(
                occ, n_mem, me_used, me_cap, mem_sl[p], me_req[p], allowed[p], mask
            )
            for p in range(len(mem_sl))
        ],
        axis=1,
    )


def _score_all_np(occ, n_mem, n_gpu, extra_mem, mem_sl, cmp_sl):
    per = [
        _score_np(occ, n_mem, n_gpu, extra_mem, mem_sl[p], cmp_sl[p])
        for p in range(len(mem_sl))
    ]
    return (
        np.stack([w for w, _ in per], axis=1),
        np.stack([f for _, f in per], axis=1),
    )


def _feasible_all_torch(occ, n_mem, me_used, me_cap, mem_sl, me_req, allowed, mask):
    """``_feasible_all_np`` as one chain of torch ops on the device the
    arguments (tensors, all on one device) live on.

    The profile axis is broadcast, not looped: spans are (P, I, M) and the
    overlap test (G, P, I, M).  Returns the (G, P, I) bool slab as numpy.
    """
    idx = torch.arange(occ.shape[1], device=occ.device)
    start = idx[None, :, None]  # (1, I, 1)
    end = start + mem_sl[:, None, None]  # (P, I, 1)
    span = (idx >= start) & (idx < end)  # (P, I, M)
    overlap = (occ[:, None, None, :] & span).any(dim=-1)  # (G, P, I)
    fits = end[None, ..., 0] <= n_mem[:, None, None]  # (G, P, I)
    me_ok = me_used[:, None] + me_req[None, :] <= me_cap[:, None]  # (G, P)
    feas = allowed & fits & ~overlap & me_ok[..., None] & mask[:, None, None]
    return feas.cpu().numpy()


def _score_all_torch(occ, n_mem, n_gpu, extra_mem, mem_sl, cmp_sl):
    """``_score_all_np`` as one chain of torch ops on the arguments'
    device: the post-placement occupancy of every (gpu, profile, index) is
    one (G, P, I, M) tensor.  Returns (waste_delta, frag_runs_after), both
    (G, P, I) int32 numpy slabs."""
    idx = torch.arange(occ.shape[1], device=occ.device)
    start = idx[None, :, None]
    end = start + mem_sl[:, None, None]
    span = (idx >= start) & (idx < end)  # (P, I, M)
    post = occ[:, None, None, :] | span  # (G, P, I, M)

    free = ~post
    prev = torch.cat([torch.zeros_like(free[..., :1]), free[..., :-1]], dim=-1)
    runs_after = (free & ~prev).sum(dim=-1).to(torch.int32)  # (G, P, I)

    gpu_cover = torch.minimum(end[None, ..., 0], n_gpu[:, None, None]) - idx
    waste_c = (gpu_cover - cmp_sl[None, :, None]).to(torch.int32)  # (G, P, I)

    last = (n_gpu - 1).long()[:, None]  # (G, 1)
    extra = (n_mem - 1).long()[:, None]
    last_gpu = torch.take_along_dim(post, last[:, :, None, None], dim=3)[..., 0]
    extra_pos = torch.take_along_dim(post, extra[:, :, None, None], dim=3)[..., 0]
    stranded_after = last_gpu & ~extra_pos & extra_mem[:, None, None]
    occ_last = torch.take_along_dim(occ, last, dim=1)[:, 0]
    occ_extra = torch.take_along_dim(occ, extra, dim=1)[:, 0]
    stranded_before = occ_last & ~occ_extra & extra_mem
    waste_delta = (waste_c + stranded_after.to(torch.int32)
                   - stranded_before[:, None, None].to(torch.int32))
    return waste_delta.cpu().numpy(), runs_after.cpu().numpy()


#: where a fabric's full sweeps run: a torch device, or None for numpy
Device = Optional[Union[str, torch.device]]


def _resolve(device: Device) -> Optional[torch.device]:
    return None if device is None else resolve_device(device)


# ---------------------------------------------------------------------------
# per-device-kind profile tables
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _KindTable:
    device: DeviceModel
    #: profile-id -> slot (row in the arrays below; == position in device.profiles)
    slot_of: Dict[int, int]
    mem_sl: np.ndarray  # (P,) int32
    cmp_sl: np.ndarray  # (P,) int32
    me_req: np.ndarray  # (P,) int32
    allowed: np.ndarray  # (P, I) bool
    pref_rank: np.ndarray  # (P, I) int32; _NO_RANK where disallowed


def _kind_table(device: DeviceModel, n_idx: int) -> _KindTable:
    profs = device.profiles
    P = len(profs)
    mem_sl = np.zeros(P, np.int32)
    cmp_sl = np.zeros(P, np.int32)
    me_req = np.zeros(P, np.int32)
    allowed = np.zeros((P, n_idx), bool)
    pref = np.full((P, n_idx), _NO_RANK, np.int32)
    for p, prof in enumerate(profs):
        mem_sl[p] = prof.memory_slices
        cmp_sl[p] = prof.compute_slices
        me_req[p] = prof.media_extensions
        for rank, i in enumerate(prof.allowed_indexes):
            if i < n_idx:
                allowed[p, i] = True
                pref[p, i] = rank
    return _KindTable(
        device=device,
        slot_of={prof.profile_id: p for p, prof in enumerate(profs)},
        mem_sl=mem_sl,
        cmp_sl=cmp_sl,
        me_req=me_req,
        allowed=allowed,
        pref_rank=pref,
    )


# ---------------------------------------------------------------------------
# the fabric
# ---------------------------------------------------------------------------
class FleetFabric:
    """Dense array mirror of a ``ClusterState`` (rows in sorted-gid order).

    The mirror is built once (O(G·M)) and updated incrementally through
    ``apply`` / ``unapply`` as the caller mutates the backing state.

    Feasibility and scores for **all** (gpu, profile, index) triples are
    computed by one batched sweep (``feasible_all`` / ``scores_all``) on
    ``device`` (default ``"cuda"``; None: numpy; see the module docstring)
    and cached; a
    placement changes exactly one row, so ``apply``/``unapply`` refresh that
    row alone (O(P·I·M) scalar work, numpy on the host).  Spot picking is then a
    pure O(G) reduction per workload — no per-candidate Python scanning and
    no kernel dispatch inside the sequential deploy loop.
    """

    def __init__(self, state: ClusterState, device: Device = "cuda"):
        #: where the full sweeps run (None: numpy on the host).
        self.device = _resolve(device)
        self.gids: List[str] = state.ordered_gids()
        self.row_of: Dict[str, int] = {g: r for r, g in enumerate(self.gids)}
        devices: List[DeviceModel] = [state.gpus[g].device for g in self.gids]
        #: max memory positions across kinds == index grid size (padded rows).
        self.M = max((d.n_memory_slices for d in devices), default=1)

        self.kinds: List[str] = []
        self.tables: Dict[str, _KindTable] = {}
        kind_id = np.zeros(len(self.gids), np.int32)
        for r, dev in enumerate(devices):
            if dev.name not in self.tables:
                self.tables[dev.name] = _kind_table(dev, self.M)
                self.kinds.append(dev.name)
            kind_id[r] = self.kinds.index(dev.name)
        self.kind_id = kind_id

        G = len(self.gids)
        self.occ = np.ones((G, self.M), bool)  # padding stays occupied
        self.n_mem = np.zeros(G, np.int32)
        self.n_gpu = np.zeros(G, np.int32)
        self.me_cap = np.zeros(G, np.int32)
        self.me_used = np.zeros(G, np.int32)
        self.used_mem = np.zeros(G, np.int32)
        self.used_cmp = np.zeros(G, np.int32)
        self.extra_mem = np.zeros(G, bool)
        self.n_placements = np.zeros(G, np.int32)
        for r, gid in enumerate(self.gids):
            gpu = state.gpus[gid]
            dev = gpu.device
            self.n_mem[r] = dev.n_memory_slices
            self.n_gpu[r] = dev.n_gpu_slices
            self.me_cap[r] = dev.max_media_extensions
            self.extra_mem[r] = dev.extra_memory
            occ_row = gpu.memory_occupancy()
            self.occ[r, : dev.n_memory_slices] = [o is not None for o in occ_row]
            self.me_used[r] = gpu.media_extensions_used()
            self.used_mem[r] = gpu.used_memory_slices()
            self.used_cmp[r] = gpu.used_compute_slices()
            self.n_placements[r] = len(gpu.placements)

        self.P_max = max(
            (len(t.device.profiles) for t in self.tables.values()), default=1
        )
        #: lazily-built all-triple caches, row-refreshed on apply/unapply.
        self._feas: Optional[np.ndarray] = None  # (G, P_max, I) bool
        self._waste: Optional[np.ndarray] = None  # (G, P_max, I) int32
        self._frag: Optional[np.ndarray] = None  # (G, P_max, I) int32
        #: per-row placement snapshots for cross-call sync(); None = the row
        #: was mutated through apply/unapply and re-syncs from the state.
        self._snaps: List[Optional[Tuple[Placement, ...]]] = [
            tuple(state.gpus[g].placements) for g in self.gids
        ]

    # -- bookkeeping ---------------------------------------------------------
    def _table_for(self, kind: Optional[str]) -> _KindTable:
        if kind is None:
            if len(self.tables) > 1:
                raise ValueError(
                    "profile kind is ambiguous on a mixed fleet; pass device_kind"
                )
            kind = self.kinds[0]
        return self.tables[kind]

    def _profile(self, profile_id: int, kind: Optional[str]) -> Tuple[_KindTable, int]:
        tab = self._table_for(kind)
        return tab, tab.slot_of[profile_id]

    def kind_mask(self, kind: Optional[str]) -> np.ndarray:
        if kind is None:
            return np.ones(len(self.gids), bool)
        return self.kind_id == self.kinds.index(kind)

    def apply(self, gid: str, profile: Profile, index: int) -> None:
        """Mirror a ``state.place`` the caller just performed."""
        r = self.row_of[gid]
        self.occ[r, index : index + profile.memory_slices] = True
        self.used_mem[r] += profile.memory_slices
        self.used_cmp[r] += profile.compute_slices
        self.me_used[r] += profile.media_extensions
        self.n_placements[r] += 1
        self._snaps[r] = None
        self._refresh_row(r)

    def unapply(self, gid: str, profile: Profile, index: int) -> None:
        """Mirror a ``state.remove`` the caller just performed."""
        r = self.row_of[gid]
        self.occ[r, index : index + profile.memory_slices] = False
        self.used_mem[r] -= profile.memory_slices
        self.used_cmp[r] -= profile.compute_slices
        self.me_used[r] -= profile.media_extensions
        self.n_placements[r] -= 1
        self._snaps[r] = None
        self._refresh_row(r)

    def _rebuild_row(self, r: int, gpu) -> None:
        """Re-read one row's mirrors straight from its GPUState."""
        dev = gpu.device
        self.occ[r, :] = True
        occ_row = gpu.memory_occupancy()
        self.occ[r, : dev.n_memory_slices] = [o is not None for o in occ_row]
        self.me_used[r] = gpu.media_extensions_used()
        self.used_mem[r] = gpu.used_memory_slices()
        self.used_cmp[r] = gpu.used_compute_slices()
        self.n_placements[r] = len(gpu.placements)
        self._refresh_row(r)

    def sync(self, state: ClusterState) -> bool:
        """Refresh rows whose placements changed since the last build/sync.

        Returns False when the fleet's shape changed (gids or device models)
        and the mirror must be rebuilt from scratch.  Steady-state cost is
        one O(placements) tuple snapshot per row; only mutated rows pay the
        O(P·I·M) slab refresh — this is what makes one persistent fabric per
        ClusterState (``fleet_fabric``) cheap across online arrival events.
        """
        if self.gids != state.ordered_gids():
            return False
        tel = get_telemetry()
        t0 = time.perf_counter() if tel.enabled else 0.0
        refreshed = 0
        for r, gid in enumerate(self.gids):
            gpu = state.gpus[gid]
            if gpu.device.name != self.kinds[self.kind_id[r]]:
                return False
            snap = tuple(gpu.placements)
            if snap != self._snaps[r]:
                self._rebuild_row(r, gpu)
                self._snaps[r] = snap
                refreshed += 1
        if tel.enabled:
            tel.metrics.histogram(
                "fabric_refresh_seconds",
                "per-sync cost of refreshing mutated fabric rows",
            ).observe(time.perf_counter() - t0)
            if refreshed:
                tel.metrics.counter(
                    "fabric_rows_refreshed_total",
                    "fabric rows rebuilt from their GPUState",
                ).inc(refreshed)
        return True

    def _refresh_row(self, r: int) -> None:
        """Recompute the cached all-triple slabs for one mutated row."""
        tab = self.tables[self.kinds[self.kind_id[r]]]
        sl = slice(r, r + 1)
        one = np.ones(1, bool)
        if self._feas is not None:
            got = _feasible_all_np(
                self.occ[sl], self.n_mem[sl], self.me_used[sl], self.me_cap[sl],
                tab.mem_sl, tab.me_req, tab.allowed, one,
            )
            self._feas[r] = False
            self._feas[r, : got.shape[1]] = got[0]
        if self._waste is not None:
            w, f = _score_all_np(
                self.occ[sl], self.n_mem[sl], self.n_gpu[sl], self.extra_mem[sl],
                tab.mem_sl, tab.cmp_sl,
            )
            self._waste[r, : w.shape[1]] = w[0]
            self._frag[r, : f.shape[1]] = f[0]

    def util(self) -> np.ndarray:
        """Joint slice utilization per row; bit-identical to the scalar
        ``GPUState.joint_slice_utilization`` (same int operands, float64)."""
        return (self.used_mem + self.used_cmp) / (self.n_mem + self.n_gpu)

    # -- batched kernels + all-triple caches ---------------------------------
    def _feas_cache(self) -> np.ndarray:
        if self._feas is None:
            self._feas = self._sweep_feasible()
        return self._feas

    def _score_cache(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._waste is None:
            self._waste, self._frag = self._sweep_scores()
        return self._waste, self._frag

    def _on_device(self, *arrays):
        """The arrays a sweep reads, copied to ``self.device`` (the one
        place a sweep's inputs cross to the device), or the numpy arrays
        themselves without one."""
        if self.device is None:
            return arrays
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def _sweep_feasible(self) -> np.ndarray:
        """One batched kernel sweep: (G, P_max, I) feasibility, all triples."""
        tel = get_telemetry()
        t0 = time.perf_counter() if tel.enabled else 0.0
        G = len(self.gids)
        out = np.zeros((G, self.P_max, self.M), bool)
        rows = self._on_device(self.occ, self.n_mem, self.me_used, self.me_cap)
        sweep = _feasible_all_np if self.device is None else _feasible_all_torch
        for kind in self.kinds:
            tab = self.tables[kind]
            row_mask = self.kind_mask(kind if len(self.tables) > 1 else None)
            got = sweep(*rows, *self._on_device(
                tab.mem_sl, tab.me_req, tab.allowed, row_mask))
            out[:, : got.shape[1], :] |= got
        if tel.enabled:
            tel.metrics.histogram(
                "fabric_score_seconds",
                "batched kernel sweep time over all (gpu, profile, index) triples",
                labels={"kernel": "feasible"},
            ).observe(time.perf_counter() - t0)
        return out

    def _sweep_scores(self) -> Tuple[np.ndarray, np.ndarray]:
        """One batched kernel sweep: (G, P_max, I) waste_delta + frag runs."""
        tel = get_telemetry()
        t0 = time.perf_counter() if tel.enabled else 0.0
        G = len(self.gids)
        waste = np.zeros((G, self.P_max, self.M), np.int32)
        frag = np.zeros((G, self.P_max, self.M), np.int32)
        per_row = self._on_device(self.occ, self.n_mem, self.n_gpu, self.extra_mem)
        sweep = _score_all_np if self.device is None else _score_all_torch
        for kind in self.kinds:
            tab = self.tables[kind]
            rows = self.kind_mask(kind if len(self.tables) > 1 else None)
            w, f = sweep(*per_row, *self._on_device(tab.mem_sl, tab.cmp_sl))
            P = w.shape[1]
            waste[rows, :P] = w[rows]
            frag[rows, :P] = f[rows]
        if tel.enabled:
            tel.metrics.histogram(
                "fabric_score_seconds",
                "batched kernel sweep time over all (gpu, profile, index) triples",
                labels={"kernel": "score"},
            ).observe(time.perf_counter() - t0)
        return waste, frag

    def feasible_all(self) -> np.ndarray:
        """(G, P_max, I) feasibility for every (gpu, profile-slot, index).

        Profile slot ``p`` of row ``g`` refers to ``device.profiles[p]`` for
        that row's device; slots past the device's profile count are
        all-False.  Returns a copy; the cached slab is maintained
        incrementally across ``apply``/``unapply``.
        """
        return self._feas_cache().copy()

    def feasible_profile(
        self,
        profile_id: int,
        kind: Optional[str] = None,
        mask: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """(G, I) feasibility of one profile at every (gpu, index)."""
        tab, p = self._profile(profile_id, kind)
        feas = self._feas_cache()[:, p, :]
        if len(self.tables) > 1:
            feas = feas & self.kind_mask(kind)[:, None]
        if mask is not None:
            feas = feas & mask[:, None]
        return feas

    def scores_profile(
        self, profile_id: int, kind: Optional[str] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(waste_delta, frag_runs_after), both (G, I), for one profile."""
        tab, p = self._profile(profile_id, kind)
        waste, frag = self._score_cache()
        return waste[:, p, :], frag[:, p, :]

    # -- spot picking (host-side selection over kernel output) ---------------
    def pick_first_fit(
        self, profile_id: int, kind: Optional[str] = None
    ) -> Optional[Tuple[str, int]]:
        """Scalar-parity first-fit spot: first gid (sorted), lowest index."""
        feas = self.feasible_profile(profile_id, kind)
        rows = feas.any(axis=1).nonzero()[0]
        if not rows.size:
            return None
        r = int(rows[0])
        return self.gids[r], int(feas[r].argmax())

    def pick_load_balanced(
        self, profile_id: int, kind: Optional[str] = None
    ) -> Optional[Tuple[str, int]]:
        """Scalar-parity load-balanced spot: min (util, gid), lowest index."""
        feas = self.feasible_profile(profile_id, kind)
        any_feas = feas.any(axis=1)
        if not any_feas.any():
            return None
        util = self.util()
        # rows are in sorted-gid order, so the first minimal-util feasible
        # row is exactly sorted(key=(util, gid))[0] of the scalar path.
        masked = np.where(any_feas, util, np.inf)
        r = int(masked.argmin())
        return self.gids[r], int(feas[r].argmax())

    def _pref_indexes(
        self, feas: np.ndarray, tab: _KindTable, p: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row first feasible index in Table-1 preference order."""
        rank = np.where(feas, tab.pref_rank[p][None, :], _NO_RANK)
        best_rank = rank.min(axis=1)
        has = best_rank < _NO_RANK
        idx = rank.argmin(axis=1)
        return has, idx

    def pick_max_utilization(
        self,
        profile_id: int,
        kind: Optional[str] = None,
        allow_new_gpu: bool = True,
    ) -> Optional[Tuple[str, int]]:
        """Scalar-parity rule-based spot (``place_max_utilization``): among
        *used* GPUs with a preference-order feasible index, max current
        utilization (ties -> lowest gid); else the first free GPU."""
        tab, p = self._profile(profile_id, kind)
        feas = self.feasible_profile(profile_id, kind)
        has, idx = self._pref_indexes(feas, tab, p)
        used = self.n_placements > 0
        cand = has & used
        if cand.any():
            util = np.where(cand, self.util(), -np.inf)
            r = int(util.argmax())  # first max == lowest gid on ties
            return self.gids[r], int(idx[r])
        if allow_new_gpu:
            free_rows = (has & ~used).nonzero()[0]
            if free_rows.size:
                r = int(free_rows[0])
                return self.gids[r], int(idx[r])
        return None

    def pick_frag_aware(
        self,
        profile_id: int,
        kind: Optional[str] = None,
        mask: Optional[np.ndarray] = None,
        allow_new_gpu: bool = True,
    ) -> Optional[Tuple[str, int]]:
        """Fragmentation-aware spot (Ting et al. scoring, beyond-paper).

        Among used GPUs (free GPUs only as fallback, preserving the
        rule-based GPUs-used discipline), lexicographically minimize

          (waste_delta, frag_runs_after, -utilization, preference rank, gid)

        i.e. first avoid creating wastage, then keep free space contiguous,
        then pack the fullest GPU, then the paper's preferred index.
        """
        tab, p = self._profile(profile_id, kind)
        feas = self.feasible_profile(profile_id, kind, mask=mask)
        if not feas.any():
            return None
        waste, frag = self.scores_profile(profile_id, kind)
        used = self.n_placements > 0
        tiers = [feas & used[:, None]]
        if allow_new_gpu:
            tiers.append(feas & ~used[:, None])
        util = self.util()
        for tier in tiers:
            rows, cols = tier.nonzero()
            if not rows.size:
                continue
            order = np.lexsort(
                (
                    cols,
                    rows,
                    tab.pref_rank[p][cols],
                    -util[rows],
                    frag[rows, cols],
                    waste[rows, cols],
                )
            )
            r, i = int(rows[order[0]]), int(cols[order[0]])
            return self.gids[r], i
        return None


# ---------------------------------------------------------------------------
# persistent per-state mirror
# ---------------------------------------------------------------------------
def fleet_fabric(state: ClusterState, device: Device = "cuda") -> FleetFabric:
    """The cached ``FleetFabric`` mirror of ``state`` (built on first use).

    The mirror lives on the ClusterState instance and is row-synced against
    the placement lists on each call, so repeated engine deploys over a
    long-lived fleet (the online-trace hot path: one arrival per deploy) pay
    O(G) sync instead of an O(G·M) rebuild plus full kernel sweep.
    ``clone()`` does not carry the mirror; shape changes trigger a rebuild,
    and so does a ``device`` other than the cached mirror's (None: numpy).
    """
    device = _resolve(device)
    fab = state.__dict__.get("_fabric_mirror")
    if fab is not None and fab.device == device and fab.sync(state):
        return fab
    fab = FleetFabric(state, device=device)
    state.__dict__["_fabric_mirror"] = fab
    return fab


# ---------------------------------------------------------------------------
# vectorized fast-path deploys (placement-identical to the scalar policies)
# ---------------------------------------------------------------------------
def _kind_for(fab: FleetFabric, w: Workload) -> Optional[str]:
    if w.device_kind:
        return w.device_kind
    if len(fab.tables) > 1:
        raise ValueError(
            f"workload {w.wid} has no device_kind on a mixed fleet "
            f"({tuple(fab.kinds)})"
        )
    return None


def _device_of(fab: FleetFabric, w: Workload) -> DeviceModel:
    return fab._table_for(w.device_kind or None).device


def _sequential_deploy(state, workloads, pick, device, ordered=None):
    """Shared sequential loop: pick a spot per workload, mirror into fabric."""
    fab = fleet_fabric(state, device)
    if not fab.gids:  # empty fleet: scalar parity = everything pends
        for w in workloads:
            state.add_workload(w)
        return list(workloads)
    pending: List[Workload] = []
    for w in ordered(fab, workloads) if ordered else workloads:
        state.add_workload(w)
        kind = _kind_for(fab, w)
        spot = pick(fab, w, kind)
        if spot is None:
            pending.append(w)
            continue
        gid, idx = spot
        state.place(w.wid, gid, idx)
        fab.apply(gid, _device_of(fab, w).profile(w.profile_id), idx)
    return pending


def fabric_first_fit(
    state: ClusterState, workloads: Sequence[Workload], device: Device = "cuda"
) -> List[Workload]:
    """Vectorized ``baselines.first_fit`` (identical placements)."""
    return _sequential_deploy(
        state,
        sorted(workloads, key=lambda w: w.wid),
        lambda fab, w, kind: fab.pick_first_fit(w.profile_id, kind),
        device=device,
    )


def fabric_load_balanced(
    state: ClusterState, workloads: Sequence[Workload], device: Device = "cuda"
) -> List[Workload]:
    """Vectorized ``baselines.load_balanced`` (identical placements)."""
    return _sequential_deploy(
        state,
        list(workloads),  # arrival order
        lambda fab, w, kind: fab.pick_load_balanced(w.profile_id, kind),
        device=device,
    )


def _size_sorted(fab: FleetFabric, workloads: Sequence[Workload]):
    return sorted(
        workloads,
        key=lambda w: (_device_of(fab, w).profile(w.profile_id).sort_key, w.wid),
    )


def fabric_initial_deployment(
    state: ClusterState, workloads: Sequence[Workload], device: Device = "cuda"
) -> List[Workload]:
    """Vectorized ``heuristic.initial_deployment`` (identical placements)."""
    return _sequential_deploy(
        state,
        workloads,
        lambda fab, w, kind: fab.pick_max_utilization(w.profile_id, kind),
        ordered=_size_sorted,
        device=device,
    )


# ---------------------------------------------------------------------------
# the frag_aware policy verbs (beyond-paper; Ting et al. scoring)
# ---------------------------------------------------------------------------
def fabric_frag_aware_deploy(
    state: ClusterState, workloads: Sequence[Workload], device: Device = "cuda"
) -> List[Workload]:
    """Initial deployment minimizing (wastage, fragmentation) per placement."""
    return _sequential_deploy(
        state,
        workloads,
        lambda fab, w, kind: fab.pick_frag_aware(w.profile_id, kind),
        ordered=_size_sorted,
        device=device,
    )


def fabric_frag_aware_compact(state: ClusterState, device: Device = "cuda") -> None:
    """Vacate least-utilized GPUs with frag-aware one-shot respotting.

    Same outer loop as the baselines' compaction replay (Sec 5.2.2): walk
    allocated GPUs by ascending joint utilization, try to empty each into the
    other allocated GPUs; all moves must land on spans that were free before
    the vacate began (one-shot migrations, enforced by restricting candidates
    to GPUs that never gain free space during the vacate), else roll back.

    One ``FleetFabric`` mirror persists across the whole compaction: a failed
    vacate rolls the state transaction back and replays the recorded mirror
    ops in reverse, so no candidate sweep ever rebuilds the fabric.
    """
    fab = fleet_fabric(state, device)
    progress = True
    while progress:
        progress = False
        used = sorted(
            state.used_gpus(), key=lambda g: (g.joint_slice_utilization(), g.gid)
        )
        for gpu in used:
            others = {g.gid for g in state.used_gpus() if g.gid != gpu.gid}
            if not others:
                continue
            cand = np.array([g in others for g in fab.gids])
            journal: List[Tuple[bool, str, Profile, int]] = []  # (placed?, ...)
            with state.transaction() as txn:
                ok = True
                victims = sorted(
                    state.gpus[gpu.gid].placements,
                    key=lambda p: gpu.device.profile(p.profile_id).sort_key,
                )
                for pl in list(victims):
                    w = state.workloads[pl.wid]
                    state.remove(pl.wid, gpu.gid)
                    prof_v = gpu.device.profile(pl.profile_id)
                    fab.unapply(gpu.gid, prof_v, pl.index)
                    journal.append((False, gpu.gid, prof_v, pl.index))
                    spot = fab.pick_frag_aware(
                        w.profile_id, w.device_kind or None,
                        mask=cand, allow_new_gpu=False,
                    )
                    if spot is None:
                        ok = False
                        break
                    dst, idx = spot
                    state.place(w.wid, dst, idx)
                    prof_d = state.gpus[dst].device.profile(w.profile_id)
                    fab.apply(dst, prof_d, idx)
                    journal.append((True, dst, prof_d, idx))
                if not ok:
                    txn.rollback()
                    for placed, gid, prof, idx in reversed(journal):
                        (fab.unapply if placed else fab.apply)(gid, prof, idx)
            if ok:
                progress = True
                break


def replay_fresh_deploy(
    state: ClusterState, deploy_fn, keep_on_pending: bool = False
) -> List[Workload]:
    """Re-place ALL workloads from scratch via ``deploy_fn(fresh, workloads)``
    and splice the fresh layout into ``state`` (shared by the baselines'
    reconfiguration replay and the frag_aware reconfigure).

    With ``keep_on_pending`` the current layout is retained whenever the
    re-placement cannot fit every workload (the Sec-4.2 heuristic's safety
    behavior: a maintenance re-pack must never evict a placed workload);
    otherwise the fresh layout is adopted as-is and the unplaced workloads
    are returned (the baselines' measured Sec-5.2.3 behavior).
    """
    from .state import GPUState  # local import to keep module deps one-way

    workloads = state.placed_workloads()
    fresh = ClusterState(
        gpus={gid: GPUState(gid, state.gpus[gid].device) for gid in state.gpus},
        workloads={w.wid: w for w in workloads},
    )
    pending = deploy_fn(fresh, workloads)
    if pending and keep_on_pending:
        return []
    # Journaled diff-apply: preserves GPUState identity (fabric mirrors and
    # engine sub-views stay valid) and lets an engine-level transaction
    # reject the whole re-pack.
    state.adopt(fresh)
    return pending


def fabric_frag_aware_reconfigure(
    state: ClusterState, device: Device = "cuda"
) -> List[Workload]:
    """Re-place everything from scratch with frag-aware scoring; keeps the
    current layout when the re-pack cannot fit everything (no evictions)."""
    return replay_fresh_deploy(
        state,
        functools.partial(fabric_frag_aware_deploy, device=device),
        keep_on_pending=True,
    )
