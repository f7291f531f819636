"""WPM: Workload Placement and Migration MIP (paper Sec 4.1, Eqns 2a-2k).

A profit-maximization MILP that jointly handles initial placement of new
workloads, migration/compaction of existing workloads, and GPU
reconfiguration (via imaginary GPUs).  The paper solved it with CPLEX; here
it is solved with HiGHS through ``scipy.optimize.milp`` when available, or
with the pure-Python branch-and-bound in ``bb_solver`` otherwise.  The
formulation is identical either way.

Variables (see Table 2):
  x[w,b]   in {0,1}  workload w placed on bin b (free GPU, imaginary GPU, or
                     free partition from Algorithm 1)
  stay[w]  in {0,1}  existing workload w keeps its current placement
  y[g]     in {0,1}  GPU g used (free, imaginary, or pre-existing)
  z[p]     in {0,1}  free partition p hosts at least one workload
  delta[b] in {0,1}  bin b's compute is NOT full (u_b >= 1)
  u,v,U,V  >= 0      compute/memory slack and wastage (slice units)

The MIP is bin-level (Assumption 1); ``extract_solution`` performs the
indexing step and repairs the (rare) index-infeasible merged-bin contents.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .indexing import assign_indexes
from .preprocess import FreePartition, determine_free_partitions, merge_partitions
from .state import ClusterState, GPUState, Workload

__all__ = ["ObjectiveWeights", "WPMResult", "solve_wpm"]


@dataclasses.dataclass(frozen=True)
class ObjectiveWeights:
    """Penalty ordering per Sec 4.1: placement >> GPU >> repartition ~ waste >> migration."""

    placement_reward: float = 1000.0  # p_w
    gpu_cost: float = 100.0  # q_g
    repartition_cost: float = 2.0  # gamma^R_g
    migration_cost: float = 1.0  # gamma^M_w
    wastage_cost: float = 10.0  # gamma^W_g


@dataclasses.dataclass
class WPMResult:
    state: ClusterState
    pending: List[Workload]
    objective: float
    status: str
    solve_seconds: float
    mip_gap: Optional[float] = None
    n_variables: int = 0
    n_constraints: int = 0
    repaired: int = 0  # index-repair interventions after the bin-level solve


class _Model:
    """Tiny MILP assembler: max c'x s.t. lb <= Ax <= ub, bounds, binaries."""

    def __init__(self) -> None:
        self.obj: List[float] = []
        self.lb: List[float] = []
        self.ub: List[float] = []
        self.is_int: List[bool] = []
        self.names: List[str] = []
        self.rows: List[Tuple[Dict[int, float], float, float]] = []

    def var(self, name: str, lo: float, hi: float, integer: bool, obj: float = 0.0) -> int:
        self.names.append(name)
        self.lb.append(lo)
        self.ub.append(hi)
        self.is_int.append(integer)
        self.obj.append(obj)
        return len(self.names) - 1

    def binary(self, name: str, obj: float = 0.0) -> int:
        return self.var(name, 0.0, 1.0, True, obj)

    def add(self, coeffs: Dict[int, float], lo: float, hi: float) -> None:
        self.rows.append((coeffs, lo, hi))

    def solve(self, time_limit: float, mip_gap: float) -> Tuple[np.ndarray, str, Optional[float]]:
        try:
            return self._solve_scipy(time_limit, mip_gap)
        except ImportError:
            from .bb_solver import solve_milp  # pure-Python fallback

            x, status = solve_milp(
                c=np.asarray(self.obj),
                rows=self.rows,
                lb=np.asarray(self.lb),
                ub=np.asarray(self.ub),
                is_int=np.asarray(self.is_int),
                maximize=True,
                time_limit=time_limit,
            )
            return x, status, None

    def _solve_scipy(self, time_limit: float, mip_gap: float):
        from scipy.optimize import Bounds, LinearConstraint, milp
        from scipy.sparse import csr_matrix

        n = len(self.obj)
        data, ri, ci, lo, hi = [], [], [], [], []
        for r, (coeffs, l, h) in enumerate(self.rows):
            for j, a in coeffs.items():
                ri.append(r)
                ci.append(j)
                data.append(a)
            lo.append(l)
            hi.append(h)
        A = csr_matrix((data, (ri, ci)), shape=(len(self.rows), n))
        res = milp(
            c=-np.asarray(self.obj),  # scipy minimizes
            constraints=LinearConstraint(A, lo, hi),
            integrality=np.asarray(self.is_int, dtype=np.int64),
            bounds=Bounds(np.asarray(self.lb), np.asarray(self.ub)),
            options={"time_limit": time_limit, "mip_rel_gap": mip_gap},
        )
        if res.x is None:
            raise RuntimeError(f"WPM infeasible or unsolved: {res.message}")
        gap = getattr(res, "mip_gap", None)
        return np.asarray(res.x), ("optimal" if res.status == 0 else "time_limit"), gap


def solve_wpm(
    initial: ClusterState,
    new_workloads: Sequence[Workload] = (),
    *,
    movable: bool = True,
    allow_reconfig: bool = True,
    weights: ObjectiveWeights = ObjectiveWeights(),
    time_limit: float = 30.0,
    mip_gap: float = 1e-4,
    merge_free_partitions: bool = True,
) -> WPMResult:
    """Solve WPM for the given initial state.

    movable=False, allow_reconfig=False  -> pure initial deployment (paper "MIP")
    movable=True,  allow_reconfig=True   -> paper "joint-MIP" / compaction / reconfiguration
    """
    t0 = time.time()
    device = next(iter(initial.gpus.values())).device
    W = weights

    used_gpus = sorted(initial.used_gpus(), key=lambda g: g.gid)
    free_gpus = sorted(initial.free_gpus(), key=lambda g: g.gid)
    existing: List[Tuple[Workload, str]] = []  # (workload, current gid)
    for g in used_gpus:
        for pl in g.placements:
            existing.append((initial.workloads[pl.wid], g.gid))

    # ---- bins -------------------------------------------------------------
    # Whole-GPU bins: free GPUs and (if reconfiguring) imaginary counterparts.
    whole_bins: List[Tuple[str, GPUState, Optional[str]]] = []  # (bin id, gpu, imag-of)
    for g in free_gpus:
        whole_bins.append((g.gid, g, None))
    if allow_reconfig and movable:
        for g in used_gpus:
            whole_bins.append((f"{g.gid}~imag", g, g.gid))

    # Partition bins (Algorithm 1) on partially-used GPUs.
    parts: List[FreePartition] = []
    for g in used_gpus:
        pg = determine_free_partitions(g)
        parts.extend(merge_partitions(pg, device) if merge_free_partitions else pg)

    m = _Model()

    # ---- variables ----------------------------------------------------------
    y: Dict[str, int] = {}
    for gid, _, imag_of in whole_bins:
        cost = W.gpu_cost + (W.repartition_cost if imag_of else 0.0)
        y[gid] = m.binary(f"y[{gid}]", obj=-cost)
    for g in used_gpus:
        y[g.gid] = m.binary(f"y[{g.gid}]", obj=-W.gpu_cost)

    z: Dict[str, int] = {p.pid: m.binary(f"z[{p.pid}]") for p in parts}

    movers: List[Tuple[Workload, str]] = existing if movable else []
    fixed: List[Tuple[Workload, str]] = [] if movable else existing
    news = list(new_workloads)

    x: Dict[Tuple[str, str], int] = {}  # (wid, bin id) -> var
    stay: Dict[str, int] = {}
    all_wl: List[Tuple[Workload, Optional[str]]] = [(w, gid) for w, gid in movers]
    all_wl += [(w, None) for w in news]

    bin_caps: Dict[str, Tuple[int, int, int]] = {}  # bin -> (C, Mslices, me)
    for gid, g, _ in whole_bins:
        bin_caps[gid] = (
            device.n_gpu_slices,
            device.n_memory_slices,
            device.max_media_extensions,
        )
    for p in parts:
        me = device.max_media_extensions if True else 0
        bin_caps[p.pid] = (p.compute_capacity, p.memory_capacity, me)

    part_by_id = {p.pid: p for p in parts}
    x_by_wid: Dict[str, List[int]] = {}
    x_by_bin: Dict[str, List[Tuple[str, int]]] = {}

    def _mk_x(wid: str, bid: str, reward: float) -> None:
        xi = m.binary(f"x[{wid},{bid}]", obj=reward)
        x[(wid, bid)] = xi
        x_by_wid.setdefault(wid, []).append(xi)
        x_by_bin.setdefault(bid, []).append((wid, xi))

    for w, cur in all_wl:
        prof = device.profile(w.profile_id)
        for gid, _, _ in whole_bins:
            _mk_x(w.wid, gid, W.placement_reward)
        for p in parts:
            if p.gid != cur and p.admits(prof, device):
                # A mover may not re-enter a free partition of its own GPU
                # (its own vacated span is not re-offered; conservative and
                # consistent with Assumption 2's zero-cost within-GPU moves
                # being handled via the imaginary-GPU route instead).
                _mk_x(w.wid, p.pid, W.placement_reward)
        if cur is not None:
            stay[w.wid] = m.binary(f"stay[{w.wid}]", obj=W.placement_reward)

    # Migration penalty: existing workload migrates unless it stays or lands
    # on its own imaginary GPU.  gamma^M*(1 - stay - x[w, imag(cur)]).
    for w, cur in movers:
        gm = W.migration_cost * w.migration_cost
        m.obj[stay[w.wid]] += gm
        imag_id = f"{cur}~imag"
        if (w.wid, imag_id) in x:
            m.obj[x[(w.wid, imag_id)]] += gm
        # constant term -gm omitted (doesn't affect argmax; reported obj adjusts)
    const_obj = -sum(W.migration_cost * w.migration_cost for w, _ in movers)

    u: Dict[str, int] = {}
    v: Dict[str, int] = {}
    Uv: Dict[str, int] = {}
    Vv: Dict[str, int] = {}
    dlt: Dict[str, int] = {}
    for bid, (C, M, _) in bin_caps.items():
        u[bid] = m.var(f"u[{bid}]", 0, C, False)
        v[bid] = m.var(f"v[{bid}]", 0, M, False)
        Uv[bid] = m.var(f"U[{bid}]", 0, C, False, obj=-W.wastage_cost)
        Vv[bid] = m.var(f"V[{bid}]", 0, M, False, obj=-W.wastage_cost)
        dlt[bid] = m.binary(f"delta[{bid}]")

    # ---- constraints --------------------------------------------------------
    INF = float("inf")
    wl_by_id = {w.wid: w for w, _ in all_wl}

    # (2b)/(2c): count caps tie x to y (whole bins) / z (partitions).
    for bid, (C, M, _) in bin_caps.items():
        gate = y[bid] if bid in y else z[bid]
        row = {xi: 1.0 for _, xi in x_by_bin.get(bid, [])}
        if row:
            row[gate] = -float(C)
            m.add(row, -INF, 0.0)

    # (2d): partitions on g' imply y[g'], capped by compute slices.
    for g in used_gpus:
        row = {z[p.pid]: 1.0 for p in parts if p.gid == g.gid}
        if row:
            row[y[g.gid]] = -float(device.n_gpu_slices)
            m.add(row, -INF, 0.0)

    # Existing workloads on kept GPUs: stay => y[g']; stay + y[imag] <= 1.
    for w, cur in movers:
        m.add({stay[w.wid]: 1.0, y[cur]: -1.0}, -INF, 0.0)
        imag_id = f"{cur}~imag"
        if imag_id in y:
            m.add({stay[w.wid]: 1.0, y[imag_id]: 1.0}, -INF, 1.0)
    if not movable:
        # Fixed workloads pin their GPUs as used.
        for g in used_gpus:
            m.add({y[g.gid]: 1.0}, 1.0, 1.0)

    # (2e): each workload placed exactly once (existing) / at most once (new).
    for w, cur in all_wl:
        row = {xi: 1.0 for xi in x_by_wid.get(w.wid, [])}
        if cur is not None:
            row[stay[w.wid]] = 1.0
            m.add(row, 1.0, 1.0)
        else:
            m.add(row, 0.0, 1.0)

    # (2h): original xor imaginary.
    if allow_reconfig and movable:
        for g in used_gpus:
            imag_id = f"{g.gid}~imag"
            if imag_id in y:
                m.add({y[g.gid]: 1.0, y[imag_id]: 1.0}, -INF, 1.0)

    # (2f)/(2g): compute & memory bin packing with explicit slack; plus me cap.
    for bid, (C, M, ME) in bin_caps.items():
        crow: Dict[int, float] = {u[bid]: 1.0}
        mrow: Dict[int, float] = {v[bid]: 1.0}
        merow: Dict[int, float] = {}
        for wid, xi in x_by_bin.get(bid, []):
            prof = device.profile(wl_by_id[wid].profile_id)
            crow[xi] = float(prof.compute_slices)
            mrow[xi] = float(prof.memory_slices)
            if prof.media_extensions:
                merow[xi] = float(prof.media_extensions)
        m.add(crow, float(C), float(C))
        m.add(mrow, float(M), float(M))
        if merow:
            m.add(merow, -INF, float(ME))

    # (2i)-(2k): wastage linearization.
    for bid, (C, M, _) in bin_caps.items():
        m.add({u[bid]: 1.0, v[bid]: -1.0, Uv[bid]: -1.0}, -INF, 0.0)  # (2i)
        m.add({dlt[bid]: 1.0, u[bid]: -1.0}, -INF, 0.0)  # delta <= u
        m.add({u[bid]: 1.0, dlt[bid]: -float(C)}, -INF, 0.0)  # u <= C delta
        m.add({v[bid]: 1.0, dlt[bid]: -float(M), Vv[bid]: -1.0}, -INF, 0.0)  # (2k)

    # ---- solve ------------------------------------------------------------
    xsol, status, gap = m.solve(time_limit, mip_gap)
    xb = xsol > 0.5

    # ---- extract + indexing step -------------------------------------------
    final = ClusterState(
        gpus={gid: GPUState(gid, initial.gpus[gid].device) for gid in initial.gpus},
        workloads=dict(initial.workloads),
    )
    for w in news:
        final.workloads[w.wid] = w
    repaired = 0
    pending: List[Workload] = []

    # Fixed (immovable) workloads keep their placements verbatim.
    for w, cur in fixed:
        pl = initial.placement_of(w.wid)[1]
        final.gpus[cur].placements.append(pl)
    # Stays keep their placements verbatim.
    for w, cur in movers:
        if xb[stay[w.wid]]:
            pl = initial.placement_of(w.wid)[1]
            final.gpus[cur].placements.append(pl)

    # Whole-GPU bins: collect contents, index-assign from scratch.
    leftovers: List[Workload] = []
    for gid, g, imag_of in whole_bins:
        wids = [wid for wid, xi in x_by_bin.get(gid, []) if xb[xi]]
        if not wids:
            continue
        target = imag_of if imag_of else gid
        host = final.gpus[target]
        profs = [final.workloads[wid].profile_id for wid in wids]
        placements = assign_indexes(host, profs, wids)
        if placements is None:
            repaired += len(wids)
            leftovers.extend(final.workloads[wid] for wid in wids)
        else:
            host.placements.extend(placements)

    # Partition bins: index-assign within the owning GPU (stays already placed).
    by_gpu: Dict[str, List[str]] = {}
    for (wid, b), xi in x.items():
        if b in part_by_id and xb[xi]:
            by_gpu.setdefault(part_by_id[b].gid, []).append(wid)
    for gid, wids in by_gpu.items():
        host = final.gpus[gid]
        profs = [final.workloads[wid].profile_id for wid in wids]
        placements = assign_indexes(host, profs, wids)
        if placements is None:
            repaired += len(wids)
            leftovers.extend(final.workloads[wid] for wid in wids)
        else:
            host.placements.extend(placements)

    # Repair: greedily place leftovers (merged-bin index artifacts).
    from .baselines import place_max_utilization

    for w in leftovers:
        spot = place_max_utilization(final, w)
        if spot is None:
            pending.append(w)
        else:
            final.place(w.wid, *spot)
    for w in news:
        if final.placement_of(w.wid) is None and w not in pending:
            pending.append(w)
    final.validate()

    nvars = len(m.obj)
    ncons = len(m.rows)
    obj = float(np.dot(m.obj, xsol)) + const_obj
    return WPMResult(
        state=final,
        pending=pending,
        objective=obj,
        status=status,
        solve_seconds=time.time() - t0,
        mip_gap=gap,
        n_variables=nvars,
        n_constraints=ncons,
        repaired=repaired,
    )
