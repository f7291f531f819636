"""Pure-Python MILP fallback: dense two-phase simplex + branch & bound.

Used only when scipy/HiGHS is unavailable.  Correct but intended for small
instances (single-node clusters); tests cross-check it against HiGHS on tiny
WPM models.  Maximization, row form lb <= a.x <= ub, variable bounds, binary
integrality.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["solve_milp"]

_EPS = 1e-9


def _solve_lp(
    c: np.ndarray,
    A: np.ndarray,
    b: np.ndarray,
    senses: Sequence[str],
    lo: np.ndarray,
    hi: np.ndarray,
) -> Optional[Tuple[np.ndarray, float]]:
    """max c.x st A x (<=,=) b, lo<=x<=hi.  Returns (x, obj) or None.

    Standardization: shift x by lo, add upper-bound rows, slacks, then
    two-phase tableau simplex (dense; fine for the small fallback sizes).
    """
    n = len(c)
    shift = lo.copy()
    b = b - A @ shift
    ub_rows = []
    ub_rhs = []
    for j in range(n):
        if np.isfinite(hi[j]):
            row = np.zeros(n)
            row[j] = 1.0
            ub_rows.append(row)
            ub_rhs.append(hi[j] - lo[j])
    A2 = np.vstack([A] + ([np.array(ub_rows)] if ub_rows else []))
    b2 = np.concatenate([b, np.array(ub_rhs)] if ub_rows else [b])
    senses2 = list(senses) + ["<="] * len(ub_rhs)

    m = len(b2)
    # slacks for <= rows; flip rows with negative rhs later via phase 1
    n_slack = sum(1 for s in senses2 if s == "<=")
    T = np.zeros((m, n + n_slack))
    T[:, :n] = A2
    si = n
    slack_of = {}
    for i, s in enumerate(senses2):
        if s == "<=":
            T[i, si] = 1.0
            slack_of[i] = si
            si += 1
    rhs = b2.copy()
    for i in range(m):
        if rhs[i] < 0:
            T[i] *= -1
            rhs[i] *= -1
            if i in slack_of:
                pass  # slack coefficient is now -1; needs artificial anyway

    # artificials for = rows and flipped <= rows (slack coef -1)
    total = T.shape[1]
    art_cols = []
    basis = [-1] * m
    for i in range(m):
        if i in slack_of and T[i, slack_of[i]] > 0:
            basis[i] = slack_of[i]
        else:
            art_cols.append(i)
    Tfull = np.hstack([T, np.zeros((m, len(art_cols)))])
    for k, i in enumerate(art_cols):
        Tfull[i, total + k] = 1.0
        basis[i] = total + k

    def pivot(Tab, rhs_, basis_, obj_row, obj_val):
        it = 0
        while it < 20000:
            it += 1
            j = int(np.argmin(obj_row))
            if obj_row[j] > -1e-10:
                return obj_val
            col = Tab[:, j]
            mask = col > _EPS
            if not mask.any():
                return None  # unbounded
            ratios = np.where(mask, rhs_ / np.where(mask, col, 1), np.inf)
            i = int(np.argmin(ratios))
            piv = Tab[i, j]
            Tab[i] /= piv
            rhs_[i] /= piv
            for r in range(len(Tab)):
                if r != i and abs(Tab[r, j]) > _EPS:
                    f = Tab[r, j]
                    Tab[r] -= f * Tab[i]
                    rhs_[r] -= f * rhs_[i]
            f = obj_row[j]
            obj_row -= f * Tab[i]
            obj_val -= f * rhs_[i]
            basis_[i] = j
        return obj_val

    # phase 1
    ncols = Tfull.shape[1]
    obj1 = np.zeros(ncols)
    obj1[total:] = 1.0
    val1 = 0.0
    for i in range(m):
        if basis[i] >= total:
            obj1 -= Tfull[i]
            val1 -= rhs[i]
    r = pivot(Tfull, rhs, basis, obj1, val1)
    if r is None or -r > 1e-7:
        return None  # infeasible
    # phase 2
    obj2 = np.zeros(ncols)
    obj2[:n] = -c  # maximize c.x == minimize -c.x
    val2 = 0.0
    for i in range(m):
        if obj2[basis[i]] != 0:
            f = obj2[basis[i]]
            obj2 -= f * Tfull[i]
            val2 -= f * rhs[i]
    obj2[total:] = 1e6  # forbid artificials re-entering
    r2 = pivot(Tfull, rhs, basis, obj2, val2)
    if r2 is None:
        return None
    x = np.zeros(ncols)
    for i, bcol in enumerate(basis):
        x[bcol] = rhs[i]
    sol = x[:n] + shift
    return sol, float(c @ sol)


def solve_milp(
    c: np.ndarray,
    rows: List[Tuple[Dict[int, float], float, float]],
    lb: np.ndarray,
    ub: np.ndarray,
    is_int: np.ndarray,
    maximize: bool = True,
    time_limit: float = 60.0,
    max_nodes: int = 20000,
) -> Tuple[np.ndarray, str]:
    """Branch & bound over binaries with LP-relaxation bounds."""
    assert maximize
    n = len(c)
    A_list, b_list, senses = [], [], []
    for coeffs, lo_r, hi_r in rows:
        row = np.zeros(n)
        for j, a in coeffs.items():
            row[j] = a
        if lo_r == hi_r:
            A_list.append(row)
            b_list.append(hi_r)
            senses.append("=")
        else:
            if np.isfinite(hi_r):
                A_list.append(row)
                b_list.append(hi_r)
                senses.append("<=")
            if np.isfinite(lo_r):
                A_list.append(-row)
                b_list.append(-lo_r)
                senses.append("<=")
    A = np.array(A_list) if A_list else np.zeros((0, n))
    b = np.array(b_list) if b_list else np.zeros(0)

    t0 = time.time()
    best_x: Optional[np.ndarray] = None
    best_obj = -np.inf
    # stack of (extra lo, extra hi)
    stack = [(lb.astype(float).copy(), ub.astype(float).copy())]
    nodes = 0
    while stack and nodes < max_nodes and time.time() - t0 < time_limit:
        lo, hi = stack.pop()
        nodes += 1
        res = _solve_lp(c, A, b, senses, lo, hi)
        if res is None:
            continue
        x, obj = res
        if obj <= best_obj + 1e-9:
            continue  # bound
        frac = [
            j
            for j in range(n)
            if is_int[j] and abs(x[j] - round(x[j])) > 1e-6
        ]
        if not frac:
            xi = x.copy()
            xi[is_int.astype(bool)] = np.round(xi[is_int.astype(bool)])
            best_x, best_obj = xi, obj
            continue
        j = max(frac, key=lambda j: abs(x[j] - round(x[j])))
        lo1, hi1 = lo.copy(), hi.copy()
        hi1[j] = np.floor(x[j])
        lo2, hi2 = lo.copy(), hi.copy()
        lo2[j] = np.ceil(x[j])
        # explore the rounding-up branch first (placements are rewarded)
        stack.append((lo1, hi1))
        stack.append((lo2, hi2))
    if best_x is None:
        raise RuntimeError("bb_solver: no feasible solution found")
    status = "optimal" if not stack else "time_limit"
    return best_x, status
