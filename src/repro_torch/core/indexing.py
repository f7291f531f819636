"""Index assignment: bin-level solutions -> concrete slice indexes.

Assumption 1 (paper Sec 4) lets the MIP reason at bin-packing level; this
module is the "indexing step" that follows.  Given a multiset of profiles to
realise on a GPU (possibly with immovable pre-existing placements), find a
feasible assignment of start indexes honoring Table-1 allowed indexes, the
preference order, and non-overlap.

The search is exact (backtracking) but tiny: <= 7 placements per GPU and
<= 7 candidate indexes per placement.  Profiles are placed big-first and
preference-first, which empirically lands on the paper's "preferred" layouts
(e.g. 3g.40gb at index 4, 1g.20gb at index 6) and minimizes wastage; among
feasible completions we keep the one with minimal (compute waste, memory
waste, fragmentation).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .profiles import DeviceModel, Profile
from .state import GPUState, Placement

__all__ = [
    "assign_indexes",
    "best_index_for",
    "feasible_multiset",
    "enumerate_feasible_multisets",
]


def _waste_key(gpu: GPUState) -> Tuple[int, int, int]:
    """Lexicographic quality of a concrete layout (lower is better)."""
    # Fragmentation: number of maximal free runs (fewer, longer runs are
    # better for future availability — paper objective 3).
    free = gpu.free_gpu_slices()
    runs = 0
    prev = None
    for i in free:
        if prev is None or i != prev + 1:
            runs += 1
        prev = i
    return (gpu.compute_waste(), gpu.memory_waste(), runs)


def assign_indexes(
    gpu: GPUState,
    profile_ids: Sequence[int],
    wids: Optional[Sequence[str]] = None,
    optimize: bool = True,
) -> Optional[List[Placement]]:
    """Place ``profile_ids`` (a multiset) onto ``gpu`` atop existing placements.

    Returns the new placements (in input order) or None if infeasible.
    ``gpu`` is not mutated.  With ``optimize=True`` the minimal-waste feasible
    layout is returned; otherwise the first found (preference order).
    """
    device = gpu.device
    if wids is None:
        wids = [f"_w{i}" for i in range(len(profile_ids))]
    order = sorted(
        range(len(profile_ids)),
        key=lambda i: device.profile(profile_ids[i]).sort_key,
    )  # big -> small

    best: Optional[Tuple[Tuple[int, int, int], List[Placement]]] = None
    scratch = gpu.clone()
    chosen: Dict[int, Placement] = {}

    def bt(pos: int) -> bool:
        nonlocal best
        if pos == len(order):
            key = _waste_key(scratch)
            if best is None or key < best[0]:
                best = (key, [chosen[i] for i in range(len(profile_ids))])
            return not optimize  # stop at first solution unless optimizing
        i = order[pos]
        prof = device.profile(profile_ids[i])
        for idx in prof.allowed_indexes:
            if scratch.can_place_at(prof, idx):
                pl = scratch.place(wids[i], prof.profile_id, idx)
                chosen[i] = pl
                if bt(pos + 1):
                    return True
                scratch.placements.remove(pl)
                del chosen[i]
        return False

    bt(0)
    return None if best is None else best[1]


def best_index_for(gpu: GPUState, profile: Profile) -> Optional[int]:
    """Preference-order first feasible index for one profile (Table 1)."""
    return gpu.first_feasible_index(profile)


def feasible_multiset(device: DeviceModel, counts: Dict[int, int]) -> bool:
    """Can this multiset of profiles be realised at concrete indexes?"""
    gpu = GPUState("_probe", device)
    flat: List[int] = []
    for pid, n in counts.items():
        flat.extend([pid] * n)
    return assign_indexes(gpu, flat, optimize=False) is not None


def enumerate_feasible_multisets(
    device: DeviceModel,
) -> List[Dict[int, int]]:
    """All index-feasible profile multisets for an empty device.

    Used by the pattern-enumeration solver (beyond-paper) and by the
    Assumption-1 validation test.  The count is small (a few dozen for A100).
    """
    profs = device.profiles_sorted_desc()
    out: List[Dict[int, int]] = []

    def rec(i: int, counts: Dict[int, int]) -> None:
        if i == len(profs):
            if counts and feasible_multiset(device, counts):
                out.append(dict(counts))
            return
        p = profs[i]
        max_n = min(
            device.n_gpu_slices // max(p.compute_slices, 1),
            device.n_memory_slices // max(p.memory_slices, 1),
        )
        if p.media_extensions:
            max_n = min(max_n, device.max_media_extensions)
        for n in range(max_n + 1):
            if n:
                counts[p.profile_id] = n
            elif p.profile_id in counts:
                del counts[p.profile_id]
            trial = {**counts}
            if device.fits(trial):
                rec(i + 1, counts)
            if n and p.profile_id in counts:
                del counts[p.profile_id]
        return

    rec(0, {})
    # dedupe (profile ids may repeat names but ids are unique)
    seen = set()
    uniq = []
    for c in out:
        key = tuple(sorted(c.items()))
        if key not in seen:
            seen.add(key)
            uniq.append(c)
    return uniq
