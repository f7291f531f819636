"""One generator for every traffic mix: a mix is a data file of parameters.

Requests come in blocks of ``pool`` requests.  Every block holds the same
multiset of prompt lengths, output lengths and (open loop) arrival gaps:
stratified quantiles of the mix's distributions, the prompt and output
quantiles paired by a fixed permutation, each block in a fixed order of
its own.  So every seed asks for the same work at the same times; the seed
draws what the requests say (token ids; the weights and images elsewhere).
With the order drawn from the seed too, the tails of a window (some
hundred requests) moved 15-30% from seed to seed, far more than between
two runs of one seed: which long prompts land close together decides them.

``loop``: "open" sends request k at its due time (Poisson gaps at
``rate_per_s``) whatever the engine does; "closed" keeps ``clients``
requests outstanding, each client sending its next request when its last
one completes, with no think time.  ``images``: each request carries one
seeded image over its leading prompt positions (a model with a patch
frontend); false where the lengths come from a text trace.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import numpy as np

_PAIRING_SEED = 0x5EED  # fixes which prompt quantile goes with which output quantile
_ORDER_SEED = 0x0DE4  # fixes the order of each block


@dataclasses.dataclass(frozen=True)
class Spec:
    rid: int
    prompt_len: int
    new_tokens: int
    gap_s: float  # open loop: seconds after the previous request's due time


def _quantiles(dist: Dict[str, Any], n: int) -> np.ndarray:
    """n stratified quantiles (i + 0.5) / n of ``dist``, ascending."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["min"]), float(dist["max"])
    if dist["dist"] == "loguniform":
        return np.exp(np.log(lo) + (np.log(hi) - np.log(lo)) * u)
    if dist["dist"] == "uniform":
        return lo + (hi + 1 - lo) * u  # integers lo..hi, each as likely
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *stream])


class Traffic:
    """The request stream of one mix under one seed."""

    def __init__(self, mix: Dict[str, Any], seed: int, vocab_size: int):
        self.mix = mix
        self.seed = seed
        self.vocab_size = vocab_size
        self.pool = int(mix["pool"])
        pair = np.random.default_rng(_PAIRING_SEED).permutation(self.pool)
        self._prompt = np.floor(_quantiles(mix["prompt"], self.pool)).astype(np.int64)
        self._new = np.floor(_quantiles(mix["new_tokens"], self.pool)).astype(np.int64)[pair]
        if mix["loop"] == "open":
            u = (np.arange(self.pool) + 0.5) / self.pool
            self._gap = -np.log1p(-u) / float(mix["rate_per_s"])
        else:
            self._gap = np.zeros(self.pool)
        self._blocks: Dict[int, np.ndarray] = {}

    def _order(self, block: int) -> np.ndarray:
        if block not in self._blocks:
            self._blocks[block] = _rng(_ORDER_SEED, block).permutation(self.pool)
        return self._blocks[block]

    def spec(self, k: int) -> Spec:
        i = int(self._order(k // self.pool)[k % self.pool])
        return Spec(k, int(self._prompt[i]), int(self._new[i]), float(self._gap[i]))

    def prompt(self, k: int) -> List[int]:
        """Request k's prompt token ids, uniform over the vocabulary less id 0."""
        n = self.spec(k).prompt_len
        return _rng(self.seed, 2, k).integers(1, self.vocab_size, size=n).tolist()

    def due_offsets(self, n: int) -> np.ndarray:
        """Open loop: the due times of requests 0..n-1, seconds after the start."""
        return np.cumsum([self.spec(k).gap_s for k in range(n)])

    def image_slot(self, k: int) -> int:
        """Which of the ``pool`` seeded images request k carries."""
        return k % self.pool


def requests_needed(mix: Dict[str, Any], seconds: float) -> int:
    """Open loop: how many requests fall due in ``seconds`` (with margin)."""
    return int(math.ceil(float(mix["rate_per_s"]) * seconds * 1.5)) + int(mix["pool"])
