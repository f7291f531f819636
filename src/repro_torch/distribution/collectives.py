"""Analytic collective sizing: expected wire bytes per collective on the
production meshes.  A copy of ``repro/distribution/collectives.py``, which
has no JAX in it (``tests/test_torch_sharding.py`` holds the two equal).

The reference cross-checks its HLO-derived collective term against it;
the port has no HLO, and uses it as napkin math: the bytes a sharding
change should move, predicted before a run.

Conventions: ``nbytes`` is the LOGICAL (unsharded) tensor size; ``n`` is the
participant count along the collective's mesh axis.  Returned numbers are
bytes ENTERING the wire per device (ring algorithms), matching the roofline
term's ``collective_bytes / link_bw`` definition.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["ring_all_reduce", "all_gather", "reduce_scatter", "all_to_all",
           "CollectiveModel"]


def ring_all_reduce(nbytes: float, n: int) -> float:
    """Ring AR = reduce-scatter + all-gather: 2 * (n-1)/n * N per device."""
    return 2.0 * (n - 1) / n * nbytes if n > 1 else 0.0


def all_gather(nbytes: float, n: int) -> float:
    """Each device receives the other shards: (n-1)/n * N."""
    return (n - 1) / n * nbytes if n > 1 else 0.0


def reduce_scatter(nbytes: float, n: int) -> float:
    return (n - 1) / n * nbytes if n > 1 else 0.0


def all_to_all(nbytes: float, n: int) -> float:
    """Each device keeps 1/n locally, sends the rest: (n-1)/n * N_local."""
    return (n - 1) / n * nbytes / n if n > 1 else 0.0


@dataclasses.dataclass(frozen=True)
class CollectiveModel:
    """Per-step analytic collective volume for a TP(+FSDP) transformer."""

    n_layers: int
    d_model: int
    d_ff: int
    params_bytes: float
    tp: int
    dp: int
    act_bytes_per_layer: float  # (tokens_local * d_model * dtype) unsharded

    def tp_all_reduce_bytes(self) -> float:
        """2 row-parallel matmul partial-sums per layer (attn out + MLP out)."""
        per = ring_all_reduce(self.act_bytes_per_layer, self.tp)
        return 2.0 * self.n_layers * per

    def fsdp_gather_bytes(self) -> float:
        """Weight all-gather over dp, once per use (fwd; x2 more for bwd)."""
        return all_gather(self.params_bytes / max(self.tp, 1), self.dp)

    def grad_reduce_bytes(self) -> float:
        """Gradient reduce-scatter over dp (ZeRO) per step."""
        return reduce_scatter(self.params_bytes / max(self.tp, 1), self.dp)

    def summary(self) -> Dict[str, float]:
        return {
            "tp_all_reduce": self.tp_all_reduce_bytes(),
            "fsdp_gather": self.fsdp_gather_bytes(),
            "grad_reduce": self.grad_reduce_bytes(),
        }
