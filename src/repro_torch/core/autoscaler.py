"""SLO-aware replica autoscaler: offered load -> per-model replica targets.

The controller closes the demand loop: traffic generators
(``core/traffic.py``) produce request streams, the perf model
(``core/perfmodel.py``) prices one replica's capacity, and this module
decides how many replicas each model should run *right now*.  The wiring
layers (``core/events.py`` for simulation, ``serving/cluster.py`` for live
engines) then issue the deploy/retire/resize requests through the
``PlacementEngine`` — migrations stay priced and gated by the engine's
``CommitPolicy``; the autoscaler only sets targets.

Two controller modes (both queueing-based on ``offered / capacity``):

  * ``target-utilization`` — classic M/M/c sizing: enough replicas that
    steady-state utilization sits at ``target_utilization``, plus a queue
    drain term so a backlog is worked off within ``drain_window_seconds``.
  * ``slo`` — starts from the same sizing but *reacts to measured SLO
    attainment*: below-target attainment forces a multiplicative scale-up
    even when utilization looks fine (tail latency sees what averages
    hide); scale-down additionally requires attainment comfortably above
    target.

Stability machinery (no flapping under steady load):

  * scale-up after ``up_cooldown`` since the last scale-up (fast);
  * scale-down only when the desired count undershoots the current one by
    the ``hysteresis`` fraction AND has done so continuously for
    ``down_cooldown`` (slow, deliberate — MISO's "grow eagerly, shrink
    lazily" asymmetry).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

__all__ = [
    "SLO",
    "AutoscalerConfig",
    "ModelLoad",
    "ScaleDecision",
    "Autoscaler",
]


@dataclasses.dataclass(frozen=True)
class SLO:
    """Latency targets one request must meet to count as attained."""

    ttft_seconds: float = 2.0  # time to first token (queue wait + prefill)
    tpot_seconds: float = 0.1  # time per output token (decode pace)
    attainment_target: float = 0.95  # fraction of requests meeting both


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    mode: str = "target-utilization"  # or "slo"
    target_utilization: float = 0.70
    #: scale down only when desired <= current * (1 - hysteresis).
    hysteresis: float = 0.2
    up_cooldown: float = 5.0
    down_cooldown: float = 45.0
    #: a backlog should be drained within this window (sizes the queue term).
    drain_window_seconds: float = 30.0
    min_replicas: int = 0
    max_replicas: int = 256
    #: multiplicative step when the SLO is being missed (slo mode).
    slo_scaleup_factor: float = 1.25

    def __post_init__(self) -> None:
        mode = self.mode.replace("_", "-")
        if mode not in ("target-utilization", "slo"):
            raise ValueError(f"unknown autoscaler mode {self.mode!r}")
        object.__setattr__(self, "mode", mode)
        if not 0.0 < self.target_utilization <= 1.0:
            raise ValueError("target_utilization must be in (0, 1]")


@dataclasses.dataclass(frozen=True)
class ModelLoad:
    """One model's observed state at a control tick."""

    model: str
    offered_rps: float  # arrival rate over the last window
    capacity_rps: float  # ONE replica's sustainable rate (perf model)
    replicas: int  # currently live (placed, non-draining)
    queue_depth: int = 0  # requests waiting fleet-wide
    slo_attainment: float = 1.0  # fraction attained over the last window
    slo: SLO = SLO()


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    model: str
    current: int
    target: int
    reason: str

    @property
    def delta(self) -> int:
        return self.target - self.current


class Autoscaler:
    """Stateful replica controller (cooldown/hysteresis memory per model)."""

    def __init__(self, config: AutoscalerConfig = AutoscalerConfig()):
        self.config = config
        self._last_up: Dict[str, float] = {}
        self._last_down: Dict[str, float] = {}
        #: when the desired count first undershot the hysteresis band.
        self._low_since: Dict[str, float] = {}

    # -- sizing -------------------------------------------------------------
    def desired_replicas(self, obs: ModelLoad) -> int:
        """Raw queueing-based target, before hysteresis/cooldown gating."""
        cfg = self.config
        cap = max(obs.capacity_rps, 1e-9)
        # Steady-state term: run each replica at target utilization.
        need = obs.offered_rps / (cfg.target_utilization * cap)
        # Backlog term: extra capacity to drain the queue within the window.
        need += obs.queue_depth / (cap * cfg.drain_window_seconds)
        n = math.ceil(need - 1e-9)
        if cfg.mode == "slo" and obs.slo_attainment < obs.slo.attainment_target:
            # Tail latency is missing target: multiplicative bump over the
            # *current* fleet regardless of what averages claim suffices.
            n = max(n, math.ceil(obs.replicas * cfg.slo_scaleup_factor), obs.replicas + 1)
        return max(cfg.min_replicas, min(cfg.max_replicas, n))

    # -- control tick -------------------------------------------------------
    def tick(self, now: float, observations: Sequence[ModelLoad]) -> List[ScaleDecision]:
        """Gated decisions for one control tick; targets == current when the
        controller holds (cooldown / hysteresis)."""
        cfg = self.config
        out: List[ScaleDecision] = []
        for obs in observations:
            m = obs.model
            desired = self.desired_replicas(obs)
            target = obs.replicas
            reason = "hold"
            if desired > obs.replicas:
                self._low_since.pop(m, None)
                if now - self._last_up.get(m, -math.inf) >= cfg.up_cooldown:
                    target = desired
                    reason = (
                        f"up: offered {obs.offered_rps:.2f} rps / cap "
                        f"{obs.capacity_rps:.2f} -> {desired}"
                    )
                    self._last_up[m] = now
                else:
                    reason = "hold: up-cooldown"
            elif desired <= math.floor(obs.replicas * (1.0 - cfg.hysteresis)):
                since = self._low_since.setdefault(m, now)
                held = now - since
                in_down_cd = now - self._last_down.get(m, -math.inf) < cfg.down_cooldown
                if held >= cfg.down_cooldown and not in_down_cd:
                    target = desired
                    reason = f"down: sustained low for {held:.0f}s -> {desired}"
                    self._last_down[m] = now
                    self._low_since.pop(m, None)
                else:
                    reason = "hold: down-cooldown"
            else:
                # Inside the hysteresis band: by design, do nothing.
                self._low_since.pop(m, None)
            out.append(ScaleDecision(model=m, current=obs.replicas, target=target,
                                     reason=reason))
        return out
