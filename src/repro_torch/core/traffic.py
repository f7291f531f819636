"""Request-level traffic generation: the demand axis of the online problem.

The online simulator (``core/events.py``) historically consumed *workload*
traces — replicas arriving with fixed lifetimes.  Nothing derived how many
replicas a model actually needs.  This module supplies the missing input:
seeded, deterministic streams of individual inference requests
``(timestamp, model, prompt_len, decode_len)`` per served model, which the
perf model (``core/perfmodel.py``) and autoscaler (``core/autoscaler.py``)
convert into replica targets.

Arrival processes are inhomogeneous Poisson, sampled by Lewis-Shedler
thinning against the pattern's peak rate, so every pattern family shares one
code path and one determinism guarantee: the same ``(spec, seed, horizon)``
triple always yields a byte-identical trace.

Patterns (MISO/Saraha-style time-varying demand):
  * ``ConstantRate``  — plain Poisson at ``rps``
  * ``DiurnalRate``   — sinusoidal day/night swing around a base rate
  * ``FlashCrowd``    — base rate plus a multiplicative spike window
                        (breaking-news burst; the autoscaler's hard case)
  * ``replay_rows``   — explicit (time, prompt, decode) rows, e.g. from a
                        production trace dump
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

__all__ = [
    "RequestArrival",
    "RequestTrace",
    "RequestShape",
    "ArrivalPattern",
    "ConstantRate",
    "DiurnalRate",
    "FlashCrowd",
    "ModelTraffic",
    "generate_requests",
    "replay_rows",
]

#: request-size assumption before any request of a model has been observed.
DEFAULT_REQUEST_LENS = (512, 128)


@dataclasses.dataclass
class RequestShape:
    """Running mean request shape of one model (both demand loops share it:
    ``DemandSimulator`` in simulation, ``ClusterServer`` over live engines)."""

    n: int = 0
    prompt_sum: int = 0
    decode_sum: int = 0

    def add(self, prompt_len: int, decode_len: int) -> None:
        self.n += 1
        self.prompt_sum += prompt_len
        self.decode_sum += decode_len

    def means(self) -> Tuple[int, int]:
        """(mean prompt, mean decode) tokens; defaults until observed."""
        if self.n == 0:
            return DEFAULT_REQUEST_LENS
        return (
            max(1, self.prompt_sum // self.n),
            max(1, self.decode_sum // self.n),
        )


@dataclasses.dataclass(frozen=True)
class RequestArrival:
    """One inference request hitting the fleet."""

    time: float
    model: str
    prompt_len: int  # prefill tokens
    decode_len: int  # output tokens to generate
    rid: str = ""


@dataclasses.dataclass
class RequestTrace:
    """Time-sorted request stream over ``[0, horizon)``."""

    requests: List[RequestArrival]
    horizon: float

    def __post_init__(self) -> None:
        self.requests.sort(key=lambda r: (r.time, r.model, r.rid))

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    def models(self) -> Tuple[str, ...]:
        return tuple(sorted({r.model for r in self.requests}))

    def offered_rps(self, model: str, t0: float, t1: float) -> float:
        """Mean arrival rate of ``model`` over ``[t0, t1)``."""
        n = sum(1 for r in self.requests if r.model == model and t0 <= r.time < t1)
        return n / max(t1 - t0, 1e-9)

    def total_tokens(self) -> int:
        return sum(r.prompt_len + r.decode_len for r in self.requests)


# ---------------------------------------------------------------------------
# arrival-rate patterns
# ---------------------------------------------------------------------------
class ArrivalPattern:
    """Time-varying arrival rate lambda(t); must bound its own peak."""

    def rate(self, t: float) -> float:
        raise NotImplementedError

    @property
    def peak_rate(self) -> float:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ConstantRate(ArrivalPattern):
    rps: float

    def rate(self, t: float) -> float:
        return self.rps

    @property
    def peak_rate(self) -> float:
        return self.rps


@dataclasses.dataclass(frozen=True)
class DiurnalRate(ArrivalPattern):
    """``base * (1 + amplitude*sin(2*pi*(t+phase)/period))``, floored at 0.

    One ``period`` is a simulated "day"; different models get different
    ``phase`` values to de-synchronize their peaks (the fleet-level win of
    demand-driven sizing: phase-shifted models share the same GPUs).
    """

    base_rps: float
    amplitude: float = 0.8
    period: float = 200.0
    phase: float = 0.0

    def rate(self, t: float) -> float:
        s = math.sin(2.0 * math.pi * (t + self.phase) / self.period)
        return max(0.0, self.base_rps * (1.0 + self.amplitude * s))

    @property
    def peak_rate(self) -> float:
        return self.base_rps * (1.0 + abs(self.amplitude))


@dataclasses.dataclass(frozen=True)
class FlashCrowd(ArrivalPattern):
    """Steady ``base_rps`` with a ``multiplier``-x spike on
    ``[flash_at, flash_at + flash_duration)`` — the scale-up stress case."""

    base_rps: float
    flash_at: float
    flash_duration: float
    multiplier: float = 5.0

    def rate(self, t: float) -> float:
        if self.flash_at <= t < self.flash_at + self.flash_duration:
            return self.base_rps * self.multiplier
        return self.base_rps

    @property
    def peak_rate(self) -> float:
        return self.base_rps * max(self.multiplier, 1.0)


# ---------------------------------------------------------------------------
# per-model traffic specs -> request streams
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelTraffic:
    """Traffic shape of one served model.

    Request sizes are lognormal around the configured means (clamped to
    >= 1 token) — the long right tail is what stresses TTFT at high load.
    """

    model: str
    pattern: ArrivalPattern
    mean_prompt_len: int = 512
    mean_decode_len: int = 128
    len_sigma: float = 0.5  # lognormal shape for both length draws

    def _draw_len(self, rng: np.random.Generator, mean: int) -> int:
        mu = math.log(max(mean, 1)) - 0.5 * self.len_sigma**2
        return max(1, int(rng.lognormal(mu, self.len_sigma)))


def _thinned_arrivals(
    spec: ModelTraffic, rng: np.random.Generator, horizon: float, tag: int
) -> Iterable[RequestArrival]:
    """Lewis-Shedler thinning of the pattern's inhomogeneous Poisson."""
    lam_max = spec.pattern.peak_rate
    if lam_max <= 0.0:
        return
    t = 0.0
    i = 0
    while True:
        t += float(rng.exponential(1.0 / lam_max))
        if t >= horizon:
            return
        if float(rng.random()) * lam_max > spec.pattern.rate(t):
            continue  # thinned: instantaneous rate below the envelope
        yield RequestArrival(
            time=t,
            model=spec.model,
            prompt_len=spec._draw_len(rng, spec.mean_prompt_len),
            decode_len=spec._draw_len(rng, spec.mean_decode_len),
            rid=f"{spec.model}/q{tag}.{i}",
        )
        i += 1


def generate_requests(
    specs: Sequence[ModelTraffic], seed: int, horizon: float
) -> RequestTrace:
    """Seeded request trace for all ``specs`` over ``[0, horizon)``.

    Each spec draws from its own independent substream (SeedSequence spawn
    keyed by position), so adding a model to the end of ``specs`` never
    perturbs the other models' streams.
    """
    root = np.random.SeedSequence(seed)
    streams = root.spawn(len(specs))
    requests: List[RequestArrival] = []
    for i, spec in enumerate(specs):
        rng = np.random.default_rng(streams[i])
        requests.extend(_thinned_arrivals(spec, rng, horizon, tag=i))
    return RequestTrace(requests=requests, horizon=horizon)


def replay_rows(
    model_rows: Dict[str, Sequence[Tuple[float, int, int]]], horizon: float
) -> RequestTrace:
    """Trace replay: explicit ``(time, prompt_len, decode_len)`` rows per
    model (e.g. parsed from a production log)."""
    requests: List[RequestArrival] = []
    for model, rows in sorted(model_rows.items()):
        for i, (t, plen, dlen) in enumerate(rows):
            if not 0.0 <= t < horizon:
                raise ValueError(
                    f"{model} row {i}: time {t} outside [0, {horizon})"
                )
            requests.append(
                RequestArrival(
                    time=float(t),
                    model=model,
                    prompt_len=int(plen),
                    decode_len=int(dlen),
                    rid=f"{model}/q{i}",
                )
            )
    return RequestTrace(requests=requests, horizon=horizon)
