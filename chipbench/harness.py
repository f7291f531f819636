"""Drives one cell through ``repro_torch.serving.engine.Engine``.

Set-up makes the weights (and, for a mix whose requests carry an image,
the images) from the seed, builds the engine and warms up every prefill
bucket the mix can ask for.  Then the traffic runs: a pre-roll that brings
the engine to its steady load, then the measured window.  Everything the
metrics and the check read is recorded here from the harness's side of the
engine's public calls (``submit``, ``step``, its ``slots`` and
``completed``): when each request was due or sent, admitted and given each
token, and per decode step which slots were active and at what lengths.
For an MoE model the expert selection of every routing call from the
pre-roll on is recorded too (``Routes``), so that the check can judge
requests the window served.

Tracing (``--trace 1``) hands the engine a proxy bundle whose
``prefill_fn`` and ``model.forward`` are timed with a synchronize on each
side and named for the profiler, and traces a steady slice of the window.
Without tracing the engine gets the bundle itself.  A traced run also
keeps what the program's own telemetry (``repro_torch.obs``) recorded
from the pre-roll on (``Program``); an untraced one leaves the program's
no-op handle in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import kinds, weights
from . import traffic as traffic_mod

PREFILL, DECODE = "chipbench.prefill", "chipbench.decode"


@dataclasses.dataclass
class Req:
    rid: int
    sent: float  # when it was due (open loop) or sent (closed loop)
    prompt_len: int
    new_tokens: int
    admitted: Optional[float] = None  # start of the step that admitted it
    times: List[float] = dataclasses.field(default_factory=list)  # each token's step end
    tokens: Optional[List[int]] = None  # what it was served, once complete
    done: Optional[float] = None
    decodes: List[tuple] = dataclasses.field(default_factory=list)  # (step index, slot)


@dataclasses.dataclass
class Step:
    start: float
    end: float
    admitted: List[int]  # rids prefilled this step, in order
    decode_slots: Dict[int, int]  # slot -> rid at this step's decode
    kernel_lengths: Optional[List[int]]  # the decode kernel's length of every slot
    spans: List[tuple] = dataclasses.field(default_factory=list)  # (kind, t0, t1, n, rows)


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Timed:
    """The proxy bundle and model of a traced run: each prefill and decode
    forward is synchronized on both sides, timed on the host clock and named
    ``chipbench.prefill#n`` / ``chipbench.decode#n`` for the profiler."""

    def __init__(self, bundle, sink: List[tuple], device):
        self._bundle = bundle
        self._device = device
        self._model = bundle.model
        self.cfg = bundle.cfg
        self._sink = sink
        self.model = self

    def _timed(self, kind: str, rows: int, fn: Callable, *args, **kw):
        n = len(self._sink)
        sync(self._device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"{kind}#{n}"):
            out = fn(*args, **kw)
            sync(self._device)
        self._sink.append((kind, t0, time.perf_counter(), n, rows))
        return out

    def prefill_fn(self, params, batch, max_len):
        rows = batch["tokens"].shape[1]
        return self._timed(PREFILL, rows, self._bundle.prefill_fn, params, batch, max_len=max_len)

    def init_cache(self, *args, **kw):
        return self._model.init_cache(*args, **kw)

    def forward(self, params, batch, cache=None, positions=None):
        return self._timed(DECODE, batch["tokens"].shape[0], self._model.forward, params, batch,
                           cache=cache, positions=positions)


class Routes:
    """Records the expert selection of every MoE routing call while
    installed, by wrapping ``repro_torch.models.moe._route`` (the program's
    router; it has no public seam).  The wrapper appends the selection
    tensor to a list: no copy, no synchronize."""

    def __init__(self):
        self.calls: List[torch.Tensor] = []
        self._moe = None
        self._orig = None

    def install(self):
        from repro_torch.models import moe

        self._moe, self._orig = moe, moe._route

        def route(p, xt, cfg):
            out = self._orig(p, xt, cfg)
            self.calls.append(out[1])
            return out

        moe._route = route

    def remove(self):
        if self._moe is not None:
            self._moe._route = self._orig
            self._moe = None

    def take(self) -> List[torch.Tensor]:
        calls, self.calls = self.calls, []
        return calls


class ProgramSpan(NamedTuple):
    name: str
    t_start: float  # the host's perf_counter, the harness's clock
    t_end: float
    attrs: Dict[str, Any]


class ProgramEvent(NamedTuple):
    name: str
    time: float  # perf_counter at the serving path's sites
    attrs: Dict[str, Any]


@dataclasses.dataclass
class Program:
    """What the program's live telemetry handle recorded: its finished
    spans and its events, in the order they finished, each counter's total
    (keyed by its name and labels, ``name{label="value"}``), and
    how many records the tracer dropped past its cap (a reader of spans
    or events reads nothing where that is not 0)."""

    spans: List[ProgramSpan]
    events: List[ProgramEvent]
    counters: Dict[str, float]
    n_dropped: int

    @classmethod
    def of(cls, tel) -> "Program":
        tr = tel.tracer
        return cls(
            spans=[ProgramSpan(s.name, s.t_start, s.t_end, dict(s.attrs)) for s in tr.spans],
            events=[ProgramEvent(e.name, e.time, dict(e.attrs)) for e in tr.events],
            counters={m.name + m.label_str(): m.value for m in tel.metrics.instruments()
                      if m.kind == "counter"},
            n_dropped=tr.n_dropped)


@dataclasses.dataclass
class Record:
    """What one run measured, for the metric readers and the check."""

    config: Dict[str, Any]
    mix: Dict[str, Any]
    max_slots: int
    max_len: int
    t_open: float
    t_close: float
    requests: Dict[int, Req]
    steps: List[Step]
    prefill_routes: Dict[int, List[torch.Tensor]]
    decode_routes: Dict[int, List[torch.Tensor]]
    trace: Optional[Dict[str, Any]] = None
    trace_bounds: Optional[tuple] = None
    program: Optional[Program] = None  # traced runs only

    def window_steps(self) -> List[Step]:
        return [s for s in self.steps if s.start >= self.t_open and s.end <= self.t_close]


class Driver:
    """One engine under one mix: submits, steps and records."""

    def __init__(self, engine, config: Dict[str, Any], mix: Dict[str, Any],
                 stream: traffic_mod.Traffic, images: Optional[torch.Tensor],
                 spans: Optional[List[tuple]] = None, routes: Optional[Routes] = None):
        self.engine = engine
        self.config = config
        self.mix = mix
        self.stream = stream
        self.images = images
        self.spans = spans
        self.routes = routes
        self.n_moe_layers = kinds.of(config).moe_layers(config)
        self.max_slots = engine.cfg.max_slots
        self.requests: Dict[int, Req] = {}
        self.steps: List[Step] = []
        self.prefill_routes: Dict[int, List[torch.Tensor]] = {}
        self.decode_routes: Dict[int, List[torch.Tensor]] = {}
        self._dev_idx = np.zeros(self.max_slots, np.int64)
        self._seen = 0  # completions read so far
        self._next = 0  # next request index
        self._due = None

    # -- traffic -------------------------------------------------------------
    def _submit(self, sent: float) -> None:
        from repro_torch.serving.engine import Request

        k = self._next
        self._next += 1
        sp = self.stream.spec(k)
        extras = {}
        if self.images is not None:  # the mix's requests carry an image each
            i = self.stream.image_slot(k)
            extras["patch_embeds"] = self.images[i:i + 1]
        self.engine.submit(Request(rid=str(k), prompt=self.stream.prompt(k),
                                   max_new_tokens=sp.new_tokens, extras=extras))
        self.requests[k] = Req(k, sent, sp.prompt_len, sp.new_tokens)

    def start(self, t_start: float) -> None:
        if self.mix["loop"] == "open":
            n = traffic_mod.requests_needed(self.mix, self.mix["preroll_s"] + 600.0)
            self._due = t_start + self.stream.due_offsets(n)
        else:
            for _ in range(int(self.mix["clients"])):
                self._submit(t_start)

    def _release_due(self, now: float) -> None:
        while self._due[self._next] <= now:
            self._submit(float(self._due[self._next]))

    def next_due(self) -> float:
        return float(self._due[self._next]) if self._due is not None else float("inf")

    # -- stepping -------------------------------------------------------------
    def _slot_map(self) -> Dict[int, int]:
        return {i: int(st.req.rid) for i, st in enumerate(self.engine.slots) if st is not None}

    def step(self) -> Step:
        """One engine step (due requests released first), recorded."""
        eng = self.engine
        if self._due is not None:
            self._release_due(time.perf_counter())
        before = self._slot_map()
        n_spans = len(self.spans) if self.spans is not None else 0
        t0 = time.perf_counter()
        eng.step()
        t1 = time.perf_counter()
        after = self._slot_map()
        new = eng.completed[self._seen:]
        self._seen = len(eng.completed)
        finished = {int(c.rid): c for c in new}
        decode_slots = dict(after)
        decode_slots.update({i: r for i, r in before.items() if r in finished})
        admitted = sorted(r for r in set(after.values()) | set(finished)
                          if not self.requests[r].times)
        for r in admitted:
            self.requests[r].admitted = t0
        for i, r in after.items():
            if r in admitted:
                self._dev_idx[i] = self.requests[r].prompt_len
        lengths = None
        if decode_slots:
            lengths = (self._dev_idx + 1).tolist()
            self._dev_idx += 1
        counts = {r: len(eng.slots[i].generated) for i, r in after.items()}
        counts.update({r: len(c.tokens) for r, c in finished.items()})
        for r, n in counts.items():
            req = self.requests[r]
            req.times.extend([t1] * (n - len(req.times)))
        index = len(self.steps)
        for i, r in decode_slots.items():
            self.requests[r].decodes.append((index, i))
        for r, c in finished.items():
            req = self.requests[r]
            req.tokens, req.done = list(c.tokens), t1
            if self.mix["loop"] == "closed":
                self._submit(t1)
        st = Step(t0, t1, admitted, decode_slots, lengths)
        if self.spans is not None:
            st.spans = self.spans[n_spans:]
        if self.routes is not None:
            self._split_routes(index, admitted, bool(decode_slots))
        self.steps.append(st)
        return st

    def _split_routes(self, index: int, admitted: List[int], decoded: bool) -> None:
        calls = self.routes.take()
        L = self.n_moe_layers
        want = L * (len(admitted) + int(decoded))
        if len(calls) != want:
            raise RuntimeError(
                f"{len(calls)} routing calls in a step, {want} expected "
                f"({len(admitted)} prefills and {int(decoded)} decode of {L} MoE layers)")
        for j, r in enumerate(admitted):
            self.prefill_routes[r] = calls[j * L:(j + 1) * L]
        if decoded:
            self.decode_routes[index] = calls[-L:]

    def run_until(self, t_end: float, on_step: Optional[Callable[[float], None]] = None) -> float:
        """Step (or wait for the next arrival) until ``t_end``; returns the
        time the last step ended, at or past ``t_end``."""
        now = time.perf_counter()
        while now < t_end:
            if self._due is not None:
                self._release_due(now)
            if self.engine.has_work:
                self.step()
            else:
                time.sleep(max(0.0, min(self.next_due(), t_end) - now))
            now = time.perf_counter()
            if on_step is not None:
                on_step(now)
        return now

    def record(self, t_open: float, t_close: float) -> Record:
        return Record(self.config, self.mix, self.max_slots, self.engine.cfg.max_len, t_open,
                      t_close, self.requests, self.steps, self.prefill_routes, self.decode_routes)


def warm_up(engine, config: Dict[str, Any], mix: Dict[str, Any], seed: int,
            images: Optional[torch.Tensor]) -> None:
    """One request per prefill bucket the mix can ask for (power-of-two
    buckets from its shortest prompt to its longest), two tokens each, run
    to completion: every kernel and GEMM shape of the window is built and
    chosen here."""
    from repro_torch.serving.engine import Request

    lo, hi = int(mix["prompt"]["min"]), int(mix["prompt"]["max"])
    rng = np.random.default_rng([seed % (1 << 64), 9])
    b = 1 << (lo - 1).bit_length()
    n = 0
    while True:
        plen = min(b, hi)
        extras = {"patch_embeds": images[:1]} if images is not None else {}
        engine.submit(Request(rid=f"warm{n}", prompt=rng.integers(1, config["vocab_size"],
                                                                   size=plen).tolist(),
                              max_new_tokens=2, extras=extras))
        n += 1
        if plen >= hi:
            break
        b *= 2
    engine.run()
    engine.completed.clear()


def setup(config: Dict[str, Any], arch, mix: Dict[str, Any], seed: int, device,
          trace: bool):
    """The weights, images and warmed engine of one run."""
    from repro_torch.models import bundle as make_bundle
    from repro_torch.serving.engine import Engine, EngineConfig

    real = make_bundle(arch)
    params = weights.make(config, seed, device)
    weights.check_layout(params, real.param_shapes())
    images = None
    if config.get("frontend") and mix.get("images"):
        images = weights.images(config, seed, int(mix["pool"]), device)
    spans: Optional[List[tuple]] = [] if trace else None
    bundle = _Timed(real, spans, device) if trace else real
    engine = Engine(bundle, params, EngineConfig(max_slots=int(mix["slots"]),
                                                 max_len=int(mix["max_len"])))
    warm_up(engine, config, mix, seed, images)
    if spans is not None:
        spans.clear()
    return params, images, engine, spans
