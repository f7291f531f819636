"""End-to-end serving demo: demand-driven autoscaling of LIVE model
replicas placed on H100 80GB MIG nodes, with real forward passes and batched
requests.  Counterpart of the reference's ``examples/serve_cluster.py``,
with the same trace, autoscaler settings and compaction:

  1. deploy one seed replica per model on the smallest MIG slice (1g.10gb)
     and attach continuous-batching Engines (``engine_factory`` attaches
     engines to scale-ups);
  2. replay a seeded bursty request trace (``core/traffic``) tick by tick:
     submit the tick's requests, pump all engines to completion, and
     measure each request's wall-clock latency;
  3. after every tick, ``ClusterServer.autoscale()`` turns the observed
     offered load + measured SLO attainment into replica targets applied
     through the placement engine (scale-ups get live engines, scale-downs
     drain before teardown);
  4. compaction afterwards, then verify the survivors still serve.

    PYTHONPATH=src python -m repro_torch.launch.serve_cluster             # cuda
    PYTHONPATH=src python -m repro_torch.launch.serve_cluster --device cpu --reduced

Engines run on ``--device`` (default ``cuda``), at full width unless
``--reduced``; every replica of one model shares one seeded set of weights.
Output goes through the std ``logging`` module (stderr); ``--verbose`` adds
per-tick autoscale detail.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.core.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.core.perfmodel import DeviceThroughput, PerfModel
from repro_torch.core.profiles import H100_80GB
from repro_torch.core.traffic import ConstantRate, FlashCrowd, ModelTraffic, generate_requests
from repro_torch.device import resolve_device
from repro_torch.models import bundle
from repro_torch.serving import ClusterServer, Engine, EngineConfig, Request

MODELS = {
    "chat": "smollm-135m",
    "draft": "xlstm-125m",
}
log = logging.getLogger("repro_torch.launch.serve_cluster")

TICK = 5.0  # simulated seconds per control tick
HORIZON = 30.0
#: wall-clock latency budget a request must meet to count as attained
#: (generous; the burst is what should dent it).
SLO_WALL_SECONDS = 20.0
#: 1g.10gb: the smallest slice, as the reference seeds on its smallest block
SEED_PROFILE = 19
#: the reference example's controller rates for its tiny engines, keyed to
#: this device's name so the autoscaler's queueing math runs on the same
#: numbers.  They are settings, not rates measured on any device.
TINY_ENGINE_RATES = {H100_80GB.name: DeviceThroughput(2_000.0, 50.0)}


class EngineMaker:
    """Engines of one shape per model, all replicas of a model on one seeded
    set of weights, built on ``device``."""

    def __init__(self, device: torch.device, reduced: bool, seed: int = 0):
        self.device, self.reduced, self.seed = device, reduced, seed
        self._weights: Dict[str, tuple] = {}

    def __call__(self, model: str, arch: str, wid: str = "") -> Engine:
        if arch not in self._weights:
            cfg = get_config(arch)
            if self.reduced:
                cfg = reduce_cfg(cfg)
            mb = bundle(cfg)
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self._weights[arch] = (mb, mb.init(gen, device=self.device))
        mb, params = self._weights[arch]
        return Engine(mb, params, EngineConfig(max_slots=3, max_len=96))


def bursty_trace():
    """chat gets a 6x flash crowd mid-trace; draft stays steady."""
    return generate_requests(
        [
            ModelTraffic("chat", FlashCrowd(0.4, flash_at=10.0,
                                            flash_duration=10.0, multiplier=6.0),
                         mean_prompt_len=8, mean_decode_len=5, len_sigma=0.3),
            ModelTraffic("draft", ConstantRate(0.4),
                         mean_prompt_len=6, mean_decode_len=4, len_sigma=0.3),
        ],
        seed=0,
        horizon=HORIZON,
    )


def pump_measuring(srv: ClusterServer, submitted_wall: dict, latencies: dict,
                   max_steps: int = 10_000) -> int:
    """Drive all engines until drained, timestamping completions."""
    seen = {wid: len(e.completed) for wid, e in srv.engines.items()}
    total = 0
    for _ in range(max_steps):
        live = [(w, e) for w, e in srv.engines.items() if e.has_work]
        if not live:
            break
        for wid, eng in live:
            total += eng.step()
            for c in eng.completed[seen.get(wid, 0):]:
                if c.rid in submitted_wall:
                    latencies[c.rid] = time.time() - submitted_wall[c.rid]
            seen[wid] = len(eng.completed)
    return total


def run(args) -> dict:
    """The four steps above; returns what a caller checks."""
    dev = resolve_device(args.device)
    make_engine = EngineMaker(dev, args.reduced)
    srv = ClusterServer(
        n_nodes=4,
        device=H100_80GB,
        policy="heuristic",
        autoscaler=Autoscaler(AutoscalerConfig(
            mode="slo", up_cooldown=0.0, down_cooldown=10.0, min_replicas=1,
            max_replicas=3,
        )),
        perf=PerfModel(calibration=TINY_ENGINE_RATES),
        engine_factory=make_engine,
        autoscale_window=TICK,
    )

    # 1. seed deployment: ONE replica per model; the controller grows it.
    for model, arch in MODELS.items():
        rep = srv.deploy(model, arch, n_replicas=1, profile_id=SEED_PROFILE)
        log.info(f"deploy {model}: placed={rep.placed} nodes={rep.metrics.n_gpus}")
        for wid in rep.placed:
            srv.attach_engine(wid, make_engine(model, arch, wid))

    # 2-3. replay the bursty trace tick by tick under autoscale control.
    trace = bursty_trace()
    log.info(f"trace: {trace.n_requests} requests over {HORIZON:.0f}s "
             f"(chat flash crowd at t=10..20)")
    submitted_wall: Dict[str, float] = {}
    latencies: Dict[str, float] = {}
    served = 0
    peak_replicas = {m: 1 for m in MODELS}
    it = iter(trace.requests)
    pending = next(it, None)
    t = 0.0
    while t < HORIZON:
        tick_rids: List[str] = []
        while pending is not None and pending.time < t + TICK:
            req = Request(rid=pending.rid,
                          prompt=list(range(2, 2 + pending.prompt_len)),
                          max_new_tokens=pending.decode_len)
            submitted_wall[req.rid] = time.time()
            tick_rids.append(req.rid)
            srv.submit(pending.model, req, now=pending.time)
            pending = next(it, None)
        served += pump_measuring(srv, submitted_wall, latencies)
        attain = {}
        for m in MODELS:
            rids = [r for r in tick_rids if r.startswith(m)]
            # a quiet tick is a healthy tick, not a 0% one
            attain[m] = (
                sum(latencies.get(r, 1e9) <= SLO_WALL_SECONDS for r in rids)
                / len(rids)
            ) if rids else 1.0
        rep = srv.autoscale(now=t + TICK, attainment=attain)
        for m in MODELS:
            peak_replicas[m] = max(peak_replicas[m], len(srv.replicas_of(m)))
        targets = {d.model: f"{d.current}->{d.target}" for d in rep.decisions}
        log.debug(f"  t={t + TICK:4.0f}s offered={{"
                  + ", ".join(f"{m}: {r:.2f}rps" for m, r in rep.offered_rps.items())
                  + f"}} replicas={targets} slo_attain={attain} "
                  f"nodes={srv.utilization()['nodes_used']}")
        t += TICK

    hit = sum(v <= SLO_WALL_SECONDS for v in latencies.values())
    log.info(f"served {served} tokens, {len(latencies)} requests; "
             f"overall SLO attainment {hit / max(len(latencies), 1):.2f}")

    # 4. compaction, then serve again to prove the survivors are live.
    cr = srv.compact()
    log.info(f"compaction: {cr.before.n_gpus} -> {cr.after.n_gpus} nodes "
             f"({cr.plan.n_moves} moves, committed={cr.committed})")
    srv.submit("chat", Request(rid="post-compact", prompt=[5, 4, 3],
                               max_new_tokens=4))
    srv.pump()
    if not any(c.rid == "post-compact" for e in srv.engines.values() for c in e.completed):
        raise RuntimeError("no live chat replica served after compaction")
    srv.state.validate()
    log.info("post-compaction serving OK")
    return {"n_requests": trace.n_requests, "served_tokens": served,
            "latencies": latencies, "peak_replicas": peak_replicas,
            "compaction": cr, "server": srv}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--verbose", "-v", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(
        stream=sys.stderr,
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(message)s",
    )
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
