"""Whether what the timed path served is correct.

The reference (``chipbench/reference``) runs once over each sampled
request's prompt and the tokens the program served it, teacher-forced, in
float32 with TF32 off, and reads how far each served token's logit lies
below the best logit of its position (0 where they agree; greedy tokens
only, and the engine decodes greedily).  The widest of these gaps is the
number compared.

The sample is drawn from the seed among the requests that finished in
the window, with the longest among them, and is sized so that it holds
some hundreds of served tokens.  An MoE model's routing is a discrete
choice that rounding flips where two router logits nearly tie, and with a
capacity it depends on the whole step's batch; so the harness records the
program's expert selection through the pre-roll and the window
(``harness.Routes``).  The reference takes that selection, works out
which of its pairs an expert takes itself (the kind's ``keep``: the
capacity drops, or all of them for a router that drops none), and computes
the rest; ``route_gap``, how far a selected expert's reference router
logit lies below the reference's own k-th best, checks the selection by
itself.  The reference, ``keep`` and the route gaps are the cell's kind's
(``chipbench/kinds/<kind>.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from . import kinds
from .reference import served_gaps


def sample(rec, seed: int, n: int) -> List[int]:
    """``n`` of the requests finished in the window, drawn from the seed,
    the longest (prompt and served tokens) among them."""
    done = sorted(r for r, q in rec.requests.items()
                  if q.tokens is not None and rec.t_open < q.done <= rec.t_close)
    if not done:
        return []
    longest = max(done, key=lambda r: (rec.requests[r].prompt_len + len(rec.requests[r].tokens), r))
    rest = [r for r in done if r != longest]
    rng = np.random.default_rng([seed % (1 << 64), 7])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + sorted(rest[i] for i in pick)


def routes_of(rec, rid: int, config: Dict[str, Any]):
    """Per MoE layer, the (selected, kept) experts of each position of
    ``rid``'s teacher-forced sequence: its prefill's call for the prompt,
    then for each decode the call of that step at its slot; kept by the
    configuration's kind."""
    keep = kinds.of(config).keep
    req = rec.requests[rid]
    pre = rec.prefill_routes.get(rid)
    if pre is None or len(req.decodes) != len(req.tokens) - 1:
        raise RuntimeError(f"request {rid}: routing not observed for its prefill and all "
                           f"{len(req.tokens) - 1} decodes ({len(req.decodes)} seen)")
    out = []
    for layer, sel in enumerate(pre):
        sels = [sel[:req.prompt_len]]
        keeps = [keep(sel, config)[:req.prompt_len]]
        for step, slot in req.decodes:
            dsel = rec.decode_routes[step][layer]
            sels.append(dsel[slot:slot + 1])
            keeps.append(keep(dsel, config)[slot:slot + 1])
        out.append((torch.cat(sels), torch.cat(keeps)))
    return out


def readings(rec, config: Dict[str, Any], params, images, stream, rids: List[int],
             control: bool = False) -> Dict[str, float]:
    """The compared numbers over ``rids``: ``gap`` (widest served-token gap,
    logits), ``route_gap`` (MoE), ``short`` (requests served another count
    of tokens than asked).  With ``control`` also ``control_gap``: the gap
    of the token the fp8 control puts first at each of the same positions,
    and for an MoE model ``control_route_gap``: the route gap of the experts
    the control's own router puts first."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        kind = kinds.of(config)
        ref = kind.Reference(config, params)
        low = kind.Reference(config, params, "fp8") if control else None
        moe = kind.moe_layers(config) > 0
        out = {"gap": 0.0, "short": 0.0}
        if moe:
            out["route_gap"] = 0.0
        if control:
            out["control_gap"] = 0.0
            if moe:
                out["control_route_gap"] = 0.0
        for rid in rids:
            req = rec.requests[rid]
            served = req.tokens
            out["short"] += float(len(served) != req.new_tokens)
            tokens = stream.prompt(rid) + served[:-1]
            at = range(req.prompt_len - 1, req.prompt_len - 1 + len(served))
            image = images[stream.image_slot(rid)] if images is not None else None
            routes = routes_of(rec, rid, config) if moe else None
            with torch.no_grad():
                logits, rgap = ref.logits(tokens, at, image, routes)
                out["gap"] = max(out["gap"], float(served_gaps(logits, served).max()))
                if moe:
                    out["route_gap"] = max(out["route_gap"], rgap)
                if low is not None:
                    lo, _ = low.logits(tokens, at, image, routes)
                    first = lo.argmax(-1).tolist()
                    out["control_gap"] = max(out["control_gap"],
                                             float(served_gaps(logits, first).max()))
                    if moe:
                        out["control_route_gap"] = max(
                            out["control_route_gap"],
                            kind.route_gaps(ref.router_logits, low.router_logits, config))
                del logits
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def verdict(values: Dict[str, float], limits: Dict[str, float],
            n_judged: int, n_wanted: int) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit, in the cell's order, and
    ``missing``: requests of the sample that could not be judged (limit 0).
    A number with no limit in the cell file is an error, not a pass."""
    unlimited = sorted(k for k in set(values) - set(limits) if not k.startswith("control_"))
    if unlimited:
        raise KeyError(f"no limit for {unlimited} in the cell file")
    checks = {name: {"value": values[name], "limit": limits[name]}
              for name in limits if name in values}
    checks["missing"] = {"value": float(n_wanted - n_judged), "limit": 0.0}
    return checks


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
