"""Continuous-batching inference engine (iteration-level scheduling).
Counterpart of ``repro/serving/engine.py``, with the same behaviour:

  * a fixed decode batch of ``max_slots`` sequence slots shares one ragged
    cache (per-slot ``index`` lengths — see models/transformer.init_cache);
  * a new request is PREFILLED at batch 1 (padded to a power-of-two bucket
    for attention archs; exact length for recurrent archs, whose state would
    otherwise be advanced through padding), then INSERTED into a free slot
    via kvcache.insert_prefix; the prefill's batch names the last true
    prompt position as its "logit_positions" [[plen - 1]], so the f32 head
    runs on that one row (logits (1, 1, V)) and not over the bucket;
  * one ``step()`` = admit waiting requests into free slots + one ragged
    decode step advancing every active slot by one token;
  * finished sequences (EOS / max_new_tokens) release their slot — the next
    admission overwrites it, no cache zeroing needed.

The reference jits the decode step and donates the cache; here the model
updates the cache tensors in place.  The engine runs on the device its
parameters live on.

Telemetry (``repro_torch.obs``; the default handle records nothing): an
``engine.submit`` event (``time.perf_counter`` clock, the spans' own) per
request, so a request's wait for admission runs from it to the start of
its ``engine.prefill`` span, joined by ``rid``; per ``step()`` an
``engine.step`` span over ``engine.prefill`` (upload, forward, first-token
readback, ``kvcache.insert``) per admitted request and one
``engine.decode`` (prepare, index readback, upload, forward, readback,
retire); request-level records carry the request's ``rid``.  Counters
``engine_prefill_tokens_total`` (positions prefilled, the bucket's padding
included) and ``engine_prefill_pad_tokens_total`` (the padding).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from ..models.model_zoo import ModelBundle
from ..obs import get_telemetry
from ..tree import tree_leaves
from .kvcache import insert_prefix

__all__ = ["Request", "Completion", "Engine", "EngineConfig"]


@dataclasses.dataclass
class Request:
    rid: str
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    #: extra prefill inputs (e.g. patch_embeds for VLM, frames for enc-dec):
    #: tensors or numpy arrays, moved to the engine's device at prefill
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Completion:
    rid: str
    prompt: List[int]
    tokens: List[int]
    prefill_len: int
    finish_reason: str  # "eos" | "length"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 4
    max_len: int = 256
    bucket_prefill: bool = True  # pad prompts to pow2 (attention archs only)


@dataclasses.dataclass
class _SlotState:
    req: Request
    generated: List[int]
    length: int  # true tokens in cache (prompt + generated)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _first_index(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, dict):
        if "index" in tree:
            return tree["index"]
        children = [tree[k] for k in sorted(tree)]
    elif isinstance(tree, list):
        children = tree
    else:
        return None
    for child in children:
        found = _first_index(child)
        if found is not None:
            return found
    return None


class Engine:
    """One model replica serving requests with continuous batching."""

    def __init__(self, bundle: ModelBundle, params, cfg: EngineConfig = EngineConfig()):
        self.bundle = bundle
        self.model = bundle.model
        self.params = params
        self.cfg = cfg
        self.device = next(tree_leaves(params)).device
        self._recurrent = bundle.cfg.is_recurrent
        enc_len = bundle.cfg.frontend_len if bundle.cfg.enc_dec else 0
        self.cache = self.model.init_cache(
            cfg.max_slots, cfg.max_len, enc_len, ragged=True, device=self.device
        )
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[_SlotState]] = [None] * cfg.max_slots
        self.completed: List[Completion] = []
        self.stats: Dict[str, Any] = {"prefills": 0, "decode_steps": 0, "tokens": 0}

    # ------------------------------------------------------------------ API
    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.cfg.max_len:
            raise ValueError(
                f"{req.rid}: prompt+max_new={len(req.prompt)}+{req.max_new_tokens} "
                f"exceeds max_len={self.cfg.max_len}"
            )
        tel = get_telemetry()
        if tel.enabled:
            tel.tracer.event("engine.submit", time.perf_counter(), rid=req.rid,
                             prompt_len=len(req.prompt))
        self.queue.append(req)

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    def step(self) -> int:
        """Admit waiting requests, then advance all active slots one token.

        Returns the number of tokens produced this step (incl. the first
        token each admitted request gets from its prefill logits)."""
        tel = get_telemetry()
        with tel.tracer.span("engine.step") as sp:
            admitted = self._admit()  # one token per admitted request
            if tel.enabled:
                sp.set(admitted=admitted, active=self.n_active)
            return admitted + self._decode_step()

    def run(self, max_steps: int = 100_000) -> List[Completion]:
        for _ in range(max_steps):
            if not self.has_work:
                break
            self.step()
        return self.completed

    # ------------------------------------------------------------- internals
    def _admit(self) -> int:
        produced = 0
        for slot_id, st in enumerate(self.slots):
            if st is not None or not self.queue:
                continue
            req = self.queue.popleft()
            first_tok = self._prefill_into(slot_id, req)
            self.slots[slot_id] = _SlotState(
                req=req, generated=[first_tok], length=len(req.prompt) + 1
            )
            self.stats["prefills"] += 1
            self.stats["tokens"] += 1
            produced += 1
            self._retire_if_done(slot_id)
        return produced

    @torch.no_grad()
    def _prefill_into(self, slot_id: int, req: Request) -> int:
        plen = len(req.prompt)
        pad = _next_pow2(plen) if (self.cfg.bucket_prefill and not self._recurrent) else plen
        tel = get_telemetry()
        tracer = tel.tracer
        with tracer.span("engine.prefill") as sp:
            if tel.enabled:
                sp.set(rid=req.rid, prompt_len=plen, bucket=pad, pad_tokens=pad - plen)
                tel.metrics.counter(
                    "engine_prefill_tokens_total",
                    "positions prefilled, the bucket's padding included").inc(pad)
                tel.metrics.counter(
                    "engine_prefill_pad_tokens_total",
                    "prefilled positions that pad a prompt to its bucket").inc(pad - plen)
            with tracer.span("engine.prefill.upload"):
                toks = np.zeros((1, pad), np.int64)
                toks[0, :plen] = req.prompt
                batch = {"tokens": torch.from_numpy(toks).to(self.device),
                         **{k: torch.as_tensor(v).to(self.device)
                            for k, v in req.extras.items()},
                         # the head runs at the LAST TRUE prompt position alone
                         "logit_positions": torch.full((1, 1), plen - 1, dtype=torch.long,
                                                       device=self.device)}
            with tracer.span("engine.prefill.forward"):
                logits, prefix = self.bundle.prefill_fn(self.params, batch,
                                                        max_len=self.cfg.max_len)
            with tracer.span("engine.prefill.readback"):
                # first generated token: logits at the last true prompt position
                first = int(torch.argmax(logits[0, 0, :]))
            insert_prefix(self.cache, prefix, slot_id, plen)
        # the first token's KV is not in the cache yet: the next decode
        # step's write appends it
        return first

    @torch.no_grad()
    def _decode_step(self) -> int:
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        tel = get_telemetry()
        tracer = tel.tracer
        with tracer.span("engine.decode") as sp:
            if tel.enabled:
                sp.set(active=len(active),
                       live_rows=sum(self.slots[i].length for i in active))
            with tracer.span("engine.decode.prepare"):
                tokens = np.zeros((self.cfg.max_slots, 1), np.int64)
                lengths = np.zeros((self.cfg.max_slots,), np.int32)
                for i, st in enumerate(self.slots):
                    if st is not None:
                        tokens[i, 0] = st.generated[-1]
                        lengths[i] = st.length - 1  # position OF the fed token
            with tracer.span("engine.decode.index_readback"):
                # inactive slots: keep device/host index agreement by feeding
                # their device-side index (the model bumps every slot's index by 1).
                dev_idx = self._slot_indexes()
                for i in range(self.cfg.max_slots):
                    if self.slots[i] is None:
                        lengths[i] = dev_idx[i]
            with tracer.span("engine.decode.upload"):
                batch = {"tokens": torch.from_numpy(tokens).to(self.device)}
                positions = torch.from_numpy(lengths).to(self.device)[:, None]
            with tracer.span("engine.decode.forward"):
                logits, self.cache, _ = self.model.forward(
                    self.params, batch, cache=self.cache, positions=positions)
            with tracer.span("engine.decode.readback"):
                nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
            with tracer.span("engine.decode.retire"):
                produced = 0
                self.stats["decode_steps"] += 1
                for i in active:
                    st = self.slots[i]
                    st.generated.append(int(nxt[i]))
                    st.length += 1
                    produced += 1
                    self.stats["tokens"] += 1
                    self._retire_if_done(i)
        return produced

    def _slot_indexes(self) -> np.ndarray:
        """Device-side per-slot cache index: the first ``index`` leaf in the
        reference's (sorted-key) traversal; zeros for a cache without one."""
        leaf = _first_index(self.cache)
        if leaf is None:
            return np.zeros((self.cfg.max_slots,), np.int32)
        arr = leaf.cpu().numpy()
        return arr[0] if arr.ndim == 2 else np.broadcast_to(arr, (self.cfg.max_slots,))

    def _retire_if_done(self, slot_id: int) -> None:
        st = self.slots[slot_id]
        req = st.req
        done_eos = req.eos_id is not None and st.generated[-1] == req.eos_id
        done_len = len(st.generated) >= req.max_new_tokens
        if done_eos or done_len:
            self.completed.append(
                Completion(
                    rid=req.rid,
                    prompt=list(req.prompt),
                    tokens=list(st.generated),
                    prefill_len=len(req.prompt),
                    finish_reason="eos" if done_eos else "length",
                )
            )
            self.slots[slot_id] = None
