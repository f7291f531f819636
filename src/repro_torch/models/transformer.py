"""Decoder-only and encoder-decoder LMs over heterogeneous blocks: GQA or
MLA attention with a dense or MoE FFN, Mamba-2 and xLSTM (mLSTM / sLSTM),
Zamba2's weight-shared attention block, a ViT patch frontend spliced over
the leading positions and an audio encoder feeding cross-attention: the
trunk the served replica runs.
Counterpart of ``repro/models/transformer.py``.

Layers of one kind are stacked with a leading L dimension, exactly as in the
reference's parameter and cache pytrees, so weights bridge over as plain
copies.  Hybrids split their runs at shared-attention boundaries, as the
reference does.  Where the reference runs ``jax.lax.scan`` over a stack,
this runs a Python loop over its rows.  The same ``forward`` serves three
modes:
  * no cache — full-sequence causal (training: ``Model.loss``)
  * prefill  — full-sequence causal, K/V and recurrent state written into
               the cache in place
  * decode   — one token per sequence against the cache, in place

Telemetry (``repro_torch.obs``): a ``model.forward`` span per call (``mode``
"decode" for one token a row at given positions, else "prefill"; ``rows``
the token rows computed) over ``model.embed`` (the embedding and any
frontend: patch projection, audio encoder), one ``model.block`` per layer
(``layer``, ``kind``; Zamba2's shared attention block as kind
"shared_attn", ``layer`` its application's number) and ``model.head`` (the
final norm and the f32 head; ``rows`` the rows it ran over, with the counter
``model_head_rows_total`` their sum).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..distribution import sharding
from ..kernels import ops as kops
from ..obs import get_telemetry
from . import layers, moe, ssm

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: activation rematerialization of the layer groups' blocks: None (save
#: everything) or "block" (save only the residual stream between blocks and
#: recompute each block's interior in the backward pass).  As in the
#: reference, the weight-shared attention block, the encoder-decoder trunk and
#: the MTP block are not rematerialized.
_REMAT = {"mode": None}


def set_remat(mode: Optional[str]) -> None:
    if mode not in (None, "block"):
        raise ValueError(f"set_remat: None or 'block', got {mode!r}")
    _REMAT["mode"] = mode


def remat_mode() -> Optional[str]:
    return _REMAT["mode"]


def _maybe_remat(fn):
    """``fn`` wrapped in ``torch.utils.checkpoint`` under ``set_remat("block")``.
    Only cacheless (training) calls are wrapped: a prefill or decode writes
    its cache in place, which a recompute would write twice."""
    if _REMAT["mode"] != "block":
        return fn

    def wrapped(p, x, kind, cfg, positions, cache):
        if cache is not None:
            return fn(p, x, kind, cfg, positions, cache)
        # the blocks draw no random numbers, so the RNG state needs no stash
        return checkpoint(fn, p, x, kind, cfg, positions, cache, use_reentrant=False,
                          preserve_rng_state=False)
    return wrapped


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _attn_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device, ragged: bool):
    cache = {"index": torch.zeros((batch,) if ragged else (), dtype=torch.int32, device=device)}
    if cfg.attention == "mla":
        cache["c_kv"] = torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device)
        cache["k_pe"] = torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dtype,
                                    device=device)
        return cache
    # a sliding window bounds the cache to a ring of window rows
    s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, s, cfg.n_kv_heads, cfg.head_dim_)
    if layers.kv_quant_enabled() and not cfg.sliding_window:
        # int8 K/V + an f32 scale per (token, head)
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[f"{name}_s"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
    else:
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def _block_cache(kind: str, cfg: ArchConfig, batch: int, max_len: int, dtype, device,
                 ragged: bool):
    if kind in ("attn", "moe"):
        return {"attn": _attn_cache(cfg, batch, max_len, dtype, device, ragged)}
    if kind == "mlstm":
        return {"mixer": ssm.init_mlstm_state(cfg, batch, device)}
    if kind == "slstm":
        return {"mixer": ssm.init_slstm_state(cfg, batch, device)}
    return {"mixer": ssm.init_mamba_state(cfg, batch, dtype, device)}


def _stack(n: int, tree):
    if isinstance(tree, dict):
        return {k: _stack(n, v) for k, v in tree.items()}
    return tree.expand((n,) + tree.shape).clone()


def _layer(tree, i: int):
    """Row i of a stacked tree: views, so in-place cache writes land in the stack."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_block(p: Params, x: torch.Tensor, kind: str, cfg: ArchConfig, positions, cache):
    """One block, the cache updated in place.  Returns (x_out, aux): the
    MoE's f32 load-balancing loss, or the Python float 0.0 for any other
    block (no tensor is made for it).  Under an fsdp mesh the block's
    weights are gathered over the data axes here, inside any remat, so a
    recompute gathers them again."""
    p = sharding.gather_fsdp(p)
    h = layers.apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    if kind not in ("attn", "moe"):  # recurrent mixers
        fn = {"mamba2": ssm.mamba2_block, "mlstm": ssm.mlstm_block,
              "slstm": ssm.slstm_block}[kind]
        y, _ = fn(p["mixer"], h, cfg, cache["mixer"] if cache is not None else None)
        return x + y, 0.0
    attn = layers.mla_attention if cfg.attention == "mla" else layers.attention
    x = x + attn(p["attn"], h, cfg, positions, cache["attn"] if cache is not None else None)
    h = layers.apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
    if kind == "moe":
        y, aux = moe.apply_moe(p["moe"], h, cfg)
        return x + y, aux
    return x + layers.apply_mlp(p["mlp"], h, cfg.mlp), 0.0


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def _groups(self) -> Tuple[Tuple[str, int], ...]:
        """Layer runs, split at shared-attention boundaries for hybrids: the
        stacking of the reference's parameter and cache trees."""
        cfg = self.cfg
        runs = cfg.layer_groups()
        if not cfg.shared_attn_every:
            return runs
        out: List[Tuple[str, int]] = []
        for kind, count in runs:
            while count > 0:
                take = min(cfg.shared_attn_every, count)
                out.append((kind, take))
                count -= take
        return tuple(out)

    @property
    def n_shared_apps(self) -> int:
        """How many times the shared attention block is applied."""
        cfg = self.cfg
        return cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0

    # ---- cache init --------------------------------------------------------
    def init_cache(
        self, batch: int, max_len: int, enc_len: int = 0, ragged: bool = False,
        device="cuda",
    ) -> Params:
        """ragged=True gives every batch slot its own cache index — the
        continuous-batching decode state used by serving/engine.py.  An
        encoder-decoder's cache also holds the cross-attention K/V of
        ``enc_len`` encoder states per layer under ``"cross"``."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = torch_dtype(cfg)
        cache: Params = {
            "groups": [_stack(count, _block_cache(kind, cfg, batch, max_len, dtype, dev, ragged))
                       for kind, count in self._groups()]
        }
        if cfg.shared_attn_every:
            cache["shared"] = _stack(
                self.n_shared_apps, _block_cache("attn", cfg, batch, max_len, dtype, dev, ragged))
        if cfg.enc_dec:
            shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim_)
            cache["cross"] = {name: torch.zeros(shape, dtype=dtype, device=dev)
                              for name in ("k", "v")}
        return cache

    # ---- embedding + frontends ----------------------------------------------
    def _embed_inputs(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Token embeddings; a VLM's projected patch embeddings replace the
        first min(n_patches, S) positions."""
        x = layers.embed(params["embedding"], batch["tokens"])
        if self.cfg.frontend == "vit" and "patch_embeds" in batch:
            pe = _project(batch["patch_embeds"], params["frontend"]["patch_proj"])
            npatch = min(pe.shape[1], x.shape[1])
            # hinted as the embedding is: the projection's partial sums over
            # ``model`` would otherwise ride on into the trunk
            x = layers.hint(torch.cat([pe[:, :npatch].to(x.dtype), x[:, npatch:]], dim=1),
                            "batch", "seq", None)
        return x

    def _encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """The audio encoder over precomputed frame embeddings (a stub
        frontend): non-causal attention blocks without RoPE, then ln_f."""
        cfg = self.cfg
        h = _project(frames, params["frontend"]["patch_proj"]) if cfg.frontend else frames
        x = layers.hint(h.to(torch_dtype(cfg)), "batch", "seq", None)
        hd = cfg.head_dim_
        blocks = params["encoder"]["blocks"]
        b, s, _ = x.shape
        for i in range(cfg.n_encoder_layers):
            bp = sharding.gather_fsdp(_layer(blocks, i))
            hh = layers.apply_norm(bp["ln1"], x, cfg.norm, cfg.norm_eps)
            q = (hh @ bp["attn"]["wq"]).reshape(b, s, cfg.n_heads, hd)
            k = (hh @ bp["attn"]["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
            v = (hh @ bp["attn"]["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
            a = kops.flash_attention(q, k, v, causal=False)
            x = x + sharding.merge_heads(a) @ bp["attn"]["wo"]
            hh = layers.apply_norm(bp["ln2"], x, cfg.norm, cfg.norm_eps)
            x = x + layers.apply_mlp(bp["mlp"], hh, cfg.mlp)
        return layers.apply_norm(params["encoder"]["ln_f"], x, cfg.norm, cfg.norm_eps)

    # ---- decoder trunks ------------------------------------------------------
    def _trunk(self, params: Params, x: torch.Tensor, positions, cache):
        """-> (x, aux summed over the blocks)."""
        cfg = self.cfg
        tel = get_telemetry()
        tracer = tel.tracer
        block = _maybe_remat(_apply_block)
        done, shared_ct, aux_total = 0, 0, 0.0
        for gi, (kind, count) in enumerate(self._groups()):
            gp = params["groups"][gi]
            gc = cache["groups"][gi] if cache is not None else None
            for i in range(count):
                with tracer.span("model.block") as sp:
                    if tel.enabled:
                        sp.set(layer=done + i, kind=kind)
                    x, aux = block(_layer(gp, i), x, kind, cfg, positions,
                                   _layer(gc, i) if gc is not None else None)
                aux_total = aux_total + aux
            done += count
            if (cfg.shared_attn_every and done % cfg.shared_attn_every == 0
                    and shared_ct < self.n_shared_apps):
                sc = _layer(cache["shared"], shared_ct) if cache is not None else None
                with tracer.span("model.block") as sp:
                    if tel.enabled:
                        sp.set(layer=shared_ct, kind="shared_attn")
                    x, aux = _apply_block(params["shared_attn"], x, "attn", cfg, positions, sc)
                aux_total = aux_total + aux
                shared_ct += 1
        return x, aux_total

    def _trunk_encdec(self, params: Params, x: torch.Tensor, positions, cache,
                      enc_out: Optional[torch.Tensor]):
        """Decoder layers with interleaved cross-attention.  With ``enc_out``
        (prefill, or no cache) the cross K/V are computed from it and, given
        a cache, written there; without it (decode) they are read from the
        cache.  -> (x, aux summed over the blocks)."""
        cfg = self.cfg
        tel = get_telemetry()
        tracer = tel.tracer
        gp, cross = params["groups"][0], params["cross"]
        aux_total = 0.0
        for i in range(cfg.n_layers):
            with tracer.span("model.block") as sp:
                if tel.enabled:
                    sp.set(layer=i, kind="attn")
                bc = _layer(cache["groups"][0], i) if cache is not None else None
                x, aux = _apply_block(_layer(gp, i), x, "attn", cfg, positions, bc)
                aux_total = aux_total + aux
                cp = sharding.gather_fsdp(_layer(cross, i))
                h = layers.apply_norm(cp["ln"], x, cfg.norm, cfg.norm_eps)
                cc = _layer(cache["cross"], i) if cache is not None else None
                x = x + layers.cross_attention(cp["attn"], h, cfg, enc_out, cc)
        return x, aux_total

    # ---- public entry points -------------------------------------------------
    def forward(
        self,
        params: Params,
        batch: Dict[str, torch.Tensor],
        cache: Optional[Params] = None,
        positions: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
        """Returns (f32 logits (B,S,V), cache, aux): ``aux`` is the f32 scalar
        sum of the MoE layers' load-balancing losses (0 without MoE).  The
        cache is updated in place and returned for symmetry with the
        reference's functional API.  ``batch`` holds "tokens" and, at
        prefill, a VLM's "patch_embeds" (B,n_patches,frontend_dim) or an
        encoder-decoder's "frames" (B,frontend_len,frontend_dim).

        An optional "logit_positions" (B,K) integer entry names the positions
        whose logits the caller reads: the final norm and the f32 head then
        run on those K rows of each sequence alone and the logits are
        (B,K,V), row k of sequence b the logits at ``logit_positions[b, k]``.
        Without it the head covers all S positions.  Under a mesh (a DTensor
        trunk output) the entry is refused."""
        cfg = self.cfg
        tel = get_telemetry()
        tracer = tel.tracer
        with tracer.span("model.forward") as sp:
            params = _gather_top(params)
            tokens = batch["tokens"]
            b, s = tokens.shape
            if tel.enabled:
                sp.set(mode="decode" if positions is not None and s == 1 else "prefill",
                       rows=b * s)
            if positions is None:
                positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
            with tracer.span("model.embed"):
                x = self._embed_inputs(params, batch)
                enc_out = None
                if cfg.enc_dec and "frames" in batch:
                    enc_out = self._encode(params, batch["frames"])
            if cfg.enc_dec:
                x, aux = self._trunk_encdec(params, x, positions, cache, enc_out)
            else:
                x, aux = self._trunk(params, x, positions, cache)
            with tracer.span("model.head") as sp:
                if "logit_positions" in batch:
                    x = _rows_at(x, batch["logit_positions"])
                if tel.enabled:
                    rows = x.shape[0] * x.shape[1]
                    sp.set(rows=rows)
                    tel.metrics.counter(
                        "model_head_rows_total",
                        "rows the final norm and the f32 head ran over").inc(rows)
                x = layers.apply_norm(params["ln_f"], x, cfg.norm, cfg.norm_eps)
                head = params["embedding"] if cfg.tie_embeddings else params["lm_head"]
                logits = layers.lm_logits(head, x, cfg.tie_embeddings)
            if not isinstance(aux, torch.Tensor):
                aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return logits, cache, aux

    # ---- loss -----------------------------------------------------------------
    def loss(self, params: Params, batch: Dict[str, torch.Tensor]):
        """Next-token cross-entropy + 0.01 x the MoE aux loss (+ 0.3 x the MTP
        loss where the config has an MTP head) -> (total, {"ce", "aux"[, "mtp"]}).
        Targets are the tokens rolled left by one, the last position masked."""
        cfg = self.cfg
        logits, _, aux = self.forward(params, batch)
        tokens = batch["tokens"]
        targets = layers.roll_seq(tokens, -1)
        mask = torch.ones(targets.shape, dtype=torch.float32, device=tokens.device)
        mask[:, -1] = 0.0
        ce = _xent(logits, targets, mask)
        total = ce + 0.01 * aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp_depth and "mtp" in params:
            mtp_loss = self._mtp_loss(params, batch)
            total = total + 0.3 * mtp_loss
            metrics["mtp"] = mtp_loss
        return total, metrics

    def _mtp_loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """DeepSeek-V3 multi-token prediction (depth 1, simplified, as the
        reference): one extra block over [emb(t) ; emb(t+1)] predicting token
        t+2, the last two positions masked."""
        cfg = self.cfg
        params = _gather_top(params)
        tokens = batch["tokens"]
        b, s = tokens.shape
        emb = layers.embed(params["embedding"], tokens)
        nxt = layers.roll_seq(emb, -1)
        h = torch.cat([emb, nxt], dim=-1) @ params["mtp"]["proj"]
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        h, _ = _apply_block(params["mtp"]["block"], h, "attn", cfg, positions, None)
        h = layers.apply_norm(params["mtp"]["ln"], h, cfg.norm, cfg.norm_eps)
        head = params["embedding"] if cfg.tie_embeddings else params["lm_head"]
        logits = layers.lm_logits(head, h, cfg.tie_embeddings)
        t2 = layers.roll_seq(tokens, -2)
        mask = torch.ones(t2.shape, dtype=torch.float32, device=tokens.device)
        mask[:, -2:] = 0.0
        return _xent(logits, t2, mask)


def _gather_top(params: Params) -> Params:
    """``params`` with the leaves outside the layer stacks (embedding, final
    norms, head, frontend, the MTP projection) gathered over the data axes
    under an fsdp mesh; the stacks' layers are gathered where they run."""
    if sharding.current() is None:
        return params
    out = dict(params)
    for k in ("embedding", "ln_f", "lm_head", "frontend"):
        if k in params:
            out[k] = sharding.gather_fsdp(params[k])
    for k, stack in (("encoder", "blocks"), ("mtp", "block")):
        if k in params:
            out[k] = {n: v if n == stack else sharding.gather_fsdp(v)
                      for n, v in params[k].items()}
    return out


def _rows_at(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) -> the rows (B,K,D) at ``positions`` (B,K) along S."""
    if sharding.is_dtensor(x):
        raise ValueError("logit_positions: not supported under a mesh (the trunk's output "
                         "is a DTensor); leave the entry out for the full logits")
    if positions.dim() != 2 or positions.shape[0] != x.shape[0]:
        raise ValueError(f"logit_positions: want (B, K) with B = {x.shape[0]}, "
                         f"got {tuple(positions.shape)}")
    return torch.take_along_dim(x, positions.long()[..., None], dim=1)


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return ((logz - gold) * mask).sum()


def _xent(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean token cross-entropy of f32 logits.  Under a mesh the
    vocab-sharded logits are gathered over ``model`` first (DTensor's
    ``gather`` along a sharded dim is not exact), and each rank sums the
    loss of its own rows in ``local_map``: DTensor's own ``gather`` backward
    would make every rank a zero gradient of the whole batch's logits."""
    logits = layers.hint(logits, "batch", "seq", None)
    if not sharding.is_dtensor(logits):
        return _nll_sum(logits, targets, mask) / mask.sum().clamp(min=1.0)
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = logits.device_mesh, tuple(logits.placements)
    targets = targets.redistribute(mesh, pl)
    if sharding.is_dtensor(mask):
        mask = mask.redistribute(mesh, pl)
    else:
        mask = distribute_tensor(mask, mesh, pl, src_data_rank=None)
    total = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    nll = local_map(_nll_sum, out_placements=total, in_placements=(pl, pl, pl),
                    device_mesh=mesh)(logits, targets, mask)
    return nll / mask.sum().clamp(min=1.0)


def _project(inputs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """inputs @ w in the promoted dtype of the two, as jnp's matmul computes
    f32 inputs against bf16 weights."""
    dt = torch.promote_types(inputs.dtype, w.dtype)
    return inputs.to(dt) @ w.to(dt)
