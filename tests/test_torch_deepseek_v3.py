"""DeepSeek-V3 as published (``configs/deepseek_v3_671b.PUBLISHED``) at a
reduced size on the CPU, in f32: the port's prefill and its decode through
the engine's ragged cache against the benchmark's plain reference
(``chipbench/kinds/mla.py``: MLA decompressed, YaRN, eps 1e-6, the grouped
sigmoid router with its bias); the held-expert layer's shares against the
uncut layer; a routing that sends every token to one expert; and the
default router fields leaving Mixtral's MoE layer as it was."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.deepseek_v3_671b import PUBLISHED
from repro_torch.models import bundle, moe
from repro_torch.serving.kvcache import insert_prefix
from repro_torch.tree import tree_map

ROOT = Path(__file__).resolve().parents[1]

# f32 on the CPU on both sides: the same math summed in another order (the
# reference decompresses the latent for every decode, the port absorbs it).
# Observed differences are ~1e-6 of the logits' scale; 1e-4 leaves room,
# and weights rounded to bf16 move the logits by ~1e-2 of it
# (test_a_bf16_reference_fails_the_tolerance)
REL_TOL = 1e-4


@pytest.fixture(scope="module")
def mla():
    """``chipbench/kinds/mla.py``, loaded by its path: plain torch alone."""
    spec = importlib.util.spec_from_file_location("_mla_reference", ROOT / "chipbench" / "kinds"
                                                  / "mla.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(**over):
    """PUBLISHED at a reduced size: every mechanism kept (3 layers, the first
    dense; 16 routed experts in 4 groups, 2 kept, top 4, 8 of them held
    from expert 4; YaRN over an original length of 32 positions, so that
    prompts of ~100 reach the interpolated frequencies)."""
    c = dataclasses.replace(
        PUBLISHED, n_layers=3, n_dense_layers=1, d_model=64, n_heads=4, n_kv_heads=4,
        q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        d_ff=96, moe_d_ff=32, vocab_size=256, n_experts=8, n_routed_experts=16, expert_offset=4,
        experts_per_token=4, n_group=4, topk_group=2, yarn_original_len=32, dtype="float32")
    return dataclasses.replace(c, **over)


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


def _params(mla, cfg, seed=0):
    """The reference's seeded leaves (its draw order and scales), in the
    program's tree."""
    gen = torch.Generator().manual_seed(seed)
    tree = {}
    for path, shape, kind, scale, _ in mla.leaves(_as_dict(cfg)):
        w = torch.randn(shape, generator=gen)
        w = w.mul_(0.1).add_(1.0) if kind == "norm" else w.mul_(scale)
        t = tree
        for k in path[:-1]:
            t = t.setdefault(k, {})
        t[path[-1]] = w
    tree["groups"] = [tree["groups"][str(i)] for i in range(len(tree["groups"]))]
    return tree


class _Routes:
    """The program's expert selection of every routing call."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = moe._route

        def route(p, xt, cfg):
            out = orig(p, xt, cfg)
            self.calls.append(out[1])
            return out

        monkeypatch.setattr(moe, "_route", route)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_leaves_are_the_programs_layout(mla):
    cfg = _cfg()
    shapes = bundle(cfg).param_shapes()
    params = _params(mla, cfg)
    got = tree_map(lambda t: (tuple(t.shape), t.dtype), params)
    want = tree_map(lambda t: (tuple(t.shape), t.dtype), shapes)
    assert got == want


def test_prefill_and_ragged_decode_match_the_reference(mla, monkeypatch):
    """Two requests prefilled at batch 1 into a bucket, inserted into a
    two-slot ragged cache at other lengths, then decoded together; each
    position's logits against the reference's full forward over the same
    tokens, given the program's own expert selection."""
    cfg = _cfg()
    mb = bundle(cfg)
    params = _params(mla, cfg)
    routes = _Routes(monkeypatch)
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen) for n in (90, 57)]
    max_len, steps, moe_layers = 128, 5, cfg.n_layers - cfg.n_dense_layers
    cache = mb.model.init_cache(2, max_len, ragged=True, device="cpu")
    seqs, logits, sel = [], [[], []], [[], []]
    with torch.no_grad():
        for slot, prompt in enumerate(prompts):
            toks = torch.zeros((1, 128), dtype=torch.long)
            toks[0, :prompt.numel()] = prompt
            out, prefix = mb.prefill_fn(params, {"tokens": toks}, max_len=max_len)
            insert_prefix(cache, prefix, slot, prompt.numel())
            logits[slot].append(out[0, :prompt.numel()])
            sel[slot] = [[c[:prompt.numel()]] for c in routes.calls[-moe_layers:]]
            seqs.append(prompt.tolist())
        for _ in range(steps):
            nxt = [int(lg[-1][-1].argmax()) for lg in logits]
            for slot in range(2):
                seqs[slot].append(nxt[slot])
            pos = torch.tensor([[len(s) - 1] for s in seqs])
            out, cache, _ = mb.model.forward(params, {"tokens": torch.tensor([[t] for t in nxt])},
                                             cache=cache, positions=pos)
            for slot in range(2):
                logits[slot].append(out[slot, -1:])
                for layer, c in enumerate(routes.calls[-moe_layers:]):
                    sel[slot][layer].append(c[slot:slot + 1])
    ref = mla.Reference(_as_dict(cfg), params)
    for slot in range(2):
        got = torch.cat(logits[slot])
        n = got.shape[0]
        route = [(torch.cat(s), torch.ones_like(torch.cat(s), dtype=torch.bool))
                 for s in sel[slot]]
        want, gap = ref.logits(seqs[slot][:n], range(n), None, route)
        assert gap < 1e-5  # the program's routing is the reference router's own
        assert _rel(got, want) < REL_TOL, (slot, _rel(got, want))
        # the decode steps alone, where the absorbed path runs
        assert _rel(got[-steps:], want[-steps:]) < REL_TOL


def test_a_bf16_reference_fails_the_tolerance(mla):
    """The tolerance above tells precisions apart: the reference with its
    weights rounded to bf16 lies beyond it (on the f32 reference's routes)."""
    cfg = _cfg()
    c = _as_dict(cfg)
    params = _params(mla, cfg)
    tokens = torch.randint(1, cfg.vocab_size, (60,), generator=torch.Generator().manual_seed(2))
    ref = mla.Reference(c, params)
    want, _ = ref.logits(tokens.tolist(), range(60))
    routes = [(mla.select(z, c), torch.ones((60, 4), dtype=torch.bool)) for z in ref.router_logits]
    low = mla.Reference(c, tree_map(lambda t: t.bfloat16().float(), params))
    got, _ = low.logits(tokens.tolist(), range(60), None, routes)
    assert _rel(got, want) > 10 * REL_TOL


def test_yarn_and_eps_reach_the_logits(mla):
    """The reference's YaRN and eps are not idle at this size: plain RoPE or
    eps 1e-5 moves the logits beyond the tolerance."""
    cfg = _cfg()
    c = _as_dict(cfg)
    params = _params(mla, cfg)
    tokens = torch.randint(1, cfg.vocab_size, (100,), generator=torch.Generator().manual_seed(3))
    ref = mla.Reference(c, params)
    want, _ = ref.logits(tokens.tolist(), range(100))
    routes = [(mla.select(z, c), torch.ones((100, 4), dtype=torch.bool))
              for z in ref.router_logits]
    for other in (dict(c, yarn_factor=0.0), dict(c, norm_eps=1e-5)):
        got, _ = mla.Reference(other, params).logits(tokens.tolist(), range(100), None, routes)
        assert _rel(got, want) > REL_TOL, other


def _moe_params(gen, d, f, r):
    return {"router": torch.randn(d, r, generator=gen) * 0.3,
            "router_bias": torch.randn(r, generator=gen) * 0.05,
            "experts": {"w_gate": torch.randn(r, d, f, generator=gen) * d ** -0.5,
                        "w_up": torch.randn(r, d, f, generator=gen) * d ** -0.5,
                        "w_out": torch.randn(r, f, d, generator=gen) * f ** -0.5},
            "shared": {"w_gate": torch.randn(d, f, generator=gen) * d ** -0.5,
                       "w_up": torch.randn(d, f, generator=gen) * d ** -0.5,
                       "w_out": torch.randn(f, d, generator=gen) * f ** -0.5}}


def _share(p, lo, e):
    return dict(p, experts={k: w[lo:lo + e] for k, w in p["experts"].items()})


def test_expert_parallel_shares_add_up_to_the_uncut_layer(mla):
    """16 experts over 4 shares of 4: the shares' outputs summed, the shared
    expert (which every share computes alike) counted once, equal the layer
    that holds all 16, and the reference's layer over all 16."""
    whole = _cfg(n_experts=16, expert_offset=0, d_model=48, moe_d_ff=40)
    p = _moe_params(torch.Generator().manual_seed(4), 48, 40, 16)
    x = torch.randn(1, 300, 48, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        full, _ = moe.apply_moe(p, x, whole)
        shared = moe.layers.apply_mlp(p["shared"], x[0], "swiglu")
        total = -3 * shared
        for lo in (0, 4, 8, 12):
            y, _ = moe.apply_moe(_share(p, lo, 4), x, dataclasses.replace(
                whole, n_experts=4, expert_offset=lo))
            total = total + y[0]
        ref = mla.Reference(_as_dict(whole), {})
        gates, eidx, _ = moe._route(p, x[0], whole)
        stacked = {"router": p["router"][None], "router_bias": p["router_bias"][None],
                   "experts": {k: w[None] for k, w in p["experts"].items()},
                   "shared": {k: w[None] for k, w in p["shared"].items()}}
        want, gap = ref._moe(stacked, 0, x[0], (eidx, torch.ones_like(eidx, dtype=torch.bool)))
    assert gap == 0.0
    assert _rel(total, full[0]) < 1e-5
    assert _rel(full[0], want) < 1e-5


def test_dropless_when_every_token_picks_one_held_expert(mla):
    """A bias that puts expert 5 (held, local 1) in every token's top k: all
    300 tokens reach it and none is dropped, where a capacity of
    1.25 x T k / E would keep under a tenth of them."""
    cfg = _cfg(d_model=48, moe_d_ff=40)
    p = _moe_params(torch.Generator().manual_seed(6), 48, 40, 16)
    p["router_bias"][5] = 100.0
    x = torch.randn(1, 300, 48, generator=torch.Generator().manual_seed(7))
    held = _share(p, 4, 8)
    with torch.no_grad():
        gates, eidx, _ = moe._route(held, x[0], cfg)
        assert bool((eidx == 5).any(-1).all())
        y, _ = moe.apply_moe(held, x, cfg)
        stacked = {"router": p["router"][None], "router_bias": p["router_bias"][None],
                   "experts": {k: w[None] for k, w in held["experts"].items()},
                   "shared": {k: w[None] for k, w in p["shared"].items()}}
        want, _ = mla.Reference(_as_dict(cfg), {})._moe(
            stacked, 0, x[0], (eidx, torch.ones_like(eidx, dtype=torch.bool)))
    assert _rel(y[0], want) < 1e-5


def _route_as_it_was(p, xt, cfg):
    """``moe._route`` before the router fields: softmax top-k, renormalised."""
    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    me = probs.mean(0)
    aux = cfg.n_experts * torch.sum(me * moe._expert_share(eidx, me))
    return gates, eidx, aux


@pytest.mark.parametrize("name", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_default_router_fields_leave_the_layer_bit_for_bit(name):
    cfg = reduced(get_config(name))
    assert (cfg.scoring_func, cfg.n_group, cfg.n_routed_experts) == ("softmax", 1, 0)
    p = bundle(cfg).init(torch.Generator().manual_seed(8), device="cpu")
    p = p["groups"][-1]["moe"]
    p = tree_map(lambda t: t[0], p)
    x = torch.randn(2, 150, cfg.d_model, generator=torch.Generator().manual_seed(9))
    xt = x.reshape(300, cfg.d_model)
    with torch.no_grad():
        got = moe._route(p, xt, cfg)
        want = _route_as_it_was(p, xt, cfg)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        y, aux = moe.apply_moe(p, x, cfg)
        y0 = moe._apply_dispatch(p, xt, want[0], want[1], cfg)
        if "shared" in p:
            y0 = y0 + moe.layers.apply_mlp(p["shared"], xt, "swiglu")
    assert torch.equal(y, y0.reshape(2, 150, cfg.d_model)) and torch.equal(aux, want[2])


def test_the_held_layer_refuses_a_mesh(monkeypatch):
    cfg = _cfg()
    monkeypatch.setattr(moe, "_under_mesh", lambda: True)
    with pytest.raises(ValueError, match="one device only"):
        moe.apply_moe({}, torch.zeros(1, 2, cfg.d_model), cfg)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check is of the card's queue")
    return "cuda"


@pytest.mark.gpu
def test_prefill_and_decode_do_not_wait_for_the_card(mla, cuda):
    """bf16 on the card: a prefill and a ragged decode forward run with
    torch's sync debug mode set to raise, so no op in MLA (YaRN's tables
    included), the router or the held-expert layer waits for the queue."""
    cfg = _cfg(dtype="bfloat16")
    mb = bundle(cfg)
    f32 = {path for path, _, _, _, is_f32 in mla.leaves(_as_dict(cfg)) if is_f32}

    def put(tree, path=()):
        if isinstance(tree, dict):
            return {k: put(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [put(v, path + (str(i),)) for i, v in enumerate(tree)]
        return tree.to(cuda, torch.float32 if path in f32 else torch.bfloat16)

    params = put(_params(mla, cfg))
    cache = mb.model.init_cache(2, 128, ragged=True, device=cuda)
    toks = torch.randint(1, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(10))
    toks = toks.to(cuda)
    with torch.no_grad():
        for slot in range(2):  # warm: builds the flash kernel, makes YaRN's tables
            _, prefix = mb.prefill_fn(params, {"tokens": toks}, max_len=128)
            insert_prefix(cache, prefix, slot, 64)
        step = {"tokens": torch.ones((2, 1), dtype=torch.long, device=cuda)}
        pos = torch.full((2, 1), 64, device=cuda)
        mb.model.forward(params, step, cache=cache, positions=pos)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            mb.prefill_fn(params, {"tokens": toks}, max_len=128)
            mb.model.forward(params, step, cache=cache, positions=pos + 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
