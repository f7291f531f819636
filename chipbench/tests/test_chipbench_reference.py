"""The plain reference against the port at small sizes on the CPU, in
float32: the same weights, the same inputs, the same logits."""
import pytest
import torch

from chipbench import harness, spec, weights
from chipbench.reference import Reference, capacity_keep
from chipbench.tests.support import tiny


def _program(cfg):
    from repro_torch.models import bundle

    return bundle(spec.arch_config(cfg))


def test_dense_with_image_matches_the_port():
    cfg = tiny("pixtral-12b.code").config
    params = weights.make(cfg, 11, "cpu")
    img = weights.images(cfg, 11, 1, "cpu")
    tok = torch.randint(1, cfg["vocab_size"], (1, 40), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, _, _ = _program(cfg).model.forward(params, {"tokens": tok, "patch_embeds": img})
        got, gap = Reference(cfg, params).logits(tok[0].tolist(), range(40), img[0])
    assert gap == 0.0
    torch.testing.assert_close(got, want[0], rtol=1e-4, atol=1e-4)


def test_moe_with_the_programs_routing_matches_the_port():
    cfg = tiny("mixtral-8x7b-l16.conversation").config
    params = weights.make(cfg, 12, "cpu")
    tok = torch.randint(1, cfg["vocab_size"], (1, 64), generator=torch.Generator().manual_seed(1))
    routes = harness.Routes()
    routes.install()
    try:
        with torch.no_grad():
            want, _, _ = _program(cfg).model.forward(params, {"tokens": tok})
    finally:
        routes.remove()
    calls = routes.take()
    assert len(calls) == cfg["n_layers"]
    r = [(s, capacity_keep(s, cfg["n_experts"], cfg["capacity_factor"])) for s in calls]
    with torch.no_grad():
        got, gap = Reference(cfg, params).logits(tok[0].tolist(), range(64), None, r)
    assert gap < 1e-4
    torch.testing.assert_close(got, want[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tokens", [32, 64, 2048, 4096])
def test_capacity_drops_match_the_dispatch(tokens):
    """A router that sends every token to expert 0 first overflows it: the
    reference's drops, worked out from the selection alone, give the
    program's layer output (groups of 1024 above 1024 tokens)."""
    from repro_torch.models import moe

    cfg = dict(tiny("mixtral-8x7b-l16.conversation").config, d_model=16, d_ff=32)
    d, e = cfg["d_model"], cfg["n_experts"]
    g = torch.Generator().manual_seed(tokens)
    p = {"router": torch.randn(d, e, generator=g) * 0.02,
         "experts": {"w_gate": torch.randn(e, d, cfg["d_ff"], generator=g) * 0.25,
                     "w_up": torch.randn(e, d, cfg["d_ff"], generator=g) * 0.25,
                     "w_out": torch.randn(e, cfg["d_ff"], d, generator=g) * 0.2}}
    p["router"][:, 0] = 1.0
    x = torch.randn(1, tokens, d, generator=g).abs()
    arch = spec.arch_config(cfg)
    with torch.no_grad():
        want, _ = moe.apply_moe(p, x, arch)
        _, sel, _ = moe._route(p, x[0], arch)
    keep = capacity_keep(sel, e, cfg["capacity_factor"])
    assert not keep.all()  # drops happened
    ref = Reference(cfg, {"groups": [{"moe": {"router": p["router"][None],
                                               "experts": {k: v[None] for k, v in
                                                           p["experts"].items()}}}]})
    with torch.no_grad():
        got, gap = ref._moe(x[0], 0, (sel, keep))
    assert gap < 1e-5
    torch.testing.assert_close(got, want[0], rtol=1e-5, atol=1e-5)
