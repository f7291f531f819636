"""Per-architecture smoke tests of the port, as ``tests/test_archs_smoke.py``
runs them on the reference: every architecture of ``configs.ARCHS`` at its
reduced config on the CPU with the port's own seeded weights -- forward
shape and finiteness, the loss, one gradient step that descends,
prefill/decode consistency, multi-step decode -- and, at full size on the
``meta`` device, parameter counts against the published sizes and the
reference, MoE active parameters and the long-context support table."""
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import bundle as jbundle
from repro_torch.configs import ARCHS, SHAPES, get_config, reduced
from repro_torch.models import bundle
from repro_torch.tree import tree_leaves, tree_unflatten

ARCH_NAMES = sorted(ARCHS)


def _batch(cfg, b=2, s=16, seed=0):
    """Seeded inputs, numpy-made: tokens, and a VLM's patch embeddings or an
    encoder-decoder's frames (b, frontend_len, frontend_dim) * 0.1."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s)))}
    shape = (b, cfg.frontend_len, cfg.frontend_dim)
    if cfg.frontend == "vit":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1)
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1)
    return batch


def _init(cfg, seed):
    mb = bundle(cfg)
    return mb, mb.init(torch.Generator().manual_seed(seed), device="cpu")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_shape_and_finite(name):
    cfg = reduced(get_config(name), capacity_factor=4.0)
    mb, params = _init(cfg, 1)
    logits, cache, aux = mb.model.forward(params, _batch(cfg))
    assert cache is None and aux.shape == () and aux.dtype == torch.float32
    assert logits.shape == (2, 16, cfg.vocab_size) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_and_loss(name):
    cfg = reduced(get_config(name), capacity_factor=4.0)
    mb, params = _init(cfg, 1)
    batch = _batch(cfg)
    logits, _, _ = mb.model.forward(params, batch)
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    loss, metrics = mb.loss_fn(params, batch)
    assert bool(torch.isfinite(loss)) and float(loss) > 0
    assert set(metrics) == {"ce", "aux"} | ({"mtp"} if cfg.mtp_depth else set())
    assert (float(metrics["aux"]) > 0) == bool(cfg.n_experts)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_train_grad_step(name):
    """One SGD step decreases the loss on a repeated tiny batch."""
    cfg = reduced(get_config(name), capacity_factor=4.0)
    mb, params = _init(cfg, 2)
    batch = _batch(cfg)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]

    def lf(ls):
        return mb.loss_fn(tree_unflatten(params, ls), batch)[0]

    l0 = lf(leaves)
    grads = torch.autograd.grad(l0, leaves)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    assert bool(torch.isfinite(gnorm)) and float(gnorm) > 0
    # descent-direction check: some step along -grad decreases the loss
    with torch.no_grad():
        for step in (0.5, 0.1, 0.02):
            moved = [p - step / gnorm * g.to(p.dtype) for p, g in zip(leaves, grads)]
            if float(lf(moved)) < float(l0):
                break
        else:
            raise AssertionError(f"no descent for {name} at any step size")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_decode_consistency(name):
    """decode(t_n) after prefill(t_0..n-1) == full forward at position n."""
    cfg = reduced(get_config(name), capacity_factor=8.0)
    mb, params = _init(cfg, 3)
    b, s = 2, 12
    batch = _batch(cfg, b, s, seed=4)
    full_logits, _, _ = mb.model.forward(params, batch)
    pre = {k: (v[:, : s - 1] if k == "tokens" else v) for k, v in batch.items()}
    _, cache = mb.prefill_fn(params, pre, max_len=s + 2)
    step_logits, _ = mb.decode_fn(params, cache, batch["tokens"][:, s - 1:], torch.tensor(s - 1))
    la = torch.log_softmax(full_logits[:, -1], -1)
    lb = torch.log_softmax(step_logits[:, 0], -1)
    assert bool(torch.isfinite(lb).all())
    diff = float((la - lb).abs().max())
    assert diff < 2e-2, f"{name}: prefill/decode mismatch {diff}"


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_multi_step_decode(name):
    cfg = reduced(get_config(name), capacity_factor=8.0)
    mb, params = _init(cfg, 5)
    b, s = 2, 8
    batch = _batch(cfg, b, s, seed=6)
    _, cache = mb.prefill_fn(params, batch, max_len=s + 4)
    tok = batch["tokens"][:, -1:]
    for i in range(3):
        logits, cache = mb.decode_fn(params, cache, tok, torch.tensor(s + i))
        assert bool(torch.isfinite(logits).all())
        tok = torch.argmax(logits, -1)


#: published sizes, as the reference's test holds them
PUBLISHED = {
    "mistral-large-123b": (123e9, 0.03),
    "nemotron-4-340b": (340e9, 0.03),
    "smollm-135m": (135e6, 0.05),
    "chatglm3-6b": (6.2e9, 0.10),
    "mixtral-8x7b": (46.7e9, 0.03),
    "deepseek-v3-671b": (671e9, 0.03),
    "pixtral-12b": (12.4e9, 0.05),
    "zamba2-1.2b": (1.2e9, 0.10),
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_param_count_matches_published(name):
    want, tol = PUBLISHED[name]
    got = bundle(get_config(name)).param_count()
    assert abs(got - want) / want < tol, f"{name}: {got / 1e9:.2f}B vs {want / 1e9:.2f}B"


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_count_equals_reference(name):
    mb = bundle(get_config(name))
    assert mb.param_count() == jbundle(j_get_config(name)).param_count()
    assert mb.active_param_count() == jbundle(j_get_config(name)).active_param_count()


def test_active_params_moe():
    mx = bundle(get_config("mixtral-8x7b"))
    assert abs(mx.active_param_count() - 12.9e9) / 12.9e9 < 0.05
    ds = bundle(get_config("deepseek-v3-671b"))
    assert abs(ds.active_param_count() - 37e9) / 37e9 < 0.10
    sm = bundle(get_config("smollm-135m"))
    assert sm.active_param_count() == sm.param_count()


def test_long_decode_support_table():
    """Exactly the recurrent archs and the sliding-window one support
    long_500k."""
    support = {n: bundle(c).supports_shape(SHAPES["long_500k"]) for n, c in ARCHS.items()}
    assert support == {
        "mistral-large-123b": False,
        "nemotron-4-340b": False,
        "smollm-135m": False,
        "chatglm3-6b": False,
        "mixtral-8x7b": True,
        "deepseek-v3-671b": False,
        "pixtral-12b": False,
        "seamless-m4t-large-v2": False,
        "xlstm-125m": True,
        "zamba2-1.2b": True,
    }
    assert all(bundle(c).supports_shape(SHAPES["decode_32k"]) for c in ARCHS.values())
