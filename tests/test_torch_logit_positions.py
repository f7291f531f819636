"""``Model.forward`` with a "logit_positions" entry: the final norm and the
f32 head run on the named rows alone, and their logits are those rows of the
full-logit forward; without the entry the forward returns (B, S, V) as the
reference does.  A dense GQA arch, an MoE arch, a VLM with patch embeddings
and an encoder-decoder with frames, each on a padded batch of two prompts
(f32, CPU, ``reduced()`` size, weights bridged from the reference)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config, reduced
from repro.models import bundle as jbundle
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_config as t_get_config, reduced as t_reduced
from repro_torch.models import bundle as tbundle, layers, transformer

ARCHS = ["smollm-135m", "mixtral-8x7b", "pixtral-12b", "seamless-m4t-large-v2"]
#: two prompts padded to one length: true lengths 11 and 6 of 16
S, LENS = 16, (11, 6)
#: the parity bound of the reference tests (f32, XLA vs ATen summation order)
TOL = dict(atol=1e-4, rtol=1e-4)


def _extras(cfg, b):
    rng = np.random.default_rng(7)
    shape = (b, cfg.frontend_len, cfg.frontend_dim)
    if cfg.frontend == "vit":
        return {"patch_embeds": (rng.standard_normal(shape) * 0.1).astype(np.float32)}
    if cfg.enc_dec:
        return {"frames": (rng.standard_normal(shape) * 0.1).astype(np.float32)}
    return {}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(torch bundle, params, batch, the reference's full logits)."""
    name = request.param
    jmb = jbundle(reduced(get_config(name)))
    jparams = jmb.init(jax.random.key(0))
    tmb = tbundle(t_reduced(t_get_config(name)))
    tparams = params_to_torch(jax.tree.map(np.asarray, jparams), tmb.cfg, device="cpu")
    toks = np.zeros((len(LENS), S), np.int64)
    rng = np.random.default_rng(3)
    for b, n in enumerate(LENS):
        toks[b, :n] = rng.integers(1, 255, size=n)
    ex = _extras(tmb.cfg, len(LENS))
    want, _, _ = jmb.model.forward(jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                                             **{k: jnp.asarray(v) for k, v in ex.items()}})
    batch = {"tokens": torch.from_numpy(toks), **{k: torch.from_numpy(v) for k, v in ex.items()}}
    return tmb, tparams, batch, np.asarray(want)


def _head_inputs(monkeypatch):
    """Records the shape of every ``layers.lm_logits`` input."""
    seen = []
    real = layers.lm_logits

    def spy(w, x, tied):
        seen.append(tuple(x.shape))
        return real(w, x, tied)

    monkeypatch.setattr(layers, "lm_logits", spy)
    return seen


@pytest.mark.parametrize("where", ["first", "middle", "last", "all three"])
def test_head_at_named_positions_gives_those_rows(arch, where, monkeypatch):
    mb, params, batch, want = arch
    b, d, v = len(LENS), mb.cfg.d_model, mb.cfg.vocab_size
    seen = _head_inputs(monkeypatch)
    with torch.no_grad():
        full, _, _ = mb.model.forward(params, batch)
    # without the entry: (B, S, V) over every position, the reference's logits
    assert full.dtype == torch.float32 and tuple(full.shape) == (b, S, v)
    assert seen == [(b, S, d)]
    np.testing.assert_allclose(full.numpy(), want, **TOL)
    picks = {"first": [[0]] * b, "middle": [[n // 2] for n in LENS],
             "last": [[n - 1] for n in LENS],
             "all three": [[0, n // 2, n - 1] for n in LENS]}[where]
    pos = torch.tensor(picks)
    with torch.no_grad():
        got, _, _ = mb.model.forward(params, {**batch, "logit_positions": pos})
    k = pos.shape[1]
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, k, v)
    assert seen[1:] == [(b, k, d)]
    rows = full[torch.arange(b)[:, None], pos].numpy()
    np.testing.assert_allclose(got.numpy(), rows, rtol=1e-5,
                               atol=1e-5 * float(np.abs(rows).max()))


def test_logit_positions_of_another_batch_are_refused(arch):
    mb, params, batch, _ = arch
    with pytest.raises(ValueError, match="logit_positions"):
        mb.model.forward(params, {**batch, "logit_positions": torch.tensor([[0]])})


def test_logit_positions_under_a_mesh_are_refused():
    """A DTensor trunk output (a one-rank fake group) is refused, never
    answered with the full logits."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", rank=0, world_size=1, store=FakeStore())
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.ones(2, S, 8), mesh, [Replicate()] * 2, src_data_rank=None)
        with pytest.raises(ValueError, match="under a mesh"):
            transformer._rows_at(x, torch.zeros(2, 1, dtype=torch.long))
    finally:
        dist.destroy_process_group()
