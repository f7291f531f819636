"""Useful model FLOPs of both configurations against a count by hand."""
import pytest

from chipbench import flops, spec


def test_pixtral_by_hand():
    c = spec.load_cell("pixtral-12b.code").config
    # a layer: q 5120x4096, k and v 5120x1024 each, o 4096x5120; SwiGLU 3 x 5120x14336
    layer = 2 * (5120 * 4096 + 2 * 5120 * 1024 + 4096 * 5120) + 2 * 3 * 5120 * 14336
    head = 2 * 5120 * 131072
    assert flops.token_flops_but_attention(c) == 40 * layer + head == 23_152_558_080
    # attention at position p: 40 layers x 32 heads x (p + 1) keys x (QK + PV) 2 x 128 x 2
    assert flops.attention_flops(c, 999) == 40 * 32 * 1000 * 4 * 128
    prompt = 300
    want = prompt * (40 * layer + head) + sum(40 * 32 * (p + 1) * 4 * 128 for p in range(prompt))
    assert flops.prefill_flops(c, prompt) == want
    want += 256 * 2 * 1024 * 5120  # the image's patch projection
    assert flops.prefill_flops(c, prompt, image=True) == want
    assert flops.decode_flops(c, [10, 20]) == 2 * (40 * layer + head) + 40 * 32 * 32 * 4 * 128


def test_mixtral_by_hand():
    c = spec.load_cell("mixtral-8x7b-l16.conversation").config
    attn = 2 * (4096 * 4096 + 2 * 4096 * 1024 + 4096 * 4096)
    moe = 2 * 4096 * 8 + 2 * (2 * 3 * 4096 * 14336)  # router + 2 experts
    head = 2 * 4096 * 32000
    assert flops.token_flops_but_attention(c) == 16 * (attn + moe) + head == 12_879_659_008
    # the window (4096) caps the keys past it
    assert flops.attention_flops(c, 5000) == 16 * 32 * 4096 * 4 * 128
    assert flops.attention_flops(c, 100) == 16 * 32 * 101 * 4 * 128
    assert flops.prefill_flops(c, 10) == 10 * (16 * (attn + moe) + head) + sum(
        16 * 32 * (p + 1) * 4 * 128 for p in range(10))


@pytest.mark.parametrize("name", ["pixtral-12b.code", "mixtral-8x7b-l16.conversation"])
def test_active_parameters_as_the_program_counts_them(name):
    """2 FLOPs a parameter a token: the non-attention count equals twice the
    program's active parameters, less the embedding table (a lookup) and the
    image projection (counted per patch, not per token)."""
    from repro_torch.models import bundle

    cell = spec.load_cell(name)
    c = cell.config
    b = bundle(spec.arch_config(c))
    active = b.active_param_count() - c["vocab_size"] * c["d_model"]
    if c.get("frontend"):
        active -= c["frontend_dim"] * c["d_model"]
    norms = (2 * c["n_layers"] + 1) * c["d_model"]  # scales: no multiply-add
    assert flops.token_flops_but_attention(c) == 2 * (active - norms)
