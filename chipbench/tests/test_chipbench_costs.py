"""The frozen kernel work counts equal the program's at the cells' shapes."""
import pytest
import torch

from chipbench import cost, spec
from chipbench.tests.support import CELLS


def _meta(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


@pytest.mark.parametrize("name", CELLS)
def test_frozen_copy_equals_the_program(name):
    from repro_torch.kernels import cost as program

    cell = spec.load_cell(name)
    c, mix = cell.config, cell.traffic
    h, kv, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    window = c.get("sliding_window")
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    bucket = 1 << (lo - 1).bit_length()
    while bucket // 2 < hi:
        q, k = _meta(1, bucket, h, hd), _meta(1, bucket, kv, hd)
        assert cost.flash_attention(q, k, k, True, window) == program.flash_attention(
            q, k, k, True, window)
        bucket *= 2
    slots, smax = mix["slots"], min(mix["max_len"], window or mix["max_len"])
    q, k = _meta(slots, 1, h, hd), _meta(slots, smax, kv, hd)
    lengths = [1 + (i * 977) % (smax + 50) for i in range(slots)]
    assert cost.decode_attention(q, k, k, lengths) == program.decode_attention(q, k, k, lengths)
    assert cost.decode_attention(q, k, k) == program.decode_attention(q, k, k)
