"""The static cost analysis (``distribution/cost_analysis.py``) and the
kernels' ``meta`` routes (``kernels/cost.py``), on the CPU:

  * one matmul and a chain of two, counted on ``meta`` tensors, give
    exactly the FLOPs (and, in f32, the bytes) of the reference's
    ``hlo_analysis.analyze`` over the compiled HLO of the same function;
  * reusing a meta op's outputs for a signature seen before changes no
    count (reduced xLSTM's cells, with every meta kernel run instead);
  * on a fake (2, 2) process group, a column-parallel, a row-parallel and a
    replicated linear counted under DTensor equal the same rank's explicit
    local computation on plain ``meta`` tensors (the row-parallel one with
    its all-reduce), exactly;
  * each kernel's ``meta`` route returns the kernel's output shapes and
    dtypes, books its ``kernels.cost`` work and launches nothing; the
    booked FLOPs of a non-causal flash equal ``FlopCounterMode``'s count of
    ``ref.attention_ref``, and the SSD's and decodes' FLOPs and bytes equal
    ``chip_smoke.py``'s expressions, written out here; the CPU route still
    returns the plain version's values;
  * ``kernels.cost`` reproduces the ``bound_ms`` of PERF.md's kernel table
    where its shapes are fully given;
  * the gloo (2, 2) mesh: prefill and a decode step with the cache placed by
    ``cache_specs`` (its sequence sharded) and the decode kernel reached
    through ``local_map``, against the unsharded plain run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.distribution.hlo_analysis import analyze
from repro_torch.distribution.cost_analysis import CostCounter, local_bytes
from repro_torch.kernels import cost, ops, ref

import torch_dist_support as tds

META = torch.device("meta")
HBM, BF16_PEAK = 3.35e12, 989e12  # chip_smoke.py's HBM_BYTES_PER_S, BF16_FLOPS
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _m(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# counting semantics against the reference's analyzer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chain", [False, True])
def test_matmuls_count_as_the_references_analyze(chain, dtype):
    shapes = [(64, 128), (128, 256)] + ([(256, 32)] if chain else [])

    def f(*xs):
        y = xs[0] @ xs[1]
        return y @ xs[2] if chain else y

    hlo = jax.jit(f).lower(*(jax.ShapeDtypeStruct(s, _JDT[dtype]) for s in shapes))
    want = analyze(hlo.compile().as_text())
    with CostCounter() as c:
        f(*(_m(*s, dtype=dtype) for s in shapes))
    assert c.totals.flops == want.flops
    if dtype == torch.float32:  # XLA's CPU backend adds converts around bf16 dots
        assert c.totals.bytes == want.bytes
    assert c.totals.collective_bytes == {} and c.totals.kernel_bytes == 0


def test_bytes_rules():
    """Views move nothing, an expanded operand is read once, copy_ into a
    slice reads its source and writes the region, a gather reads the rows it
    fetches, an in-place scatter reads and writes the rows it updates."""
    table, tok = _m(1000, 64), torch.empty((4, 8), dtype=torch.int64, device=META)
    cache, rows = _m(2, 512, 4, 16), _m(2, 8, 4, 16)
    pos = torch.empty((8,), dtype=torch.int64, device=META)
    with CostCounter() as c:
        table.t().reshape(64, 1000).transpose(0, 1)[:10].unsqueeze(0).detach()
    assert c.totals.bytes == 0
    with CostCounter() as c:
        table[:1].expand(1000, 64) + table
    assert c.totals.bytes == 64 * 2 + 1000 * 64 * 2 * 2
    with CostCounter() as c:
        cache[:, 8:16].copy_(rows)
    assert c.totals.bytes == 2 * rows.numel() * 2
    with CostCounter() as c:
        table[tok]
    assert c.totals.bytes == 2 * (32 * 64 * 2) + 32 * 8
    with CostCounter() as c:
        cache.index_copy_(1, pos, rows)
    assert c.totals.bytes == 2 * rows.numel() * 2 + 8 * 8
    assert c.temp_bytes == 0  # in place: no new storage


def test_memory_peak_follows_lifetimes():
    x = _m(1024, 1024, dtype=torch.float32)  # 4 MiB
    with CostCounter() as c:
        c.track_arguments(x)
        a = x * 2
        b = a * 2
        del a
        d = b + 1
        del b, d
        e = x.clone()
    assert c.argument_bytes == 4 << 20
    assert c.temp_bytes == 2 * (4 << 20)  # a and b, or b and d, live at once
    assert c.live_bytes == 4 << 20  # e
    del e


class _EveryKernel(CostCounter):
    """The counter with every meta kernel run (no output reused)."""

    def __init__(self):
        super().__init__()
        self._meta_outputs = None


def test_reused_meta_outputs_leave_other_tensors_alone():
    """Only an op on meta tensors reuses outputs: a factory op (whose device
    is an argument) and an op on host tensors run each time."""
    with CostCounter():
        for _ in range(2):
            t = torch.arange(3) + 1
            assert t.device.type == "cpu" and t.tolist() == [1, 2, 3]
        m = _m(4, dtype=torch.float32)
        a, b = m * 2, m * 2
        assert a.device.type == b.device.type == "meta" and a.shape == b.shape == (4,)
        assert a.untyped_storage()._cdata != b.untyped_storage()._cdata


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_reused_meta_outputs_count_as_the_meta_kernels(kind, monkeypatch):
    """Reduced xLSTM's cell on the fake (2, 2) group (the sLSTM's time loop
    repeats each op's signature), counted with the meta outputs reused and
    with every meta kernel run: the same FLOPs, bytes, collectives, booked
    kernels and memory."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    shape = {"train": ShapeConfig("train_4k", 8, 16, "train", microbatch=16),
             "decode": ShapeConfig("decode_32k", 8, 4, "decode")}[kind]
    cells = []
    for counter in (CostCounter, _EveryKernel):
        monkeypatch.setattr(dryrun, "CostCounter", counter)
        cells.append(dryrun.run_cell("xlstm-125m", shape.name, False,
                                     cfg=reduced(get_config("xlstm-125m")), shape=shape,
                                     mesh_shape=((2, 2), ("data", "model")), out_dir=None))
    assert cells[0]["status"] == cells[1]["status"] == "ok"
    for key in ("per_device", "kernels", "hlo_flops_total", "roofline"):
        assert cells[0][key] == cells[1][key], key


# ---------------------------------------------------------------------------
# per rank under DTensor, on a fake process group
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_2x2():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
    try:
        yield init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["column", "row", "replicated"])
def test_dtensor_counts_are_the_local_computation(kind, fake_2x2):
    from torch.distributed._functional_collectives import all_reduce, wait_tensor
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = fake_2x2
    x_pl, w_pl = {"column": ((Shard(0), Replicate()), (Replicate(), Shard(1))),
                  "row": ((Shard(0), Shard(1)), (Replicate(), Shard(0))),
                  "replicated": ((Replicate(), Replicate()), (Replicate(), Replicate()))}[kind]
    x = distribute_tensor(_m(16, 64), mesh, x_pl, src_data_rank=None)
    w = distribute_tensor(_m(64, 128), mesh, w_pl, src_data_rank=None)
    with CostCounter() as got:
        got.track_arguments(x, w)
        y = x @ w
        if kind == "row":  # the partial sums over ``model`` reduced
            y = y.redistribute(mesh, (Shard(0), Replicate()))
    assert y.placements == {"column": (Shard(0), Shard(1)), "row": (Shard(0), Replicate()),
                            "replicated": (Replicate(), Replicate())}[kind]
    xl, wl = x.to_local(), w.to_local()
    with CostCounter() as want:
        want.track_arguments(xl, wl)
        yl = xl @ wl
        if kind == "row":
            yl = wait_tensor(all_reduce(yl, "sum", mesh.get_group("model")))
    assert got.totals == want.totals
    assert got.argument_bytes == want.argument_bytes == local_bytes((x, w))
    assert tuple(y.to_local().shape) == tuple(yl.shape)
    if kind == "row":
        assert got.totals.collective_bytes == {"all-reduce": 8 * 128 * 2}


# ---------------------------------------------------------------------------
# the kernels' meta routes
# ---------------------------------------------------------------------------
def _booked(fn, *args):
    seen = []
    before = ops.launch_counts()
    with cost.booking(lambda n, w: seen.append((n, w))):
        out = fn(*args)
    assert ops.launch_counts() == before  # a meta call launches nothing
    return out, seen


@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 48)])
def test_flash_meta_route(causal, window):
    q, k, v = _m(2, 96, 8, 64), _m(2, 128, 2, 64), _m(2, 128, 2, 32)
    out, seen = _booked(ops.flash_attention, q, k, v, causal, window)
    assert out.device == META and out.shape == (2, 96, 8, 32) and out.dtype == torch.bfloat16
    assert seen == [("flash_attention", cost.flash_attention(q, k, v, causal, window))]
    mask = ref._attention_mask(96, 128, causal, window, "cpu")
    pairs = int(mask.sum())
    assert seen[0][1] == (2 * 2 * 8 * pairs * (64 + 32),
                          (q.numel() + k.numel() + v.numel() + 2 * 96 * 8 * 32) * 2)
    if not causal:
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as fc:
            ref.attention_ref(q, k, v, causal, window)
        assert seen[0][1].flops == fc.get_total_flops()


def test_flash_meta_route_under_autograd_books_the_forward_and_counts_the_backward():
    q, k, v = (_m(1, 64, 4, 16, dtype=torch.float32).requires_grad_() for _ in range(3))
    with CostCounter() as c:
        out = ops.flash_attention(q, k, v)
        assert out.requires_grad
        torch.autograd.grad(out.sum(), (q, k, v))
    assert c.kernels["flash_attention"]["calls"] == 1
    # the plain backward's five (chunk x Sk) matmuls per chunk: scores, dV, dP, dQ, dK
    assert c.totals.flops == cost.flash_attention(q, k, v).flops + 5 * 2 * 4 * 64 * 64 * 16


def test_decode_meta_routes():
    b, smax, hq, hkv, d = 4, 256, 9, 3, 64
    q, k, v = _m(b, 1, hq, d), _m(b, smax, hkv, d), _m(b, smax, hkv, d)
    length = torch.empty((b,), dtype=torch.int32, device=META)
    out, seen = _booked(ops.decode_attention, q, k, v, length)
    assert out.shape == (b, 1, hq, d) and out.dtype == torch.bfloat16 and out.device == META
    rows = b * smax  # a meta length has no value: the whole cache
    # chip_smoke.py's time_decode: per_set and the operations it bounds
    assert seen == [("decode_attention", cost.Work(
        2 * hq * rows * (d + d), rows * hkv * (d + d) * 2 + 2 * b * hq * d * 2 + b * 4))]
    kq, ks = _m(b, smax, hkv, d, dtype=torch.int8), _m(b, smax, hkv, dtype=torch.float32)
    out, seen = _booked(ops.decode_attention_q8, q, kq, ks, kq, ks, length)
    assert out.shape == (b, 1, hq, d) and out.dtype == torch.bfloat16
    # phase 6's int8 entry: kv_bytes + q and out + the lengths
    assert seen == [("decode_attention_q8", cost.Work(
        2 * hq * rows * (d + d), rows * hkv * ((d + d) * 1 + 2 * 4) + 2 * b * hq * d * 2 + b * 4))]
    lens = [5, 300, 0, 100]  # data-dependent work where the caller knows the lengths
    assert cost.decode_attention(q, k, v, lens).flops == 2 * hq * (5 + 256 + 100) * 2 * d


@pytest.mark.parametrize("s,init", [(673, True), (64, False), (100, True)])
def test_ssd_meta_route(s, init):
    b, h, p, n = 2, 8, 32, 16
    x, dt = _m(b, s, h, p), _m(b, s, h, dtype=torch.float32)
    A, Bm = _m(h, dtype=torch.float32), _m(b, s, n)
    h0 = _m(b, h, p, n, dtype=torch.float32) if init else None
    (y, hT), seen = _booked(ops.ssd_scan, x, dt, A, Bm, Bm, h0)
    assert y.shape == x.shape and y.dtype == x.dtype and y.device == META
    assert hT.shape == (b, h, p, n) and hT.dtype == torch.float32
    # chip_smoke.py's time_ssd_case: pairs within each 64-step tile, flops, per_set
    pairs = sum(c * (c + 1) // 2 for c in [64] * (s // 64) + ([s % 64] if s % 64 else []))
    flops = b * (2 * pairs * n + h * (2 * pairs * p + 4 * s * p * n))
    nbytes = (b * s * h * p * 2 * 2 + b * s * h * 4 + h * 4 + b * s * n * 2 * 2
              + b * h * p * n * 4 * (2 if init else 1))
    assert seen == [("ssd_scan", cost.Work(flops, nbytes))]


def test_cpu_routes_still_run_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 16, 4, 8), generator=g) for _ in range(3))
    before = ops.launch_counts()
    seen = []
    with cost.booking(lambda n, w: seen.append(n)):
        torch.testing.assert_close(ops.flash_attention(q, k, v), ref.attention_ref(q, k, v),
                                   rtol=0, atol=0)
        torch.testing.assert_close(ops.decode_attention(q[:, :1], k, v, 9),
                                   ref.decode_attention_ref(q[:, :1], k, v, 9), rtol=0, atol=0)
        x, dt = torch.randn((1, 20, 4, 8), generator=g), torch.rand((1, 20, 4), generator=g)
        A, Bm = -torch.rand(4, generator=g), torch.randn((1, 20, 6), generator=g)
        for got, want in zip(ops.ssd_scan(x, dt, A, Bm, Bm), ref.ssd_scan_ref(x, dt, A, Bm, Bm)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert seen == [] and ops.launch_counts() == before


# ---------------------------------------------------------------------------
# kernels.cost against PERF.md's kernel table (bound_ms, H100 peaks)
# ---------------------------------------------------------------------------
def _bound_ms(work: cost.Work):
    t_bytes, t_ops = work.bytes / HBM * 1e3, work.flops / BF16_PEAK * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


@pytest.mark.parametrize("work,want", [
    (cost.flash_attention(_m(1, 1024, 9, 64), _m(1, 1024, 3, 64), _m(1, 1024, 3, 64), True),
     (0.00122, "operations")),
    (cost.flash_attention(_m(1, 673, 32, 64), _m(1, 673, 32, 64), _m(1, 673, 32, 64), True),
     (0.00329, "bytes")),
    (cost.ssd_scan(_m(1, 673, 32, 128), _m(1, 673, 32, dtype=torch.float32),
                   _m(32, dtype=torch.float32), _m(1, 673, 64), _m(1, 673, 64),
                   _m(1, 32, 128, 64, dtype=torch.float32)), (0.00399, "bytes")),
], ids=["flash-smollm-prefill", "flash-zamba2-prefill", "ssd-zamba2-prefill"])
def test_cost_reproduces_the_published_bounds(work, want):
    ms, by = _bound_ms(work)
    assert by == want[1] and round(ms, 5) == want[0]


def test_attention_pairs_closed_cases():
    assert cost.attention_pairs(1024, 1024, True, None) == 1024 * 1025 // 2
    assert cost.attention_pairs(256, 1024, False, None) == 256 * 1024
    assert cost.attention_pairs(1, 1024, True, None) == 1024  # a decode row sees every key
    assert cost.attention_pairs(100, 100, True, 10) == sum(min(i + 1, 10) for i in range(100))
    assert cost.ssd_pairs(673) == 10 * 64 * 65 // 2 + 33 * 34 // 2


# ---------------------------------------------------------------------------
# the sequence-sharded cache and the decode kernel through local_map
# ---------------------------------------------------------------------------
def test_sharded_prefill_and_decode_match_unsharded(tmp_path):
    tds.spawn(tds.sharded_decode_case, 4, tmp_path, str(tmp_path))
    got = np.load(tmp_path / "smollm-135m-sharded.npz")
    want = np.load(tmp_path / "smollm-135m-plain.npz")
    for key in want.files:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2e-5 * max(
            1.0, float(np.abs(want[key]).max())), err_msg=key)
