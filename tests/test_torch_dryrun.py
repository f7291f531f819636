"""The dry-run (``launch/dryrun.py``) against the reference's, on the CPU:

  * ``ModelBundle.input_specs`` gives the reference's tree of shapes and
    dtypes for every arch x shape, ``model_flops`` its numbers exactly, and
    ``SHAPES`` and the training policy are the reference's;
  * every arch's ``reduced()`` cells (train, prefill, decode) run to "ok"
    on one rank and on a fake (2, 2) process group, book each kernel once
    per kernel layer and launch (twice under remat), count no less work
    over the ranks than on one, and leave the process-wide switches as they
    were;
  * smollm-135m at full width on the fake (16, 16) mesh: prefill_32k's and
    decode_32k's counted FLOPs x 256 are within 2% of the count written out
    term by term below, and long_500k is skipped with the reference's
    reason (train_4k takes minutes here: chip_smoke.py's phase 13 runs it).
"""
import dataclasses
import functools
import json
import os

import pytest

from repro.configs import SHAPES as JSHAPES, get_config as jget_config
from repro.models import bundle as jbundle
from repro_torch.configs import ARCHS, SHAPES, get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import cost
from repro_torch.launch import dryrun
from repro_torch.models import bundle, layers, transformer
from repro_torch.models import moe as moe_mod

import torch_dist_support as tds


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module, imported without its forced device
    count leaking into the rest of the process."""
    prev = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return mod


def _sig(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tds.paths(tree).items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_reference(arch):
    mb, jmb = bundle(get_config(arch)), jbundle(jget_config(arch))
    for name in SHAPES:
        got, want = mb.input_specs(SHAPES[name]), jmb.input_specs(JSHAPES[name])
        assert _sig(got) == _sig(want), name
        assert all(t.device.type == "meta" for t in tds.paths(got).values())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_match_reference(arch, jdry, monkeypatch):
    # each package counts an arch's parameters once, not once per shape
    for cls in (type(bundle(get_config(arch))), type(jbundle(jget_config(arch)))):
        monkeypatch.setattr(cls, "active_param_count",
                            functools.lru_cache(maxsize=None)(cls.active_param_count))
    assert SHAPES.keys() == JSHAPES.keys()
    for name in SHAPES:
        assert dryrun.model_flops(arch, name) == jdry.model_flops(arch, name), name


def test_policy_shapes_and_constants(jdry):
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    assert dryrun.TRAIN_POLICY == jdry.TRAIN_POLICY
    for arch in ARCHS:
        assert dryrun._policy(arch) == jdry._policy(arch)
    # the H100 SXM5 datasheet's, as chip_smoke.py takes them
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert dryrun.run_cell.__kwdefaults__["out_dir"] == "artifacts/dryrun_torch"


# ---------------------------------------------------------------------------
# the reduced cells
# ---------------------------------------------------------------------------
CELL_SHAPES = {"train": ShapeConfig("train_4k", 8, 16, "train", microbatch=16),
               "prefill": ShapeConfig("prefill_32k", 8, 4, "prefill"),
               "decode": ShapeConfig("decode_32k", 8, 4, "decode")}
MESHES = {"1": ((1, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model"))}


def expected_calls(cfg, kind: str) -> dict:
    """Kernel launches of one step of ``kind``: each kernel layer once, the
    blocks of the layer groups twice under the train step's remat (the
    shared attention block, the encoder-decoder trunk and the MTP block are
    not rematerialized)."""
    m = transformer.Model(cfg)
    attn = sum(n for k, n in m._groups() if k in ("attn", "moe"))
    mamba = sum(n for k, n in m._groups() if k == "mamba2")
    shared, mla = m.n_shared_apps, cfg.attention == "mla"
    if cfg.enc_dec:
        enc, dec = cfg.n_encoder_layers, cfg.n_layers
        return {"train": {"flash_attention": enc + 2 * dec},
                "prefill": {"flash_attention": enc + 2 * dec},
                "decode": {"decode_attention": dec, "flash_attention": dec}}[kind]
    calls = {"train": {"flash_attention": 2 * attn + shared + (1 if cfg.mtp_depth else 0),
                       "ssd_scan": 2 * mamba},
             "prefill": {"flash_attention": attn + shared, "ssd_scan": mamba},
             "decode": {"decode_attention": 0 if mla else attn + shared}}[kind]
    return {k: v for k, v in calls.items() if v}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_cells(arch):
    cfg = reduced(get_config(arch))
    before = (moe_mod.get_moe_impl(), transformer.remat_mode(), layers.kv_quant_enabled())
    flops = {}
    for mesh, mshape in MESHES.items():
        for kind, shape in CELL_SHAPES.items():
            cell = dryrun.run_cell(arch, shape.name, False, cfg=cfg, shape=shape,
                                   mesh_shape=mshape, out_dir=None)
            assert cell["status"] == "ok", cell.get("traceback")
            assert cell["n_devices"] == (4 if mesh == "2x2" else 1)
            assert {k: v["calls"] for k, v in cell["kernels"].items()} == \
                expected_calls(cfg, kind), (mesh, kind)
            pd = cell["per_device"]
            assert pd["flops"] > 0 and pd["hbm_bytes"] > 0 and pd["argument_bytes"] > 0
            assert pd["temp_bytes"] > 0 and pd["output_bytes"] > 0
            assert pd["kernel_interior_bytes"] == 0
            assert (pd["collective_bytes"] == {}) == (mesh == "1"), (mesh, kind)
            r = cell["roofline"]
            assert r["dominant"] == max(("compute_s", "memory_s", "collective_s"),
                                        key=r.get)
            flops[mesh, kind] = cell["hlo_flops_total"]
            assert (moe_mod.get_moe_impl(), transformer.remat_mode(),
                    layers.kv_quant_enabled()) == before
    for kind in CELL_SHAPES:
        assert flops["2x2", kind] >= flops["1", kind], kind


def test_int8_decode_cell_books_the_q8_kernel():
    cfg = reduced(get_config("smollm-135m"))
    cell = dryrun.run_cell("smollm-135m", "decode_32k", False, cfg=cfg, kv_quant=True,
                           shape=CELL_SHAPES["decode"], mesh_shape=MESHES["2x2"],
                           out_dir=None)
    assert cell["status"] == "ok" and cell["kv_quant"]
    assert {k: v["calls"] for k, v in cell["kernels"].items()} == \
        {"decode_attention_q8": cfg.n_layers}
    assert not layers.kv_quant_enabled()


# ---------------------------------------------------------------------------
# smollm-135m at full width on the fake (16, 16) mesh
# ---------------------------------------------------------------------------
def smollm_analytic_flops(shape: ShapeConfig, heads_replicated: int = 16) -> float:
    """The matmul FLOPs of one step of smollm-135m over all ranks, term by
    term: the Q, K, V, O and SwiGLU projections of 30 layers and the tied
    LM head, all sharded with no rank repeating another's work; attention
    at the kernel's pairs (the causal prefill's, or the whole cache at
    decode), done on every rank of ``model`` since 9 query heads and 3 KV
    heads do not divide 16 ranks."""
    cfg = get_config("smollm-135m")
    d, hd, f, v = cfg.d_model, cfg.head_dim_, cfg.d_ff, cfg.vocab_size
    hq, hkv, n = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    b, s = shape.global_batch, shape.seq_len
    tokens = b * (s if shape.kind == "prefill" else 1)
    proj = 2 * tokens * d * (hq * hd + 2 * hkv * hd + hq * hd + 3 * f)
    head = 2 * tokens * d * v
    if shape.kind == "prefill":
        attn = 2 * b * hq * cost.attention_pairs(s, s, True, None) * (hd + hd)
    else:
        attn = 2 * hq * b * s * (hd + hd)  # every row of the cache
    return n * proj + head + heads_replicated * n * attn


@pytest.mark.parametrize("name", ["prefill_32k", "decode_32k", "long_500k"])
def test_smollm_full_width_on_the_production_mesh(name, tmp_path):
    cell = dryrun.run_cell("smollm-135m", name, False, out_dir=str(tmp_path))
    art = json.loads((tmp_path / "pod16x16" / f"smollm-135m__{name}.json").read_text())
    assert art["status"] == cell["status"]
    if name == "long_500k":
        assert cell["status"] == "skipped"
        assert cell["reason"] == ("full-attention arch; long_500k needs sub-quadratic decode "
                                  "(DESIGN.md)")
        return
    assert cell["status"] == "ok", cell.get("traceback")
    assert cell["n_devices"] == 256 and cell["fsdp"] is False
    got = cell["per_device"]["flops"] * 256
    want = smollm_analytic_flops(SHAPES[name])
    assert abs(got / want - 1) < 0.02, (got, want)
    key = "flash_attention" if name == "prefill_32k" else "decode_attention"
    assert cell["kernels"][key]["calls"] == 30
    assert set(art) >= {"n_devices", "per_device", "model_flops", "hlo_flops_total",
                        "useful_ratio", "roofline", "count_s"}
    assert set(art["roofline"]) == {"compute_s", "memory_s", "collective_s", "memory_s_raw",
                                    "dominant"}


def test_heads_that_do_not_divide_the_model_axis():
    """6 query heads over 4 model ranks (smollm-135m's 9 over 16 at the
    production mesh): the attention output's merge takes its gradient back
    in its own placements, so the backward never splits a shard into
    heads."""
    cfg = reduced(get_config("smollm-135m"), n_heads=6, n_kv_heads=2)
    cell = dryrun.run_cell("smollm-135m", "train_4k", False, cfg=cfg, shape=CELL_SHAPES["train"],
                           mesh_shape=((1, 4), ("data", "model")), out_dir=None)
    assert cell["status"] == "ok", cell.get("traceback")
    assert cell["kernels"]["flash_attention"]["calls"] == expected_calls(cfg, "train")[
        "flash_attention"]
