"""Model kinds (``chipbench/kinds``): every kind file keeps the contract the
harness calls, the ``gqa`` kind draws the trees it drew before it moved
there, and a new kind is a new file: a kind the repo does not have, written
to a temporary folder, runs a cell to ``correct`` with no benchmark file
edited."""
import ast
import dataclasses
import hashlib
import inspect
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import pytest
import torch

from chipbench import harness, kinds, runner, spec, weights
from chipbench.tests.support import CELLS, tiny

KIND_FILES = sorted(p.stem for p in kinds.DIR.glob("*.py") if p.stem != "__init__")

#: each entry's positional parameters, as the harness calls it
SIGNATURES = {
    "leaves": ["config"],
    "moe_layers": ["config"],
    "keep": ["sel", "config"],
    "route_gaps": ["judge", "chooser", "config"],
    "token_flops_but_attention": ["c"],
    "attention_flops": ["c", "position"],
    "prefill_flops": ["c", "prompt_len", "image"],
    "decode_flops": ["c", "positions"],
}


@pytest.mark.parametrize("kind", KIND_FILES)
def test_every_kind_keeps_the_contract(kind):
    mod = kinds.load(kind)
    for name, params in SIGNATURES.items():
        assert list(inspect.signature(getattr(mod, name)).parameters)[:len(params)] == params, name
    init = list(inspect.signature(mod.Reference).parameters)
    assert init[:3] == ["config", "params", "precision"]
    assert list(inspect.signature(mod.Reference.logits).parameters)[1:5] == [
        "tokens", "out_positions", "image", "routes"]
    # the plain reference is torch alone: nothing of the program, no JAX
    tree = ast.parse((kinds.DIR / f"{kind}.py").read_text())
    top = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
           for a in n.names}
    top |= {n.module.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.module and not n.level}
    assert top <= {"__future__", "math", "typing", "torch", "chipbench"}, top


def test_kinds_load_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [{root!r}]\n"
            "from chipbench import kinds\n"
            "for k in {names!r}: kinds.load(k)\n"
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))").format(
                root=str(spec.ROOT), names=KIND_FILES)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not {"repro_torch", "repro", "jax", "jaxlib", "flax"} & top


def test_the_kind_key_is_the_benchmarks_alone():
    """No field of the program's ``ArchConfig`` is named ``kind``, so
    ``spec.arch_config`` leaves it out; a file that names none is ``gqa``."""
    from repro_torch.configs.base import ArchConfig

    assert "kind" not in {f.name for f in dataclasses.fields(ArchConfig)}
    cfg = spec.load_cell(CELLS[0]).config
    assert "kind" not in cfg and kinds.of(cfg) is kinds.load("gqa")
    assert spec.arch_config(dict(cfg, kind="gqa")) == spec.arch_config(cfg)
    with pytest.raises(FileNotFoundError):
        kinds.load("no-such-kind")


def _digest(tree) -> str:
    h = hashlib.sha256()

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            h.update("/".join(path).encode())
            h.update(str(t.dtype).encode())
            h.update(repr(tuple(t.shape)).encode())
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())

    walk(tree, ())
    return h.hexdigest()


#: ``weights.make``'s tiny trees as drawn before the leaves moved into
#: ``kinds/gqa.py`` (every leaf's path, dtype, shape and bytes)
BEFORE = {
    ("pixtral-12b.code", 11): "7ab5162e5ab63c8065c07f42c034815560714d83729dbfcf28b6359fad2b72f8",
    ("pixtral-12b.code", 12): "c114ab6d5672c119317a0b0109c8abcff1f6c2616deed882334a8c81d4eb303b",
    ("mixtral-8x7b-l16.conversation", 11):
        "d27d7b4d30a9b6ceebf9a89743fd0a1d5a0cc68f926f26a7ef2c6abb11b5a2dd",
    ("mixtral-8x7b-l16.conversation", 12):
        "c82869820744834b07fdebf416ebdfe14ce4531c1d6e63b638211bde48fce5ab",
}


@pytest.mark.parametrize("name,seed", sorted(BEFORE))
def test_gqa_trees_are_drawn_as_before(name, seed):
    assert _digest(weights.make(tiny(name).config, seed, "cpu")) == BEFORE[(name, seed)]


#: a kind the repo does not have: a GQA MoE whose first ``n_dense_layers``
#: layers are dense (the program's ``layer_groups``: group 0 dense, group 1
#: MoE), which ``gqa`` does not draw
LEAD_DENSE = textwrap.dedent('''
    """GQA MoE with leading dense layers: gqa's pieces over two groups."""
    import torch

    from chipbench.kinds import gqa
    from chipbench.kinds.gqa import attention_flops, keep, route_gaps  # noqa: F401


    def _split(c):
        lead = c["n_dense_layers"]
        return dict(c, n_layers=lead, n_experts=0), dict(c, n_layers=c["n_layers"] - lead)


    def leaves(config):
        dense, moe = _split(config)
        out = [lf for lf in gqa.leaves(moe) if lf[0][0] != "groups"]
        for gi, c in enumerate((dense, moe)):
            out += [(("groups", str(gi)) + lf[0][2:],) + lf[1:]
                    for lf in gqa.leaves(c) if lf[0][0] == "groups"]
        return out


    def moe_layers(config):
        return config["n_layers"] - config["n_dense_layers"]


    def token_flops_but_attention(c):
        dense, moe = _split(c)
        head = 2 * c["d_model"] * c["vocab_size"]
        return (gqa.token_flops_but_attention(dense) + gqa.token_flops_but_attention(moe)
                - head)


    def prefill_flops(c, prompt_len, image=False):
        return (prompt_len * token_flops_but_attention(c)
                + sum(attention_flops(c, p) for p in range(prompt_len)))


    def decode_flops(c, positions):
        return sum(token_flops_but_attention(c) + attention_flops(c, p) for p in positions)


    class Reference(gqa.Reference):
        def __init__(self, config, params, precision="f32"):
            super().__init__(config, params, precision)
            self.full = params
            self.p = dict(params, groups=[params["groups"][1]])  # what gqa's _moe reads

        def logits(self, tokens, out_positions, image=None, routes=None):
            p, c = self.full, self.c
            dev = p["embedding"].device
            tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
            n = tok.numel()
            x = p["embedding"][tok].to(torch.float32)
            pos = torch.arange(n, device=dev)
            h, kv, hd = c["n_heads"], c["n_kv_heads"], self.hd
            lead = c["n_dense_layers"]
            gap, self.router_logits = 0.0, []
            for layer in range(c["n_layers"]):
                gi, li = (0, layer) if layer < lead else (1, layer - lead)
                g = p["groups"][gi]
                a = g["attn"]
                xn = self._norm(x, g["ln1"]["scale"][li])
                q = self._rope(self._mm(xn, self._w(a["wq"][li])).reshape(n, h, hd), pos)
                k = self._rope(self._mm(xn, self._w(a["wk"][li])).reshape(n, kv, hd), pos)
                v = self._mm(xn, self._w(a["wv"][li])).reshape(n, kv, hd)
                x = x + self._mm(self._attention(q, k, v), self._w(a["wo"][li]))
                xn = self._norm(x, g["ln2"]["scale"][li])
                if gi:
                    y, gl = self._moe(xn, li, routes[li])
                    gap = max(gap, gl)
                else:
                    m = g["mlp"]
                    y = self._swiglu(xn, self._w(m["w_gate"][li]), self._w(m["w_up"][li]),
                                     self._w(m["w_out"][li]))
                x = x + y
            out = torch.as_tensor(list(out_positions), dtype=torch.long, device=dev)
            xo = self._norm(x[out], p["ln_f"]["scale"])
            return self._mm(xo, self._w(p["lm_head"])), gap
''')

LEAD = "gqa_lead_dense"


def _lead_cell():
    """A tiny MoE cell of three layers, the first dense, that names the kind."""
    cell = tiny("mixtral-8x7b-l16.conversation")
    return dataclasses.replace(cell, config=dict(cell.config, kind=LEAD, n_layers=3,
                                                 n_dense_layers=1))


@pytest.fixture
def lead_dense(tmp_path, monkeypatch):
    """The kind above in a temporary folder, the loader pointed there (and
    there alone: no other kind loads), and the cell that names it."""
    (tmp_path / f"{LEAD}.py").write_text(LEAD_DENSE)
    monkeypatch.setattr(kinds, "DIR", tmp_path)
    monkeypatch.setitem(sys.modules, f"chipbench.kinds.{LEAD}", None)
    return _lead_cell()


def test_a_new_kind_is_a_new_file(lead_dense):
    from repro_torch.models import bundle

    c = lead_dense.config
    weights.check_layout(weights.make(c, 3, "cpu"), bundle(spec.arch_config(c)).param_shapes())
    res = runner.run_cell(lead_dense, 2 ** 31 + 21, 2.0, True, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["checks"]["route_gap"]["value"] < 1e-4
    assert res["attempted"] > 0 and res["failed"] == 0
    # the conversation cell reads the kind's FLOP counts under its closed-loop names
    assert {"prefill_mfu.closed_loop", "decode_mfu.closed_loop"} <= set(res["metrics"])
    assert runner.Context(c, None, None, 0.0).flops is kinds.load(LEAD)


def test_gqa_does_not_draw_a_leading_dense_layer():
    from repro_torch.models import bundle

    c = dict(_lead_cell().config, kind="gqa")
    with pytest.raises(ValueError, match="parameter layout differs"):
        weights.check_layout(weights.make(c, 3, "cpu"),
                             bundle(spec.arch_config(c)).param_shapes())


def _split_check(config, per):
    """A step of two prefills and a decode: its calls split by ``per``
    calls a forward; a step short of a forward's calls raises."""
    calls = [torch.full((1, 2), i) for i in range(3 * per)]
    routes = SimpleNamespace(take=lambda: list(calls))
    engine = SimpleNamespace(cfg=SimpleNamespace(max_slots=2))
    d = harness.Driver(engine, config, _lead_cell().traffic, None, None, routes=routes)
    d._split_routes(0, [4, 5], True)
    assert [int(t[0, 0]) for t in d.prefill_routes[5]] == list(range(per, 2 * per))
    assert [int(t[0, 0]) for t in d.decode_routes[0]] == list(range(2 * per, 3 * per))
    with pytest.raises(RuntimeError, match="routing calls in a step"):
        d._split_routes(1, [6], True)  # three forwards' calls for two


def test_the_driver_counts_gqa_routing_calls():
    c = dict(_lead_cell().config, kind="gqa")
    assert kinds.of(c).moe_layers(c) == 3
    _split_check(c, 3)


def test_the_driver_counts_routing_calls_by_the_kind(lead_dense):
    c = lead_dense.config
    assert kinds.of(c).moe_layers(c) == 2
    _split_check(c, 2)
