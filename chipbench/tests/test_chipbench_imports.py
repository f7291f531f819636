"""Nothing a run loads has the top-level name jax, jaxlib, flax or repro
(names compared whole: repro_torch is the program), and the reference
loads nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

_RUN = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from chipbench import runner
from chipbench.tests.support import tiny
res = runner.run_cell(tiny({name!r}), 5, 2.0, {traced}, "cpu", time.perf_counter())
print(json.dumps({{"correct": res["correct"],
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


@pytest.mark.parametrize("name,traced", [("pixtral-12b.code", False),
                                         ("mixtral-8x7b-l16.conversation", True)])
def test_a_run_loads_no_jax_and_no_reference_package(name, traced):
    code = _RUN.format(root=str(ROOT), src=str(ROOT / "src"), name=name, traced=traced)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert "repro_torch" in res["top"]
    assert not FORBIDDEN & set(res["top"])


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]\n"
            "import chipbench.reference\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not ({"repro_torch"} | FORBIDDEN) & top
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module and not n.level}
        assert names <= {"__future__", "math", "typing", "torch"}, (path.name, names)
