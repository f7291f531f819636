"""Run one cell of BENCHMARK.json once and print its result line.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled run.  The last line of standard output
is one JSON object; the last lines of standard error give each compared
number beside its limit.  Exit 2: no card, too few cards, or no program
beside the benchmark; exit 3: the run loaded JAX or the JAX package.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}  # compared by whole top-level name


def _fail(code: int, msg: str) -> None:
    print(f"chipbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        _fail(2, f"no program: {ROOT / 'src' / 'repro_torch'} is missing")
    # the benchmark's modules by their package name only (its own folder,
    # put first by ``python3 chipbench/run.py``, would shadow stdlib names)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if p and Path(p).resolve() != HERE]

    from chipbench import runner, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        _fail(2, "no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        _fail(2, f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} present")
    torch.cuda.set_device(0)

    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)

    found = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if found:
        _fail(3, f"the run loaded {found}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
