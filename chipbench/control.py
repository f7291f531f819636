"""The check's control, on the card: for each seed, one short run of a
cell at its own load, then the compared numbers of the program (sound
readings) and the gap of the token the fp8 control puts first at the same
positions (``control_gap``), all in one process.

    python3 chipbench/control.py --workload <name> --seconds 10 --seeds 1 2 3 ...

One JSON line per seed; the limits in ``cells/<name>.json`` were set from
these readings (PERF.md gives them).
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if p and Path(p).resolve() != HERE]
    import torch

    from chipbench import check, runner, spec

    if not torch.cuda.is_available():
        sys.exit("chipbench.control: no CUDA device")
    cell = spec.load_cell(args.workload)
    want = int(cell.traffic["check_requests"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        d = runner.drive(cell, seed, args.seconds, False, "cuda", t0)
        rids = check.sample(d.record, seed, want)
        t1 = time.perf_counter()
        values = check.readings(d.record, cell.config, d.params, d.images, d.stream, rids,
                                control=True)
        served = sum(len(d.record.requests[r].tokens) for r in rids)
        print(json.dumps({"workload": cell.name, "seed": seed, "judged": len(rids),
                          "served_tokens": served, "reference_s": time.perf_counter() - t1,
                          **values}), flush=True)
        del d
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
