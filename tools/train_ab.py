"""Hold one checkout's training run against another's, step by step.

Runs ``repro_torch.launch.train.train`` with the same arguments from two
checkouts in turn (a, b, b, a), each in a fresh process with that
checkout's ``src`` first on the path, and reports whether the losses of
every run are bit for bit those of the first, and each run's median step
seconds (host clock; each step ends in the loss's sync).  Use it to show
that a change leaves the unsharded step as it was.

  python3 tools/train_ab.py --a /path/to/parent --b . -- \
      --arch smollm-135m --steps 100 --batch 8 --seq 512

Arguments after ``--`` go to the launcher (default: smollm-135m, 100 steps,
batch 8 x 512, on cuda).  On a CUDA device it first prints the card's name
and power limit (nvidia-smi).  Prints one JSON object as its last line;
exits 1 when the losses differ.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
        "from repro_torch.launch import train as t; "
        "r = t.train(t.parse_args(sys.argv[2:])); "
        "s = sorted(r['step_seconds'][1:]); "
        "print('RESULT ' + json.dumps({'losses': r['losses'], 'median_step_s': s[len(s) // 2]}))")
DEFAULT = ["--arch", "smollm-135m", "--steps", "100", "--batch", "8", "--seq", "512",
           "--log-every", "100"]


def run(checkout: str, args) -> dict:
    src = os.path.join(os.path.abspath(checkout), "src")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _RUN, src, *args], capture_output=True,
                         text=True, env=env, cwd=os.path.abspath(checkout), timeout=1800)
    if out.returncode not in (0, 1):  # the launcher exits 1 when the loss did not fall
        raise SystemExit(f"{checkout}: exit {out.returncode}\n{out.stderr[-3000:]}")
    line = next(x for x in out.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    extra = argv[argv.index("--") + 1:] if "--" in argv else DEFAULT
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", required=True, help="the first checkout (the parent)")
    ap.add_argument("--b", required=True, help="the second checkout (the change)")
    args = ap.parse_args(argv[:argv.index("--")] if "--" in argv else argv)
    if "--device" not in extra or extra[extra.index("--device") + 1] == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    order = [("a", args.a), ("b", args.b), ("b", args.b), ("a", args.a)]
    runs = []
    for side, path in order:
        r = run(path, extra)
        runs.append(dict(side=side, median_step_s=r["median_step_s"], losses=r["losses"]))
        print(f"{side}: median step {r['median_step_s']:.4f} s, last loss {r['losses'][-1]:.6f}",
              flush=True)
    first = runs[0]["losses"]
    equal = all(r["losses"] == first for r in runs)
    print(f"losses bit for bit equal across all runs: {equal}")
    print(json.dumps({"args": extra, "losses_equal": equal,
                      "runs": [{k: v for k, v in r.items() if k != "losses"} for r in runs],
                      "losses": first}))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
