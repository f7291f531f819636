"""Train a ~100M-class model end to end with checkpoint/restart.  Twin of
the reference's ``examples/train_small.py`` on the port's launcher
(``repro_torch.launch.train``), so it exercises the path a real job uses:
deterministic data, grad accumulation, auto-resume, atomic checkpoints.

Reduced config (seconds on the CPU):
    PYTHONPATH=src python -m repro_torch.launch.train_small --device cpu

Full smollm-135m on the card:
    PYTHONPATH=src python -m repro_torch.launch.train_small --full --steps 300

Checkpoints go to ``build/train-small`` in the checkout (``--ckpt-dir``
moves them); a second run resumes from the last one.  Any other argument
is passed on to the launcher and overrides the defaults below.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.launch.train import main as train_main

#: ``<checkout>/build/train-small`` (build/ is listed in .gitignore)
CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train-small"


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    full = "--full" in argv
    argv = [a for a in argv if a != "--full"]
    base = ["--arch", "smollm-135m", "--ckpt-dir", str(CKPT_DIR), "--ckpt-every", "25"]
    if full:
        base += ["--steps", "300", "--batch", "16", "--seq", "512", "--microbatch", "4"]
    else:
        base += ["--reduced", "--steps", "60", "--batch", "8", "--seq", "128",
                 "--microbatch", "4"]
    return train_main(base + argv)


if __name__ == "__main__":
    raise SystemExit(main())
