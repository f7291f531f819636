#!/usr/bin/env python3
"""Write the list of aten ops that this torch's DTensor can shard.

    python3 tools/dtensor_rules.py            # tests/data/dtensor_ops_torch-<major.minor>.txt
    python3 tools/dtensor_rules.py --out FILE

An op is listed when DTensor's op dispatcher holds a rule for it: a
strategy in the sharding propagator (``op_strategy_funcs``,
``op_single_dim_strategy_funcs`` where the version has it), a propagation
rule (``op_to_rules``) or a custom handler of the dispatcher
(``_custom_op_handlers``).  An op with none of these runs only through
the propagator's decomposition fallback, where its decomposition shards
(torch 2.11 cannot shard ``index_add_`` that way, 2.13 can), or fails.
``tests/test_torch_dtensor_rules.py`` holds every op that the port's
sharded cells dispatch on a DTensor to the list of the card host's torch,
so run this there and commit the file it writes.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sharded_ops() -> list:
    """Names (``aten.add.Tensor``) of every op this torch's DTensor has a
    rule for, sorted."""
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    prop = disp.sharding_propagator
    ops = set()
    for table in ("op_strategy_funcs", "op_single_dim_strategy_funcs", "op_to_rules"):
        ops.update(getattr(prop, table, None) or {})
    ops.update(getattr(disp, "_custom_op_handlers", None) or {})
    return sorted(str(op) for op in ops)


def main(argv=None) -> int:
    import torch

    major_minor = ".".join(torch.__version__.split("+")[0].split(".")[:2])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data",
                                                  f"dtensor_ops_torch-{major_minor}.txt"))
    args = ap.parse_args(argv)
    ops = sharded_ops()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"# ops with a DTensor rule in torch {torch.__version__} "
                f"(tools/dtensor_rules.py)\n")
        f.writelines(op + "\n" for op in ops)
    print(f"{len(ops)} ops -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
