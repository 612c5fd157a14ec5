#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``mdapy_tpu_torch`` and a CUDA card.
The last line of standard output is the result (JSON: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``check``: each number compared with the plain
reference beside its limit); the last lines of standard error repeat those
numbers.  Exit codes: 0 a result; 2 no card, or fewer than the cell asks
for; 3 the process loaded JAX or the JAX package; other codes an error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process with few threads: the renderer's host work is numpy on one
# thread, and idle thread pools only contend with it for the shared cores
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T0)
    except harness.NoDevice as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2
    except harness.Forbidden as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
