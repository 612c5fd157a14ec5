#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,...
        [--control-seeds 7,8,9] [--seconds 3] [--out FILE]

In one process, for each seed a run of the cell (``harness.run``) with a
short window: the program's numbers, the lower readings.  For each control
seed also the control, the reference computed in bfloat16 in the program's
place (the upper readings), and a run for each of the driver's ``FAULTS``,
the timed path broken underneath.  One JSON line a run (seed, what ran,
``correct``, the numbers), to standard output and to ``--out``.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from perfbench import harness, spec  # noqa: E402


def _ints(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    ap.add_argument("--backend", default="cuda", help="cpu: a rehearsal")
    ap.add_argument("--root", default=str(spec.ROOT))
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, args.root)
    faults = spec.driver(cell.config).FAULTS
    runs = [(s, "program", {}) for s in _ints(args.seeds)]
    for s in _ints(args.control_seeds):
        runs.append((s, "control_bf16", {"control": torch.bfloat16}))
        runs += [(s, name, {"system_factory": f}) for name, f in faults.items()]
    out = open(args.out, "a") if args.out else None
    try:
        for seed, what, kw in runs:
            r = harness.run(args.workload, seed, args.seconds, False,
                            root=args.root, backend=args.backend, **kw)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "run": what, "correct": r["correct"],
                               "steps": r["attempted"],
                               **{k: v["value"] for k, v in r["check"].items()}})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    except harness.NoDevice as exc:
        print(f"control: {exc}", file=sys.stderr)
        return 2
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
