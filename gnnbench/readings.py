"""The readings that a cell's limits are set from, at the cell's own size:

    python3 gnnbench/readings.py --workload <name> --seeds 1-12 \
        --control-seeds 101-103 --faults half_batch,altered --fault-seeds 201-203

For each seed, one run of the cell with the shortest window (one epoch,
or one evaluate() call) and its numbers against the plain reference that
the cell's configuration names: the program's, the control's (that
reference in the precision below the configuration's, one of its
``CONTROLS``, put in the program's place) and those of each planted fault
(``gnnbench/faults.py``).  Any cell of ``BENCHMARK.json`` whose
configuration names a reference module serves.  Prints one JSON line per
run and writes them all to ``--out``.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seed_list(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="101-103")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="201-203")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from gnnbench import harness
    cell = harness.load_cell(ROOT, args.workload)
    control = cell.config["precision"]["control"]
    if control not in cell.ref.CONTROLS:
        raise harness.CellError(f"the control {control!r} is none of {sorted(cell.ref.CONTROLS)}")
    jobs = [("program", None, None, s) for s in seed_list(args.seeds)]
    jobs += [("control", None, control, s) for s in seed_list(args.control_seeds)]
    jobs += [(f, f, None, s) for f in filter(None, args.faults.split(","))
             for s in seed_list(args.fault_seeds)]
    lines = []
    for what, fault, ctl, seed in jobs:
        out = harness.run_cell(ROOT, args.workload, seed, 0.0, False,
                               fault=fault, control=ctl, numbers=True)
        line = {"workload": args.workload, "what": what, "seed": seed, "correct": out["correct"],
                "numbers": out["numbers"], "leaves": out["leaves"]}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(l) + "\n" for l in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
