"""Run one cell of the benchmark once and print its result line.

    python3 gnnbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last: each
number compared beside its limit); the same checks end standard error.
Without a card, or with fewer cards than the cell asks for, it prints no
result and exits 3; if the process has loaded JAX or the JAX package once
the window has closed, it exits 4.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "gnnbench" / "cache"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # every compiler cache the process might write stays in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch
    from gnnbench import harness
    chips = harness.load_cell(ROOT, args.workload).cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gnnbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"gnnbench: the run loaded {bad}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
