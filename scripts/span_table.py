#!/usr/bin/env python3
"""The program's span table for one configuration and traffic mix of the
benchmark (``gnnbench/configs``, ``gnnbench/traffic``), on the card.

    python3 scripts/span_table.py --config sage-tt-products --traffic train \\
        --seed 5 --units 6 [--out FILE]

Builds the trainer as ``gnnbench/harness.py`` does (the configuration's
reference module from ``harness.load_cell``, the run's weights, the
traffic's warm-up), runs two more units untimed (train epochs, or
``evaluate()`` calls with the traffic's noise: the first calls of a process
run slow now and then), then ``--units`` units, tracing off, on, on, off,
... each timed on the host's clock to a synchronise, and prints one JSON
line: the card's name and power limit, each unit's seconds and tracing
state, and the span table of the traced units (``utils/metrics.py``
``span_stats``) a unit and, for train traffic, a step: calls, host ms
total and self, device ms total and self; and the host-read counters a
unit.  ``--out`` writes the line to FILE as well.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gnnbench import harness  # noqa: E402
from gnnbench.graph import load_graph  # noqa: E402

from falcon_ttdforgnns_torch.utils import metrics  # noqa: E402

FIELDS = ("host_ms", "host_self_ms", "device_ms", "device_self_ms")


def load(root: Path, config: str, traffic: str):
    """(configuration, traffic, reference module) of the cell of ``config``
    under ``traffic`` through ``harness.load_cell``, or, for a pair that
    ``BENCHMARK.json`` runs in no cell (the TT train traffic), the files and
    the configuration's reference through ``harness.load_reference``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        if (w["config"], w["traffic"]) == (config, traffic):
            cell = harness.load_cell(root, w["name"])
            return cell.config, cell.traffic, cell.ref
    cfg = json.loads((root / "gnnbench" / "configs" / f"{config}.json").read_text())
    tra = json.loads((root / "gnnbench" / "traffic" / f"{traffic}.json").read_text())
    return cfg, tra, harness.load_reference(cfg)


def build(root: Path, config: str, traffic: str, seed: int, device):
    """The trainer and the drive of a cell of ``config`` under ``traffic``,
    after the traffic's warm-up."""
    cfg, tra, ref = load(root, config, traffic)
    g = load_graph(cfg["graph"], root / "gnnbench" / "cache")
    ctx = SimpleNamespace(seed=seed, config=cfg, traffic=tra, ref=ref, deadline=float("inf"),
                          graph=g)
    drive = harness.DRIVES[tra["drive"]](ctx)
    weights = ref.make_weights(cfg, g.num_nodes, g.num_classes, seed, device)
    trainer = harness.build_trainer(harness.dataset_of(g, cfg["name"]), cfg, tra, seed,
                                    weights, device)
    drive.setup(trainer, weights)
    del weights
    harness.free_device(device)
    return trainer, drive


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def table(stats: dict, per: int) -> dict:
    return {name: {"calls": s["calls"] / per,
                   **{k: None if s[k] is None else s[k] / per for k in FIELDS}}
            for name, s in stats.items() if "calls" in s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--units", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("span_table: needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainer, drive = build(ROOT, args.config, args.traffic, args.seed, dev)
    step = "trainer.step" if drive.kind == "train" else "trainer.eval"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"config": args.config, "traffic": args.traffic, "seed": args.seed, "card": smi,
           "units": []}

    for _ in range(2):
        drive.unit(trainer)
    metrics.reset_spans()
    for i in range(args.units):
        on = i % 4 in (1, 2)
        metrics.set_tracing(on)
        out["units"].append({"tracing": on, "s": timed(lambda: drive.unit(trainer))})
        metrics.set_tracing(False)
    stats = metrics.span_stats()
    traced = sum(u["tracing"] for u in out["units"])
    if traced:
        out["per_unit"] = table(stats, traced)
        if drive.kind == "train":
            out["per_step"] = table(stats, stats[step]["calls"])
        out["counts_per_unit"] = {n: s["count"] / traced for n, s in stats.items()
                                  if "count" in s}
    for on in (False, True):
        s = sum(u["s"] for u in out["units"] if u["tracing"] == on)
        n = sum(u["tracing"] == on for u in out["units"])
        out[f"mean_s_tracing_{'on' if on else 'off'}"] = s / n if n else None

    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
