"""A benchmark made of data files alone, in a temporary directory: the
real cells' configurations and traffic mixes shrunk to a graph of 20,000
nodes, with the harness's code read from the checkout.  Beside the cells
of ``BENCHMARK.json`` it holds the TT train cell, which ``BENCHMARK.json``
leaves out while its rate does not repeat (PERF.md section 7) and whose
limits, traffic and metric readers ``gnnbench/`` keeps for it."""

import json
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parents[2]
TINY = {"num_nodes": 20000, "avg_degree": 10, "num_classes": 8, "feat_dim": 16,
        "split_counts": [2000, 1000, 5000]}


# the TT train cell: its limits and per-layer metrics beyond the train cells'
KEPT = {"name": "sage-tt-products.train", "config": "sage-tt-products", "traffic": "train",
        "chips": 1, "why": "kept out of BENCHMARK.json; tested on a tiny graph"}
KEPT_METRICS = [{"name": n, "unit": "%", "better": "higher", "source": "device_trace",
                 "layer": "embedding", "moves": "train_seeds_per_s"}
                for n in ("tt_fwd.roofline_share", "tt_grads.roofline_share")]


def tiny(name: str) -> str:
    return name.replace("products", "tiny")


def make_root(tmp: Path, limits: str = "cell", noise_std: float = 0.05,
              reference: Optional[str] = None) -> Path:
    """``limits``: "cell" copies each real cell's limits; "loose" sets
    every limit wide, for tests of the drive alone.  ``reference``, where
    given, is the reference module every configuration names."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    add_kept(bench)
    (tmp / "gnnbench" / "configs").mkdir(parents=True)
    (tmp / "gnnbench" / "traffic").mkdir()
    (tmp / "gnnbench" / "limits").mkdir()
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        c["name"] = cfg["name"] = tiny(c["name"])
        c["file"] = tiny(c["file"])
        cfg["graph"].update(TINY)
        cfg["model"].update(hidden_dim=32, feat_dim=16, fanouts=[2, 3, 4], batch_size=64)
        if "tt" in cfg:
            cfg["tt"] = {"p_shapes": [25, 30, 30], "q_shapes": [4, 2, 2], "ranks": [4, 4]}
        if reference is not None:
            cfg["reference"] = reference
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        lim = json.loads((REPO / "gnnbench" / "limits" / f"{w['name']}.json").read_text())
        if limits == "loose":
            lim = {k: (0 if v == 0 else 10.0) for k, v in lim.items()}
        w["name"], w["config"] = tiny(w["name"]), tiny(w["config"])
        (tmp / "gnnbench" / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
        traffic = json.loads((REPO / "gnnbench" / "traffic" / f"{w['traffic']}.json").read_text())
        if "noise_std" in traffic:
            traffic.update(noise_std=noise_std, checked_call_range=[1, 1])
        (tmp / "gnnbench" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(traffic))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny(x) for x in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def add_kept(bench: dict) -> None:
    """The TT train cell, read by every train metric of the dense one but
    its update's, and by the TT kernels' rooflines."""
    bench["workloads"].append(dict(KEPT))
    for m in bench["end_to_end"] + bench["per_layer"]:
        w = m.get("workloads")
        if w is not None and "sage-dense-products.train" in w and m["name"] != "dense_update_ms":
            w.append(KEPT["name"])
    bench["per_layer"] += [dict(m, workloads=[KEPT["name"]]) for m in KEPT_METRICS]
