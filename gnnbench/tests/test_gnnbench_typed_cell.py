"""A configuration that names ``"generator": "typed_schema"`` runs through
``harness.run_cell`` from data files alone: the tiny SAGE cells (SAGE
ignores the types) on MAG240M's schema cut to 21,974 nodes and 311,104
edges (under the tiny TT table's 22,500 rows), with the harness's code
untouched, trained and evaluated on the CPU."""

import json

import pytest

from gnnbench import harness
from gnnbench.tests.cells import REPO, make_root


def typed_root(tmp_path):
    """The tiny benchmark plus a configuration per SAGE one, its graph
    MAG240M's at 9e-5 of its counts, and a cell per tiny SAGE cell."""
    root = make_root(tmp_path, limits="loose")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    spec = json.loads((REPO / "gnnbench" / "graphs" / "mag240m.json").read_text())
    # splits of 1,800 / 900 / 4,500: an epoch holds more steps than the check repeats
    spec.update(scale=9e-5, feat_dim=16, split_counts=[20000000, 10000000, 50000000])
    for c in [c for c in bench["configs"] if c["name"].startswith("sage-")]:
        cfg = json.loads((root / c["file"]).read_text())
        name = c["name"].replace("-tiny", "-mag-tiny")
        cfg.update(name=name, graph=spec)
        file = f"gnnbench/configs/{name}.json"
        (root / file).write_text(json.dumps(cfg))
        bench["configs"].append(dict(c, name=name, file=file))
    for w in [w for w in bench["workloads"] if w["config"].startswith("sage-")]:
        name, config = (w[k].replace("-tiny", "-mag-tiny") for k in ("name", "config"))
        bench["workloads"].append(dict(w, name=name, config=config))
        (root / "gnnbench" / "limits" / f"{name}.json").write_text(
            (root / "gnnbench" / "limits" / f"{w['name']}.json").read_text())
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("workload", ["sage-dense-mag-tiny.train", "sage-tt-mag-tiny.train",
                                      "sage-tt-mag-tiny.eval"])
def test_a_typed_graph_cell_runs_from_data_alone(tmp_path, workload):
    root = typed_root(tmp_path)
    out = harness.run_cell(root, workload, 2**31 + 23, 0.3, False, device="cpu", numbers=True)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1, out["checks"]
    assert out["numbers"].get("tree_faults", 0.0) == 0.0
    assert "setup_s" in out["metrics"]
    cached = [p.name for p in (root / "gnnbench" / "cache").iterdir()]
    assert cached and all(n.startswith("typed_schema-") for n in cached)
