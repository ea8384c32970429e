"""A cell that exists only as data files loads and runs its window's
drive, its metrics and its comparison on a tiny graph on the CPU."""

import json

import pytest

from gnnbench import harness
from gnnbench.tests.cells import make_root

CELLS = ["sage-tt-tiny.train", "sage-dense-tiny.train", "sage-tt-tiny.eval"]


@pytest.mark.parametrize("workload", CELLS)
def test_data_only_cell_runs_its_window(tmp_path, workload):
    root = make_root(tmp_path, limits="loose")
    out = harness.run_cell(root, workload, 2**31 + 17, 0.5, False, device="cpu")
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    bench = json.loads((root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload]) and not m["name"].startswith("peak_mem")}
    assert want <= set(out["metrics"])
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["device"]["count"] == 1
    assert (root / "gnnbench" / "cache").is_dir()


def test_same_seed_same_inputs(tmp_path):
    root = make_root(tmp_path, limits="loose")
    a = harness.run_cell(root, "sage-tt-tiny.train", 5, 0.0, False, device="cpu")
    b = harness.run_cell(root, "sage-tt-tiny.train", 5, 0.0, False, device="cpu")
    assert a["checks"] == b["checks"]
