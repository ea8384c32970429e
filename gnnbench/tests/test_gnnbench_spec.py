"""``BENCHMARK.json`` holds together: every metric finds its reader, every
per-layer metric's cells report the end-to-end metric it moves, and every
cell reports ``setup_s``, another end-to-end metric and a per-layer one."""

import json

import pytest

from gnnbench import harness
from gnnbench.tests.cells import KEPT_METRICS, REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", CELLS)


@pytest.mark.parametrize("kind,metric", [("end_to_end", m["name"]) for m in BENCH["end_to_end"]]
                         + [("metrics", m["name"]) for m in BENCH["per_layer"] + KEPT_METRICS])
def test_metric_has_a_reader(kind, metric):
    mod = harness._load_module(harness.reader_path(kind, metric))
    assert callable(mod.read)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_its_metrics_move(cell):
    e2e = {m["name"] for m in BENCH["end_to_end"] if reports(m, cell)}
    layer = [m for m in BENCH["per_layer"] if reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m["moves"] in e2e for m in layer), [m["name"] for m in layer]
    assert (REPO / "gnnbench" / "limits" / f"{cell}.json").is_file()
