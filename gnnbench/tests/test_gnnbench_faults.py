"""With the timed path broken underneath, a run drives on and ``correct``
comes out false against the cell's own limits: each fault a cell can
have, and the control (the reference in the precision below the
configuration's, put in the program's place)."""

import pytest

from gnnbench import harness
from gnnbench.faults import FAULTS
from gnnbench.tests.cells import make_root

SEEDS = (3, 2**31 + 3)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", ["sage-tt-tiny.train", "sage-dense-tiny.train",
                                      "sage-tt-tiny.eval"])
def test_fault_is_not_correct(tmp_path, workload, fault):
    root = make_root(tmp_path)
    for seed in SEEDS:
        out = harness.run_cell(root, workload, seed, 0.0, False, device="cpu", fault=fault)
        assert out["correct"] is False, (seed, out["checks"])


@pytest.mark.parametrize("workload", ["sage-tt-tiny.train", "sage-dense-tiny.train",
                                      "sage-tt-tiny.eval"])
def test_control_is_not_correct(tmp_path, workload):
    root = make_root(tmp_path)
    control = harness.load_cell(root, workload).config["precision"]["control"]
    for seed in SEEDS:
        out = harness.run_cell(root, workload, seed, 0.0, False, device="cpu", control=control)
        assert out["correct"] is False, (seed, out["checks"])


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(tmp_path, cuda_device):
    root = make_root(tmp_path)
    out = harness.run_cell(root, "sage-tt-tiny.train", 7, 0.0, False, device=cuda_device,
                           control="fp8")
    assert out["correct"] is False, out["checks"]
