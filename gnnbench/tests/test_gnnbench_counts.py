"""The yardstick's counts against the numbers PERF.md cites (the main
path's step 0 in chip_smoke.py's final run: 937,984 ids, 722,074
distinct, 17,494 prefix runs), and the FLOPs that ``train_mfu`` and
``eval_mfu`` divide by against those the harness counted before the
tower's count moved into the configuration's reference module."""

import json

import pytest
import torch

from gnnbench import flops, harness
from gnnbench.tests.cells import REPO

TT = {"p_shapes": [125, 140, 140], "q_shapes": [5, 5, 4], "ranks": [16, 16]}
STEP0 = {"ids": 937984, "distinct": 722074, "prefix_runs": 17494}
CONFIG = {"reference": "gnnbench/reference/sage.py",
          "model": {"arch": "sage", "num_layers": 3, "hidden_dim": 256, "feat_dim": 100,
                    "fanouts": [5, 10, 15], "batch_size": 1024}, "tt": TT}
N, E = 2449029, 122449596
# train_step_flops at step 0's counts, at a mean of three steps' counts (as
# train_mfu averages them) and with none; eval_flops over the whole graph;
# as gnnbench/flops.py counted them before the tower's count moved
STEPS = [STEP0, {"ids": 937984, "distinct": 722074 + 1 / 3, "prefix_runs": 17494 + 2 / 3}, None]
PARENT = {"sage-tt-products": ([73079439104.0, 73079476437.33333, 65251835904.0],
                               1018706511488.0),
          "sage-dense-products": ([65251835904.0] * 3, 1010645695488.0)}


def test_level_and_chain_macs():
    assert flops.level_macs(TT["q_shapes"], TT["ranks"]) == (1600, 6400)
    assert flops.fwd_macs(TT["q_shapes"], TT["ranks"], 722074, 17494) / 1e9 == \
        pytest.approx(1.2673, abs=5e-5)
    assert flops.grads_macs(TT["q_shapes"], TT["ranks"], 722074, 17494) / 1e9 == \
        pytest.approx(2.6465, abs=5e-5)


def test_kernel_bounds():
    assert flops.tt_fwd_bound_s(TT, STEP0, 2) * 1e3 == pytest.approx(0.0574, abs=5e-5)
    assert flops.tt_grads_bound_s(TT, STEP0, 2) * 1e3 == pytest.approx(0.0790, abs=5e-5)
    assert flops.segment_mean_bound_s(N, E, 256) * 1e3 == pytest.approx(1.0498, abs=5e-5)


def test_id_counts():
    ids = torch.tensor([0, 0, 139, 140, 280, 281, 280], dtype=torch.int32)
    assert flops.id_counts(ids, 140) == {"ids": 7, "distinct": 5, "prefix_runs": 3}


def test_step_and_eval_flops():
    sage = harness.load_reference(CONFIG)
    assert flops.level_sizes(1024, [5, 10, 15]) == [1024, 15360, 153600, 768000]
    tower = sage.tower_train_flops(CONFIG["model"], 47, 100)
    assert tower / 1e9 == pytest.approx(65.252, abs=1e-3)  # 3 x 21.75 forward
    step = flops.train_step_flops(CONFIG, sage, 47, STEP0)
    assert (step - tower) / 1e9 == pytest.approx(2 * (1.2673 + 2.6465), abs=1e-3)
    assert flops.eval_flops(CONFIG, sage, N, E, 47) / 1e12 == pytest.approx(1.01, abs=0.01)


@pytest.mark.parametrize("name", sorted(PARENT))
def test_flops_equal_the_parents(name):
    config = json.loads((REPO / "gnnbench" / "configs" / f"{name}.json").read_text())
    ref = harness.load_reference(config)
    train, evaluate = PARENT[name]
    assert [flops.train_step_flops(config, ref, 47, c) for c in STEPS] == train
    assert flops.eval_flops(config, ref, N, E, 47) == evaluate
