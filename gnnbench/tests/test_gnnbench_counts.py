"""The yardstick's counts against the numbers PERF.md cites (the main
path's step 0 in chip_smoke.py's final run: 937,984 ids, 722,074
distinct, 17,494 prefix runs)."""

import pytest
import torch

from gnnbench import flops

TT = {"p_shapes": [125, 140, 140], "q_shapes": [5, 5, 4], "ranks": [16, 16]}
STEP0 = {"ids": 937984, "distinct": 722074, "prefix_runs": 17494}
CONFIG = {"model": {"num_layers": 3, "hidden_dim": 256, "feat_dim": 100, "fanouts": [5, 10, 15],
                    "batch_size": 1024}, "tt": TT}
N, E = 2449029, 122449596


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
    assert flops.level_sizes(1024, [5, 10, 15]) == [1024, 15360, 153600, 768000]
    tower = flops.sampled_tower_flops(CONFIG["model"], 47, 100)
    assert tower / 1e9 == pytest.approx(65.252, abs=1e-3)  # 3 x 21.75 forward
    step = flops.train_step_flops(CONFIG, 47, STEP0)
    assert (step - tower) / 1e9 == pytest.approx(2 * (1.2673 + 2.6465), abs=1e-3)
    assert flops.eval_flops(CONFIG, N, 47) / 1e12 == pytest.approx(1.01, abs=0.01)
