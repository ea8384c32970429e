"""The GAT configuration's cell on a tiny graph (``gat-tt-tiny.eval``, which
``cells.make_root`` builds from ``BENCHMARK.json``), its control and faults,
the FLOP counts of ``reference/gat.py`` against a hand count at products,
and the byte count of ``csr_gat_bf16.roofline_share``."""

import json

import pytest

from gnnbench import flops, harness
from gnnbench.faults import FAULTS
from gnnbench.tests.cells import REPO, make_root

N, E = 2449029, 122449596
SEEDS = (3, 2**31 + 3)


def test_tiny_gat_eval_cell_is_correct(tmp_path):
    root = make_root(tmp_path)
    for seed in SEEDS:
        out = harness.run_cell(root, "gat-tt-tiny.eval", seed, 0.5, False, device="cpu")
        assert out["correct"] is True and out["failed"] == 0, (seed, out["checks"])
        assert out["attempted"] >= 1 and "eval_ms" in out["metrics"]
    # traced on the CPU: the new readers find no device record and read nothing
    out = harness.run_cell(root, "gat-tt-tiny.eval", 5, 0.0, True, device="cpu")
    assert out["correct"] is True
    assert not {"attend_ms", "csr_gat_bf16.roofline_share"} & set(out["metrics"])


@pytest.mark.parametrize("what", ["fp8", *FAULTS])
def test_control_and_faults_are_not_correct(tmp_path, what):
    root = make_root(tmp_path)
    kw = {"control": what} if what == "fp8" else {"fault": what}
    for seed in SEEDS:
        out = harness.run_cell(root, "gat-tt-tiny.eval", seed, 0.0, False, device="cpu", **kw)
        assert out["correct"] is False, (seed, out["checks"])


def products():
    config = json.loads((REPO / "gnnbench" / "configs" / "gat-tt-products.json").read_text())
    return config, harness.load_reference(config)


def test_flops_match_a_hand_count_at_products():
    """Eval: each layer's projection and skip over every row and its
    weighted sums over every edge and self-loop.  Train: the fan-out tree
    of 512 seeds at 10, 10, 10 (512, 5120, 51200, 512000 rows); layer l
    projects levels 0..3-l, skips and attends on levels 0..2-l; three times
    the forward."""
    config, ref = products()
    model = config["model"]
    ev = (2 * N * 100 * 512 * 2 + 2 * (E + N) * 512
          + 2 * N * 512 * 512 * 2 + 2 * (E + N) * 512
          + 2 * N * 512 * 188 + 2 * N * 512 * 47 + 2 * (E + N) * 188)
    assert ref.tower_eval_flops(model, N, E, 47, 100) == ev
    assert ev / 1e12 == pytest.approx(3.962, abs=1e-3)
    tr = (2 * 568832 * 100 * 512 + 2 * 56832 * 100 * 512 + 2 * (568320 + 56832) * 512
          + 2 * 56832 * 512 * 512 + 2 * 5632 * 512 * 512 + 2 * (56320 + 5632) * 512
          + 2 * 5632 * 512 * 188 + 2 * 512 * 512 * 47 + 2 * (5120 + 512) * 188)
    assert ref.tower_train_flops(model, 47, 100) == 3 * tr
    # eval_mfu's count adds the lookup of every row, as the SAGE cell's does
    runs = -(-N // 140)
    assert flops.eval_flops(config, ref, N, E, 47) == ev + 2 * (N * 1600 + runs * 6400)


def test_roofline_bytes_match_the_formula():
    """A hidden layer: 4 n D + 8 n H + 8 E + 8 (n + 1) bytes (x read and the
    heads written in bf16, D = H C = 512; el and er; the sources and row
    pointers), 1.82 ms at 3.35 TB/s, under its 2 (E + n) D f32 operations,
    1.91 ms at 67 TFLOP/s.  The last layer writes the head mean, n C
    values: 2 n D + 2 n C + ... bytes at D = 188, C = 47, 0.67 ms, under
    its 0.70 ms of operations."""
    mod = harness._load_module(harness.reader_path("metrics", "csr_gat_bf16.roofline_share"))
    hidden = 4 * N * 512 + 8 * N * 4 + 8 * E + 8 * (N + 1)
    assert hidden / flops.HBM_BYTES_PER_S * 1e3 == pytest.approx(1.819, abs=1e-3)
    ops = 2 * (E + N) * 512
    assert mod.bound_s(N, E, 4, 128, False) == flops.bound_s(hidden, ops)
    assert mod.bound_s(N, E, 4, 128, False) * 1e3 == pytest.approx(1.909, abs=1e-3)
    last = 2 * N * 188 + 2 * N * 47 + 8 * N * 4 + 8 * E + 8 * (N + 1)
    assert mod.bound_s(N, E, 4, 47, True) == flops.bound_s(last, 2 * (E + N) * 188)
    assert mod.bound_s(N, E, 4, 47, True) * 1e3 == pytest.approx(0.701, abs=1e-3)
    config, _ = products()
    assert mod.call_bound_s(config["model"], N, E, 47) == pytest.approx(
        2 * mod.bound_s(N, E, 4, 128, False) + mod.bound_s(N, E, 4, 47, True))


def test_reference_refuses_heads_that_differ():
    config, ref = products()
    config["trainer"]["num_heads"] = 8
    with pytest.raises(ValueError, match="heads"):
        ref.param_shapes(config, 100, 47)
