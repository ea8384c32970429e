"""The bound of csr_mean_f32.roofline_share at the products graph and
feat_dim (its reader computes it from flops.bound_s)."""

import pytest

from gnnbench import flops, harness

N, E = 2449029, 122449596


def test_csr_mean_f32_bound():
    """The f32 full-graph mean at products' feat_dim: 2.97 GB of compulsory
    bytes, 0.886 ms at 3.35 TB/s (its operations would take 0.19 ms at 67 TFLOP/s)."""
    mod = harness._load_module(harness.reader_path("metrics", "csr_mean_f32.roofline_share"))
    assert mod.bound_s(N, E, 100) * 1e3 == pytest.approx(0.8860, abs=5e-5)
    assert mod.bound_s(N, E, 100) == pytest.approx((8 * N * 100 + 8 * E + 8 * (N + 1) + 4 * N)
                                                   / flops.HBM_BYTES_PER_S)
