"""adam_f32.roofline_share: its bound at the dense cell's Adam group, and
what it reads from a profiled slice with and without the kernel's records."""

from types import SimpleNamespace

import pytest
import torch

from gnnbench import flops, harness
from gnnbench.profiling import Slice

TABLE = 2449029 * 100  # the --no-tt table of sage-dense-products
TOWER = 206895         # SAGE 3 x 256 at feat_dim 100 and 47 classes


def reader():
    return harness._load_module(harness.reader_path("metrics", "adam_f32.roofline_share"))


def test_adam_f32_bound():
    """28 bytes a value of the dense cell's 245,109,795: 6.86 GB, 2.049 ms
    at 3.35 TB/s."""
    assert reader().bound_s(TABLE + TOWER) * 1e3 == pytest.approx(2.0487, abs=5e-5)
    assert reader().bound_s(TABLE + TOWER) == 28 * (TABLE + TOWER) / flops.HBM_BYTES_PER_S


@pytest.mark.parametrize("records,want", [
    ([], None),
    ([("void (anonymous namespace)::adam_f32_kernel(TensorList)", 0.0, 2500.0),
      ("void (anonymous namespace)::adam_f32_kernel(TensorList)", 9000.0, 11500.0)], 81.947)],
    ids=["no-kernel", "two-steps"])
def test_adam_f32_share_reads_the_kernel_records(records, want):
    """Two steps of 2.5 ms each read 2.0487 / 2.5 of the bound; without
    the kernel's records (a program that lacks it) nothing."""
    mod = reader()
    ctx = SimpleNamespace(kind="train", steps=0)
    trainer = SimpleNamespace(opt_params=[torch.empty(0), torch.empty(0)])
    mod.install(trainer, ctx)
    assert ctx.adam_values == 0
    ctx.adam_values, ctx.steps = TABLE + TOWER, 2
    other = [("void at::native::vectorized_elementwise_kernel<4>(...)", 3000.0, 4000.0)]
    ctx.slice = Slice(wall_s=0.02, device=records + other, host=[])
    got = mod.read(ctx)
    assert got == (None if want is None else pytest.approx(want, abs=1e-3))
