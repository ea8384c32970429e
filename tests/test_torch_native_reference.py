"""The parity tests' JAX reference stays native (tests/torch_jax_native.py).

The JAX package builds its native runtime in place on first import and,
if that import raises, samples and partitions with numpy for the rest of
the process.  Under ``pytest -n`` a worker can load the library while
another worker's compiler is writing it.  Here: six processes build and
load a copy of the runtime at once, racing an unlocked build of it, and
each loads version 1; a process whose JAX handles were lost gets them back
and then draws the port's native batches; the ``jax_native`` fixture's
check names a handle that is None.
"""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import torch_jax_native
from torch_jax_native import check_jax_native, ensure_jax_native, jax_native  # noqa: F401

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

import falcon_ttdforgnns_tpu.graph.reorder as jax_reorder
import falcon_ttdforgnns_tpu.graph.sampler as jax_sampler

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
PROCESSES = 6

RACER = textwrap.dedent("""
    import pathlib, sys, time
    sys.path.insert(0, {tests!r})
    import torch_jax_native
    go = pathlib.Path({go!r})
    while not go.exists():
        time.sleep(0.005)
    print(torch_jax_native.ensure_jax_native(pathlib.Path({csrc!r})))
""")


def copy_csrc(tmp_path, source=None):
    """A copy of the JAX package's csrc/ (its Makefile, and its source or
    ``source``), holding a half-written library newer than the source:
    what a load meets while an unlocked compiler writes."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    shutil.copy(torch_jax_native.JAX_CSRC / "Makefile", csrc / "Makefile")
    if source is None:
        shutil.copy(torch_jax_native.JAX_CSRC / "falcon_native.cpp", csrc / "falcon_native.cpp")
    else:
        (csrc / "falcon_native.cpp").write_text(source)
    (csrc / torch_jax_native.LIBRARY).write_bytes(b"\x7fELF" + bytes(60))
    return csrc


def test_six_processes_build_and_load_one_copy_at_once(tmp_path):
    """Six processes call ensure_jax_native on a copy of the JAX package's
    csrc/ at the same moment.  The copy holds a half-written library, and
    the package's own unlocked build (make, as graph/_native.py runs it)
    starts with them: the process holding the lock retries its load until
    that build has written a whole library, and every process loads
    version 1."""
    csrc = copy_csrc(tmp_path)
    assert torch_jax_native.lock_path(csrc) != torch_jax_native.lock_path(
        torch_jax_native.JAX_CSRC)
    go = tmp_path / "go"
    code = RACER.format(tests=str(TESTS), go=str(go), csrc=str(csrc))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(PROCESSES)]
    go.touch()
    unlocked = subprocess.Popen(["make", "-C", str(csrc), "-s", "-B"],
                                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        results = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
        unlocked.kill()
        unlocked.wait()
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err
        assert out.split() == ["1"]


VERSION_ONLY = 'extern "C" int falcon_native_version() { return 1; }\n'


def test_past_the_deadline_it_rebuilds_under_the_lock(tmp_path):
    """With no other build to wait for, a half-written library is rebuilt
    once the deadline has passed, and then loads."""
    csrc = copy_csrc(tmp_path, VERSION_ONLY)
    assert ensure_jax_native(csrc, deadline_s=0.0) == 1


def test_a_library_that_never_loads_raises(tmp_path):
    """A source that does not build: no fallback, a RuntimeError."""
    csrc = copy_csrc(tmp_path, "this is not C++\n")
    with pytest.raises(RuntimeError, match="neither builds nor loads"):
        ensure_jax_native(csrc, deadline_s=0.0)


LOST_RACE = textwrap.dedent("""
    import sys
    sys.path.insert(0, {tests!r})
    sys.path.insert(0, {repo!r})
    import numpy as np
    import falcon_ttdforgnns_tpu.graph as jax_graph
    import falcon_ttdforgnns_tpu.graph.reorder as jax_reorder
    import falcon_ttdforgnns_tpu.graph.sampler as jax_sampler
    from falcon_ttdforgnns_torch.graph import csr, sampler

    # what a lost race leaves: both handles None, no module in sys.modules
    jax_sampler._native = jax_reorder._native = None
    del sys.modules["falcon_ttdforgnns_tpu.graph._native"], jax_graph._native

    import torch_jax_native
    assert torch_jax_native.ensure_jax_native() == 1
    native = sys.modules["falcon_ttdforgnns_tpu.graph._native"]
    assert jax_sampler._native is native and jax_reorder._native is native
    assert torch_jax_native.ensure_jax_native() == 1 and jax_sampler._native is native

    ds = csr.hard_synthetic_dataset(num_nodes=3000, avg_degree=5, seed=4)
    args = (ds.graph, ds.train_idx, ds.labels, (3, 4), 100)

    def draws(module):
        return [b.all_nodes for _, b in zip(range(3), module.NeighborLoader(*args, seed=5))]

    ours, theirs = draws(sampler), draws(jax_sampler)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    # the numpy path draws other batches: the comparison above tells them apart
    jax_sampler._native = None
    assert any(not np.array_equal(a, b) for a, b in zip(ours, draws(jax_sampler)))
    print("native again")
""")


def test_a_lost_race_is_repaired_and_draws_the_ports_batches():
    """In a fresh process whose JAX handles are None and whose native module
    is gone (a lost build race), ensure_jax_native binds the module into
    both handles again, and a second call swaps nothing; the JAX loader's
    batches (sample_block_multi) are then the port's native draw for the
    same seed, and differ from the JAX numpy path's."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = LOST_RACE.format(tests=str(TESTS), repo=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["native", "again"]


@pytest.mark.parametrize("module", [jax_sampler, jax_reorder], ids=["sampler", "reorder"])
def test_the_fixture_names_a_numpy_reference(module, monkeypatch):
    """The jax_native fixture's check passes while both handles are native,
    and raises with its message once either is None."""
    check_jax_native()
    monkeypatch.setattr(module, "_native", None)
    with pytest.raises(AssertionError, match=rf"numpy path: {module.__name__}\._native is None"):
        check_jax_native()


def test_ensure_in_a_native_process_swaps_nothing(jax_native):
    """Once this process is native, a call loads nothing new into the
    handles and returns the version."""
    before = jax_sampler._native, jax_reorder._native
    assert ensure_jax_native() == 1
    assert (jax_sampler._native, jax_reorder._native) == before
    assert before[0] is sys.modules["falcon_ttdforgnns_tpu.graph._native"]
