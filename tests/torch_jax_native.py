"""The JAX reference's native host runtime, made certain for the port's
parity tests.

``falcon_ttdforgnns_tpu/graph/_native.py`` builds ``csrc/libfalcon_native.so``
in place on its first import and loads it; ``graph/sampler.py`` and
``graph/reorder.py`` set their handle ``_native`` to None for the rest of
the process if anything there raises.  Under ``pytest -n`` every worker
imports the package at once, so a worker can load a library that another
worker's compiler is still writing, and its JAX reference then samples and
partitions with numpy: a different reference from the port's native one.

:func:`ensure_jax_native` builds and loads that library under a file lock
that every process shares, retries a load that meets a half-written file,
and binds the JAX package's native module into those handles where they
are None.  It never falls back: after its deadline it raises.  The
``jax_native`` fixture fails a parity test by name if a handle is still
None.  Neither edits a file of the JAX package; the library is the
git-ignored product of that package's own Makefile.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import importlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest

JAX_CSRC = (Path(__file__).resolve().parent.parent / "falcon_ttdforgnns_tpu" / "csrc")
LIBRARY = "libfalcon_native.so"
SOURCE = "falcon_native.cpp"
# A load meets a half-written library only while another process's
# unlocked compiler runs (about 5 s); past this, rebuild under the lock.
DEADLINE_S = 90.0
RETRY_S = 0.25
_JAX_HANDLES = ("falcon_ttdforgnns_tpu.graph.sampler", "falcon_ttdforgnns_tpu.graph.reorder")


def lock_path(csrc: Path) -> Path:
    """The lock file of one ``csrc/`` directory, shared by every process
    that names the same absolute path."""
    key = hashlib.sha256(str(Path(csrc).resolve()).encode()).hexdigest()[:16]
    return Path(tempfile.gettempdir()) / f"falcon_native_{key}.lock"


def _make(csrc: Path, force: bool = False) -> None:
    """The JAX package's own build (``graph/_native.py:21-23``)."""
    cmd = ["make", "-C", str(csrc), "-s"] + (["-B"] if force else [])
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)


def _stale(csrc: Path) -> bool:
    so = csrc / LIBRARY
    return not so.exists() or so.stat().st_mtime < (csrc / SOURCE).stat().st_mtime


def _load(csrc: Path, bind: bool) -> int:
    """Build the library if it is missing or older than its source, load
    it, and, for the JAX package's own directory, import its module.
    Returns ``falcon_native_version()``."""
    if _stale(csrc):
        _make(csrc)
    lib = ctypes.CDLL(str(csrc / LIBRARY))
    lib.falcon_native_version.restype = ctypes.c_int
    version = lib.falcon_native_version()
    if bind:
        # a failed import leaves nothing in sys.modules: this one is fresh
        native = importlib.import_module("falcon_ttdforgnns_tpu.graph._native")
        for name in _JAX_HANDLES:
            module = importlib.import_module(name)
            if module._native is None:
                module._native = native
    return version


def ensure_jax_native(csrc: Path = JAX_CSRC, deadline_s: float = DEADLINE_S) -> int:
    """Leave this process with the native runtime of ``csrc`` loaded and
    return its version.

    Under an exclusive lock on :func:`lock_path`: build the library if it is
    missing or stale, load it, and retry a load that raises ``OSError`` (or
    a build that clashed with an unlocked one) until ``deadline_s``; then
    rebuild once and try again, and raise if that fails too.  For the JAX
    package's own ``csrc/`` (the default) this also imports
    ``falcon_ttdforgnns_tpu.graph._native`` and binds it into the sampler's
    and the reorder's ``_native`` where they are None; a handle already
    loaded is never swapped.  A copy elsewhere is only built and loaded.
    Idempotent: once the process is native it costs the lock and a load of
    a library already mapped."""
    csrc = Path(csrc).resolve()
    bind = csrc == JAX_CSRC.resolve()
    with open(lock_path(csrc), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        end = time.monotonic() + deadline_s
        while True:
            try:
                return _load(csrc, bind)
            except (OSError, subprocess.SubprocessError):
                if time.monotonic() > end:
                    break
                time.sleep(RETRY_S)
        try:
            _make(csrc, force=True)
            return _load(csrc, bind)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"the native runtime in {csrc} neither builds nor "
                               f"loads after {deadline_s:.0f} s and a rebuild") from e


def check_jax_native() -> None:
    """Raise unless both JAX handles hold the native module."""
    for name in _JAX_HANDLES:
        module = sys.modules.get(name)
        if module is None or module._native is None:
            raise AssertionError(
                f"the JAX reference took its numpy path: {name}._native is None "
                "(its native runtime failed to load; see tests/torch_jax_native.py)")


@pytest.fixture
def jax_native():
    """For a parity test whose JAX reference samples, partitions, builds a
    CSR or draws R-MAT edges natively: fail by name if it would not."""
    check_jax_native()
