"""Which of the port's tests reach the JAX package's native runtime, and
whether each asks for the ``jax_native`` fixture (tests/torch_jax_native.py).

    python scripts/audit_jax_native.py [pytest arguments]

runs pytest with this file as a plugin, by default over every
``tests/test_torch_*.py`` that imports ``falcon_ttdforgnns_tpu``, in 6
xdist workers.  In each process the plugin wraps the five functions of
``falcon_ttdforgnns_tpu.graph._native`` and records which test, or which
fixture's setup, called them.  At the end it prints every test that reaches
one, in its own body or through a fixture it requests, marked ``ok`` where
the test asks for ``jax_native`` and ``MISSING`` where it does not, and
exits 1 if any is missing.  A test that sets the JAX handles to None on
purpose never calls them and is not listed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
NATIVE = ("build_csr", "sample_neighbors", "sample_block_multi", "partition_kway",
          "rmat_edges")
_OUT = "AUDIT_JAX_NATIVE_DIR"

# --------------------------------------------------------------- the plugin

_caller: list = []  # the test or fixture running now, innermost last
_calls: dict = {}   # ("test" | "fixture", name) -> set of native functions


def _wrap_native() -> None:
    mod = sys.modules.get("falcon_ttdforgnns_tpu.graph._native")
    if mod is None or getattr(mod, "_audited", False):
        return

    def wrapped(fn, name):
        def call(*args, **kwargs):
            if _caller:
                _calls.setdefault(_caller[-1], set()).add(name)
            return fn(*args, **kwargs)
        return call

    for name in NATIVE:
        setattr(mod, name, wrapped(getattr(mod, name), name))
    mod._audited = True


def _fixture_key(fixturedef) -> str:
    """A fixture's name with the node that defines it: names repeat across
    test files."""
    return f"{fixturedef.baseid}::{fixturedef.argname}"


@pytest.hookimpl(hookwrapper=True)
def pytest_fixture_setup(fixturedef, request):
    _caller.append(("fixture", _fixture_key(fixturedef)))
    try:
        yield
    finally:
        _caller.pop()


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    _wrap_native()
    _caller.append(("test", item.nodeid))
    try:
        yield
    finally:
        _caller.pop()
    with open(Path(os.environ[_OUT]) / f"{os.getpid()}.jsonl", "a") as f:
        fixtures = [_fixture_key(defs[-1])
                    for defs in item._fixtureinfo.name2fixturedefs.values() if defs]
        f.write(json.dumps({"test": item.nodeid, "fixtures": fixtures,
                            "jax_native": "jax_native" in item.fixturenames}) + "\n")


def pytest_sessionfinish(session):
    with open(Path(os.environ[_OUT]) / f"{os.getpid()}.calls.jsonl", "a") as f:
        for (kind, name), fns in _calls.items():
            f.write(json.dumps({"kind": kind, "name": name, "calls": sorted(fns)}) + "\n")

# ----------------------------------------------------------------- the run


def _port_parity_files() -> list:
    return sorted(str(p.relative_to(REPO)) for p in (REPO / "tests").glob("test_torch_*.py")
                  if "falcon_ttdforgnns_tpu" in p.read_text())


def main(argv) -> int:
    args = argv or [*_port_parity_files(), "-q", "-m", "not slow", "-p", "no:cacheprovider",
                    "-p", "xdist", "-n", "6", "--dist", "loadfile"]
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, JAX_PLATFORMS="cpu", **{_OUT: out})
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(Path(__file__).parent),
                                                          env.get("PYTHONPATH")]))
        rc = subprocess.run([sys.executable, "-m", "pytest", *args, "-p", "audit_jax_native"],
                            cwd=REPO, env=env).returncode
        tests, test_calls, fixture_calls = {}, {}, {}
        for path in Path(out).glob("*.jsonl"):
            for line in path.read_text().splitlines():
                row = json.loads(line)
                if "fixtures" in row:
                    tests[row["test"]] = row
                else:
                    into = test_calls if row["kind"] == "test" else fixture_calls
                    into.setdefault(row["name"], set()).update(row["calls"])
    missing = 0
    for test, row in sorted(tests.items()):
        reached = set(test_calls.get(test, ()))
        for key in row["fixtures"]:
            reached |= fixture_calls.get(key, set())
        if reached:
            ok = row["jax_native"]
            missing += not ok
            print(f"{'ok' if ok else 'MISSING':8s}{test}  {sorted(reached)}")
    print(f"{len(tests)} tests run (pytest rc {rc}); {missing} reach the JAX native "
          "runtime without the jax_native fixture")
    return 1 if missing or rc else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
