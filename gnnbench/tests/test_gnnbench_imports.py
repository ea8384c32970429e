"""Nothing the harness loads is JAX or the JAX package, compared by whole
top-level names: the port's name begins with the JAX package's.  No file
of the benchmark outside ``reference/`` and ``tests/`` names a model's
module: it reaches the model through the configuration's reference."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
MODEL_MODULE = re.compile(r"\b(reference|models)(\.|\s+import\s+)sage\b")

SCRIPT = r"""
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import runpy
runpy.run_path(str(Path(sys.argv[1]) / "gnnbench" / "run.py"), run_name="not_main")
from gnnbench import harness, readings
from gnnbench.tests.cells import make_root
root = make_root(Path(sys.argv[2]), limits="loose")
for w in ("sage-tt-tiny.train", "sage-tt-tiny.eval"):
    harness.run_cell(root, w, 1, 0.0, True, device="cpu")
tops = sorted({m.split(".", 1)[0] for m in sys.modules})
assert "falcon_ttdforgnns_torch" in tops, tops
print("FORBIDDEN", harness.forbidden_modules())
"""


def test_no_jax_in_a_run(tmp_path):
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(REPO), str(tmp_path)],
                         capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_no_model_module_outside_reference_and_tests():
    assert MODEL_MODULE.search("from .reference import sage as ref")
    assert MODEL_MODULE.search("import falcon_ttdforgnns_torch.models.sage as sage_mod")
    pkg, hits = REPO / "gnnbench", []
    for top, dirs, files in os.walk(pkg):
        if Path(top) == pkg:
            dirs[:] = [d for d in dirs if d not in ("reference", "tests", "cache")]
        for f in files:
            if f.endswith((".py", ".sh")):
                path = Path(top) / f
                hits += [f"{path.relative_to(REPO)}:{i}: {line.strip()}"
                         for i, line in enumerate(path.read_text().splitlines(), 1)
                         if MODEL_MODULE.search(line)]
    assert hits == []
