"""No module that a run loads is JAX's or the JAX package's, compared by
whole top-level names; the frozen copies import nothing of the program."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

BANNED = {"jax", "jaxlib", "flax", "phylo_hmrf_tpu"}
FROZEN = ("synth.py", "reference.py", "judge.py", "roofline.py")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_import_nothing_banned():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                names = set(_imports(os.path.join(dirpath, f)))
                assert not names & BANNED, (f, names & BANNED)


def test_frozen_copies_import_nothing_of_the_program():
    for f in FROZEN:
        names = set(_imports(os.path.join(BENCH, f)))
        assert "phylo_hmrf_tpu_torch" not in names, f


def test_fresh_interpreter_loads_nothing_banned():
    code = f"""
import sys, os
sys.path[:0] = [{BENCH!r}, {ROOT!r}, os.path.join({BENCH!r}, "metrics")]
import harness, judge, reference, record, devtrace, control, synth, roofline
import phylo_hmrf_tpu_torch.models.hmrf, phylo_hmrf_tpu_torch.data.regions
import phylo_hmrf_tpu_torch.tree, phylo_hmrf_tpu_torch.ops.loops
for f in os.listdir(os.path.join({BENCH!r}, "metrics")):
    if f.endswith(".py"):
        __import__(f[:-3])
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert "phylo_hmrf_tpu_torch" in loaded
    assert not loaded & BANNED, loaded & BANNED
