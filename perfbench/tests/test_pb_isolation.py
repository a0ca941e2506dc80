"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the program's name begins with the JAX
package's), ``chip_smoke`` or ``benchmarks/``; the reference loads nothing
of the program either; without a card a run exits non-zero and prints no
result."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]          # perfbench/
REPO = ROOT.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dstagnn_drought_tpu", "chip_smoke", "benchmarks",
             "bench"}
PROGRAM = "dstagnn_drought_tpu_torch"


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_sources_import_nothing_forbidden():
    for path in ROOT.rglob("*.py"):
        assert not (_imports(path) & FORBIDDEN), path
    for path in (ROOT / "reference").rglob("*.py"):
        assert PROGRAM not in _imports(path), path


DRY = """
import importlib, json, sys, time
sys.path[:0] = [{perfbench!r}, {tests!r}, {repo!r}]
import run
from pbcore import check, data, layers, runner, shapes, state, trace
from reference import dstagnn_ref
for kind in ("metrics", "bounds", "signals", "graphs"):
    for f in sorted((layers.ROOT / kind).glob("*.py")):
        layers.module(kind, f.stem)
import tiny
rec = runner.execute(tiny.cell("gambia.bell_tiles"), 3, 0.0, False, "cpu", time.perf_counter(),
                     {{"flops_per_s": 1e15, "hbm_bytes_per_s": 3e12}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_nothing_forbidden():
    """Every module of the benchmark imported, and a whole run driven on the
    CPU, in a fresh process: no forbidden top-level name is loaded."""
    code = DRY.format(perfbench=str(ROOT), tests=str(ROOT / "tests"), repo=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PROGRAM in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_no_card_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "run.py"), "--workload", "gambia.dense",
                          "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=REPO,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout
