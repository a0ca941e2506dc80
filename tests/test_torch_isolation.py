"""The port and chip_smoke.py import neither JAX nor the JAX package: checked
by importing them in a fresh interpreter and by scanning their imports."""
import ast
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dstagnn_drought_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "dstagnn_drought_tpu")


def _port_modules():
    names = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_importing_the_port_loads_no_jax():
    modules = _port_modules() + ["chip_smoke"]
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    for module in ("ops.cuda.cheb_sat", "ops.cuda.bell_fused", "ops.cuda.bell_bwd",
                   "ops.cuda.tat_fused", "ops.cuda.block_spatial_fused",
                   "ops.cuda.gtu_fused", "ops.block_sparse", "debug",
                   "training.profiling", "cli.evaluate", "data.legacy", "data.native",
                   "parallel", "parallel.mesh", "parallel.comm", "parallel.sharding",
                   "parallel.graph_partition", "parallel.bell_partition", "parallel.launch"):
        assert f"dstagnn_drought_tpu_torch.{module}" in loaded, module


def test_no_import_statement_names_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_every_kernel_source_is_built():
    """chip_smoke.py builds build.SOURCES: every csrc/*.cu is among them."""
    from dstagnn_drought_tpu_torch.ops.cuda import build

    sources = sorted(p.stem for p in (PORT / "csrc").glob("*.cu"))
    assert sources == sorted(build.SOURCES)
    assert {"bell_fused", "bell_bwd", "cheb_sat", "tat_fused", "block_spatial_fused",
            "gtu_fused"} <= set(sources)
