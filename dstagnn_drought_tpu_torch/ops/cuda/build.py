"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). Libraries go to ``<repo>/build/kernels/``, named by
a digest of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source rebuilds and an unchanged one is reused. Nothing is built at import time: ``load`` builds on
first use, and ``build`` compiles several sources at once, one ``nvcc``
process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("cheb_sat", "bell_fused", "bell_bwd", "tat_fused", "block_spatial_fused",
           "gtu_fused")
# -split-compile=0: the device code's optimisation runs on every core, which
# matters for gtu_fused's 60 kernel instantiations (about 50 s against 110 s
# in one thread on the H100's host)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-split-compile=0",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
            "kernels build only on a machine with the CUDA toolkit"
        )
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a digest of its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, in parallel.

    Returns {name: {"seconds": wall time, "log": ptxas report or ""}}; a
    failed compile raises with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, lib)
    report = {name: {"seconds": 0.0, "log": ""} for name in names}
    failures = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, lib)
        lib.with_suffix(".log").write_text(log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
