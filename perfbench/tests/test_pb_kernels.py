"""The kernel families of ``perfbench/kernels/`` against the program's
hand-written sources: every ``__global__`` function under the program's
``csrc/``, the ``.cuh`` headers included, is named in some family, so no
hand-written kernel's time is read as a PyTorch op's; and every name a
family lists is such a function."""
import json
import re
from pathlib import Path

import pytest

from pbcore.layers import csrc_kernels

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT.parent / "dstagnn_drought_tpu_torch" / "csrc"
# `__global__ void [__launch_bounds__(...)] name(`, the bounds' arguments
# holding at most one level of parentheses
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                    r"(\w+)\s*\(")


def global_functions() -> dict:
    """{name: source file} of every __global__ function under csrc/."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        for name in GLOBAL.findall(path.read_text()):
            out.setdefault(name, path.name)
    return out


def test_the_pattern_reads_launch_bounds():
    src = ("template <int K>\n__global__ void __launch_bounds__(kThreads, K <= 2 && "
           "sizeof(T) == 2 ? 2 : 1)\nk1_kernel(const float* a) {}\n"
           "__global__ void plain_kernel(int n) {}")
    assert GLOBAL.findall(src) == ["k1_kernel", "plain_kernel"]


def test_sources_are_there():
    found = global_functions()
    assert {"colsum_kernel", "atb_partial_kernel", "atb_wmma_partial_kernel"} <= set(found)
    assert {p.suffix for p in CSRC.iterdir() if p.name.endswith((".cu", ".cuh"))} == \
        {".cu", ".cuh"}


def test_every_global_function_is_in_a_family():
    missing = {n: f for n, f in global_functions().items() if n not in csrc_kernels()}
    assert not missing, missing


@pytest.mark.parametrize("family", sorted(p.stem for p in (ROOT / "kernels").glob("*.json")))
def test_every_listed_name_is_a_global_function(family):
    fam = json.loads((ROOT / "kernels" / f"{family}.json").read_text())
    names = fam["kernels"] + fam.get("shared", [])
    assert len(names) == len(set(names))
    assert set(names) <= set(global_functions()), set(names) - set(global_functions())
