"""The comparison's control and planted faults (``perfbench/calibrate.py``):
the reference put in the program's place fails the cell's limits when it
computes below the configuration's precision (TF32 on: on the card only),
trains on half of each batch, or has an answer altered."""
import pytest

import calibrate
import tiny
from pbcore import check, runner

CELLS = ("gambia.bell_tiles", "pems08.fused", "gambia.dense", "pems08.dense")


@pytest.mark.parametrize("workload", CELLS)
def test_faults_fail_on_cpu(workload):
    cell = tiny.cell(workload)
    got = calibrate.readings(cell, 2 ** 31 + 3, "cpu")
    assert check.verdict(got["sound_reference"], cell["limits"])
    assert not check.verdict(got["half_batch"], cell["limits"])
    assert not check.verdict(got["altered"], cell["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_cell_size(workload, cuda_device):
    cell = runner.load_cell(workload)
    runner.set_tf32(cell["config"])
    got = calibrate.readings(cell, 2 ** 31 + 1234, cuda_device)
    assert not check.verdict(got["control"], cell["limits"]), got["control"]
    assert check.verdict(got["sound_reference"], cell["limits"])
