#!/usr/bin/env python3
"""Readings that set a cell's limits: the control and the planted faults,
at the cell's own size, on the card. The benchmark's runs never run this.

    python3 perfbench/calibrate.py --workload <cell> --seeds <n,n,...>

For each seed it makes the cell's inputs and initial weights as a run does,
and puts the reference in the program's place, computed as the program
must not compute it:
  control      the reference with TF32 on for matmuls and convs (the step
               below the configuration's float32 with TF32 off);
  half_batch   the reference training on the first half of each batch,
               its loss the mean over that half;
  altered      the validation predictions with one window's answers set
               to 0 where they are produced.
A state left unchanged reads 1 on ``change_gap`` by its definition and
needs no run. Each prints one JSON line of the four compared numbers. The
program's own readings are the runs' (``run.py`` prints them last).
"""
import argparse
import contextlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


@contextlib.contextmanager
def tf32(on: bool):
    import torch

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def plan_rows(cell: dict, seed: int, n_train: int):
    """Three distinct full batches of the training split and their weights."""
    import numpy as np
    import torch

    from pbcore.runner import FIRST_STEPS

    b = cell["config"]["model"]["batch_size"]
    order = np.random.default_rng([seed, 4]).permutation(n_train)
    rows = order[:FIRST_STEPS * b].reshape(FIRST_STEPS, b)
    return rows, torch.ones(FIRST_STEPS, b)


def readings(cell: dict, seed: int, device) -> dict:
    """{fault: {number: reading}} of one seed."""
    import torch

    from pbcore import check, runner, state
    from reference import dstagnn_ref as ref

    spec = cell["config"]["model"]
    inputs = runner.make_inputs(cell, seed)
    consts = check.constants(inputs, spec, device)
    state0 = state.initial_state(spec, seed, device)
    rows, weights = plan_rows(cell, seed, len(inputs["splits"]["train"][0]))
    lr = spec["learning_rate"]
    first = {"rows": rows, "weights": weights}
    x_val = inputs["splits"]["val"][0]
    pick = check.val_sample(seed, len(x_val), cell["traffic"]["check"]["val_windows"])

    def as_program(batches, on):
        with tf32(on):
            losses, grad, after = ref.train(state0, batches, spec, consts, lr)
            after = {k: v.cpu() for k, v in after.items()}
            with torch.no_grad():
                pred = torch.cat([
                    ref.forward({k: v.to(device) for k, v in after.items()},
                                torch.as_tensor(x_val[pick][i:i + spec["batch_size"]]).to(device),
                                spec, consts).cpu()
                    for i in range(0, len(pick), spec["batch_size"])]).numpy()
        return {"rows": rows, "weights": weights, "losses": losses,
                "first_grad": {k: v.cpu() for k, v in grad.items()}, "after": after}, pred

    def numbers(program, pred):
        got = check.first_steps(program, state0, check.batches(inputs, first, device), spec,
                                consts, lr, device)
        got["val_gap"] = check.val_gap(pred, program["after"], x_val[pick], spec, consts, device)
        return {k: got[k] for k in check.NAMES}

    out = {}
    control, pred = as_program(check.batches(inputs, first, device), True)
    out["control"] = numbers(control, pred)
    half = [(x[: len(x) // 2], y[: len(y) // 2], w[: len(w) // 2])
            for x, y, w in check.batches(inputs, first, device)]
    sound, pred = as_program(check.batches(inputs, first, device), False)
    faulty, _ = as_program(half, False)
    out["half_batch"] = numbers(faulty, pred)
    altered = pred.copy()
    altered[0] = 0.0
    out["altered"] = numbers(sound, altered)
    out["sound_reference"] = numbers(sound, pred)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)

    import torch

    from pbcore import runner

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = runner.load_cell(args.workload)
    runner.set_tf32(cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(cell, seed, torch.device("cuda"))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
