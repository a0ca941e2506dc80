"""The comparison that decides ``correct``.

The reference (``perfbench/reference/dstagnn_ref.py``, plain float32
PyTorch) follows the program's first three training steps from the same
seeded weights on the same batches, and the comparison takes four numbers:

  loss_gap    the largest relative gap of the three steps' losses;
  grad_gap    the worst leaf's gap between the norms of the first gradient
              (the program's read from Adam's first moment after step 1);
  change_gap  the worst leaf's gap between the norms of the weights' change
              over the three steps;
  val_gap     the largest gap of the window's last validation predictions,
              on windows drawn from the seed, against the reference's
              forward from the program's weights at the window's end, over
              the reference's largest |prediction|.

A leaf's gap is measured against the larger of the reference's norm of that
leaf and of the median leaf. Leaves whose first gradient in the reference is
under a thousandth of the median leaf's (parameters the path leaves unused,
such as the temporal embedding of a block whose input has F > 1 features)
count in neither norm number.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import dstagnn_ref as ref

NAMES = ("loss_gap", "grad_gap", "change_gap", "val_gap")
SMALL_GRAD = 1e-3


def constants(inputs: dict, spec: dict, device) -> dict:
    """The reference's graph constants, worked out again from the graph."""
    c = {"cheb": ref.cheb_polys(inputs["adj"], spec["K"]).to(device),
         "adj_pa": torch.as_tensor(inputs["adj_pa"]).to(device)}
    if inputs["tiles"] is not None:
        c["valid"] = ref.neighbourhood(inputs["adj"]).to(device)
    return c


def _norms(d: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in d.items()}


def leaf_gap(program: dict, reference: dict, keep) -> tuple[float, str]:
    """(worst gap, its leaf) between the norms of ``program`` and
    ``reference`` over the leaves in ``keep``."""
    p, r = _norms(program), _norms(reference)
    median = float(np.median([r[k] for k in keep]))
    gaps = {k: abs(p[k] - r[k]) / max(r[k], median) for k in keep}
    gaps = {k: g if np.isfinite(g) else np.inf for k, g in gaps.items()}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def first_steps(first: dict, state0: dict, batches, spec: dict, consts: dict, lr: float,
                device) -> dict:
    """loss_gap, grad_gap and change_gap of the program's first steps
    (``first``: its losses, first gradient and weights after the steps)
    against the reference's from ``state0`` on ``batches``."""
    losses, grad, after = ref.train(state0, batches, spec, consts, lr)
    g_ref = {k: v.cpu() for k, v in grad.items()}
    g_median = float(np.median(list(_norms(g_ref).values())))
    keep = [k for k, v in _norms(g_ref).items() if v >= SMALL_GRAD * g_median]
    s0 = {k: v.cpu() for k, v in state0.items()}
    d_prog = {k: first["after"][k] - s0[k] for k in keep}
    d_ref = {k: after[k].cpu() - s0[k] for k in keep}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(first["losses"], losses))
    grad_gap, grad_leaf = leaf_gap({k: first["first_grad"][k] for k in keep}, g_ref, keep)
    change_gap, change_leaf = leaf_gap(d_prog, d_ref, keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "where": {"grad_gap": grad_leaf, "change_gap": change_leaf,
                      "left_out": sorted(set(g_ref) - set(keep)),
                      "reference_losses": losses}}


def val_sample(seed: int, n_val: int, count: int) -> np.ndarray:
    rng = np.random.default_rng([seed, 3])
    return np.sort(rng.choice(n_val, size=min(count, n_val), replace=False))


def val_gap(pred: np.ndarray, weights: dict, x: np.ndarray, spec: dict, consts: dict,
            device) -> float:
    """The largest gap of ``pred`` (the program's predictions of windows
    ``x``) against the reference's forward with ``weights``, over the
    reference's largest |prediction|; in batches of the configuration's
    size."""
    w = {k: v.to(device) for k, v in weights.items()}
    out = []
    with torch.no_grad():
        for i in range(0, len(x), spec["batch_size"]):
            xb = torch.as_tensor(x[i:i + spec["batch_size"]]).to(device)
            out.append(ref.forward(w, xb, spec, consts).cpu())
    r = torch.cat(out).double()
    return float((torch.as_tensor(pred).double() - r).abs().max() / r.abs().max())


def batches(inputs: dict, first: dict, device):
    """The first steps' (x, y, weights) on ``device``, as the program got them."""
    x, y = inputs["splits"]["train"]
    for row, w in zip(first["rows"], first["weights"]):
        yield (torch.as_tensor(x[row]).to(device), torch.as_tensor(y[row]).to(device),
               w.to(device))


def verdict(numbers: dict, limits: dict) -> bool:
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in NAMES)
