"""Eager train / eval steps.

Counterpart of ``dstagnn_drought_tpu/training/step.py``: SmoothL1 (Huber,
beta=1) and Adam with the torch-default betas/eps (the JAX package's
``optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)``). PyTorch runs eagerly, so a
step is a plain function; the losses stay on the device and the trainer
reads them once per epoch. ``constants`` carries the dense planes and, on
the sparse path, the BlockEllGraph (``bell``) and its per-tile constants
(``bell_tiles``) or the EllGraph (``ell``). ``fuse_tat``/``fuse_spatial``/
``fuse_gtu`` select the fused kernels, as the JAX trainer's ``apply_extra``
does. The steps call every model family's forward with the same keywords;
the zoo families ignore the DSTAGNN-only ones (``remat`` is passed only
when set: DSTAGNN alone takes it, as in JAX).
:func:`make_checked_train_step` is the debug-mode step.

On a mesh (:mod:`~dstagnn_drought_tpu_torch.parallel`) a step takes this
rank's rows of the global batch; ``model_kw`` carries the partitioned
paths' keywords (``halo``, ``tp``) to the forward, the rows' weighted
loss is divided by the global batch's weight sum (``weight_total``), so the
data ranks' losses add up to the single-device loss, and with a
``data_group`` the gradients are summed over the group before
Adam (:func:`~dstagnn_drought_tpu_torch.parallel.comm.reduce_gradients`):
the update is the single-device step's, on every rank alike.
"""
from __future__ import annotations

import numpy as np
import torch

from dstagnn_drought_tpu_torch import debug
from dstagnn_drought_tpu_torch.ops.nn import per_sample_smooth_l1, smooth_l1_loss
from dstagnn_drought_tpu_torch.parallel import comm


def make_optimizer(params, learning_rate: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    x: torch.Tensor,
    y: torch.Tensor,
    constants: dict,
    *,
    weights: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    compute_dtype: torch.dtype = torch.float32,
    use_pallas: bool = False,
    fuse_tat: bool = False,
    fuse_spatial: bool = False,
    fuse_gtu: bool = False,
    remat: bool = False,
    model_kw: dict | None = None,
    data_group=None,
    weight_total: torch.Tensor | None = None,
) -> torch.Tensor:
    """Forward (dropout on) → weighted SmoothL1 → backward → Adam. Returns
    the loss (this rank's share of it with a ``data_group``), detached, on
    the device."""
    optimizer.zero_grad(set_to_none=True)
    pred = model(
        x, adj_pa=constants["adj_pa"], cheb_polys=constants["cheb_polys"],
        deterministic=False, generator=generator,
        compute_dtype=compute_dtype, use_pallas=use_pallas,
        bell=constants.get("bell"), bell_tiles=constants.get("bell_tiles"),
        ell=constants.get("ell"),
        fuse_tat=fuse_tat, fuse_spatial=fuse_spatial, fuse_gtu=fuse_gtu,
        **({"remat": True} if remat else {}), **(model_kw or {}),
    )
    loss = smooth_l1_loss(pred, y, sample_weights=weights, weight_total=weight_total)
    loss.backward()
    comm.reduce_gradients(model.parameters(), data_group)
    optimizer.step()
    return loss.detach()


def make_checked_train_step(**step_kw):
    """The sanitizer variant of :func:`train_step` (JAX: the ``checkify``
    step): returns ``step(model, optimizer, x_full, y_full, idx, constants,
    *, weights, generator, batch)`` → loss. ``idx`` (host numpy or a CPU
    tensor) is checked against the split's length before the gather
    (:class:`~dstagnn_drought_tpu_torch.debug.BatchIndexError`); then the
    whole step, forward, loss, backward and Adam, runs under
    :func:`~dstagnn_drought_tpu_torch.debug.checking`, so the first op or
    kernel that emits a NaN or inf raises
    :class:`~dstagnn_drought_tpu_torch.debug.NonFiniteError` naming it and
    the batch. ``step_kw`` are :func:`train_step`'s keywords. It computes
    what :func:`train_step` computes, bit for bit."""

    def step(model, optimizer, x_full, y_full, idx, constants, *, weights=None,
             generator=None, batch=None, weight_total=None):
        debug.check_batch_indices(idx, x_full.shape[0], batch)
        i = torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(x_full.device)
        with debug.checking(batch):
            return train_step(model, optimizer, x_full[i], y_full[i], constants,
                              weights=weights, generator=generator,
                              weight_total=weight_total, **step_kw)

    return step


@torch.no_grad()
def eval_step(
    model: torch.nn.Module,
    x: torch.Tensor,
    y: torch.Tensor,
    constants: dict,
    *,
    compute_dtype: torch.dtype = torch.float32,
    use_pallas: bool = False,
    fuse_tat: bool = False,
    fuse_spatial: bool = False,
    fuse_gtu: bool = False,
    model_kw: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic forward → (pred float32, per-sample SmoothL1 (B,))."""
    pred = model(
        x, adj_pa=constants["adj_pa"], cheb_polys=constants["cheb_polys"],
        deterministic=True, compute_dtype=compute_dtype, use_pallas=use_pallas,
        bell=constants.get("bell"), bell_tiles=constants.get("bell_tiles"),
        ell=constants.get("ell"),
        fuse_tat=fuse_tat, fuse_spatial=fuse_spatial, fuse_gtu=fuse_gtu,
        **(model_kw or {}),
    )
    return pred, per_sample_smooth_l1(pred, y)
