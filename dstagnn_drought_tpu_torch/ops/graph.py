"""Spectral graph operators.

Counterpart of ``dstagnn_drought_tpu/ops/graph.py``:

  * ``scaled_laplacian`` — L̃ = 2L/λ_max − I with λ_max from power
    iteration on the combinatorial Laplacian (symmetric PSD, so the dominant
    eigenvalue in magnitude is the largest one). The start vector is a fixed
    normal draw from ``torch.Generator`` seed 0; the JAX package draws its
    own from ``jax.random``, so λ_max agrees to the iteration's tolerance,
    not bit for bit.
  * ``cheb_polynomials`` — T_0..T_{K-1} with the reference's **elementwise**
    recurrence ``2 * L̃ * T_{k-1} - T_{k-2}`` (Hadamard product, an
    inherited ASTGCN quirk), or the matrix recurrence with ``matmul=True``.
  * ``laplacian`` — the legacy Laplacian variants (8 kinds), the ``wid_*``
    ones rescaled by this module's power-iteration λ_max.
"""
from __future__ import annotations

import torch


def power_iteration_lambda_max(M: torch.Tensor, num_iters: int = 200) -> torch.Tensor:
    """Dominant eigenvalue of a symmetric matrix via power iteration."""
    n = M.shape[0]
    # Not the ones vector: for a graph Laplacian that is exactly the null
    # eigenvector and power iteration would stall at 0.
    gen = torch.Generator(device="cpu").manual_seed(0)
    v = torch.randn(n, generator=gen, dtype=M.dtype).to(M.device)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(num_iters):
        w = M @ v
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    return v @ (M @ v)


def scaled_laplacian(W: torch.Tensor, num_iters: int = 200) -> torch.Tensor:
    """L̃ = 2(D − W)/λ_max − I for a symmetric adjacency W (float32)."""
    W = torch.as_tensor(W, dtype=torch.float32)
    if W.ndim != 2 or W.shape[0] != W.shape[1]:
        raise ValueError(f"adjacency must be square, got {tuple(W.shape)}")
    L = torch.diag(W.sum(dim=1)) - W
    lam = power_iteration_lambda_max(L, num_iters=num_iters)
    n = W.shape[0]
    return (2.0 * L) / lam - torch.eye(n, dtype=W.dtype, device=W.device)


def cheb_polynomials(L_tilde: torch.Tensor, K: int, matmul: bool = False) -> torch.Tensor:
    """Stack of Chebyshev "polynomials" T_0..T_{K-1}, shape (K, N, N)."""
    L_tilde = torch.as_tensor(L_tilde, dtype=torch.float32)
    n = L_tilde.shape[0]
    polys = [torch.eye(n, dtype=L_tilde.dtype, device=L_tilde.device)]
    if K > 1:
        polys.append(L_tilde)
    for _ in range(2, K):
        if matmul:
            nxt = 2.0 * (L_tilde @ polys[-1]) - polys[-2]
        else:
            nxt = 2.0 * L_tilde * polys[-1] - polys[-2]
        polys.append(nxt)
    return torch.stack(polys[:K], dim=0)


LAPLACIAN_KINDS = ("id_mat", "com_lap_mat", "sym_normd_lap_mat", "wid_sym_normd_lap_mat",
                   "hat_sym_normd_lap_mat", "rw_normd_lap_mat", "wid_rw_normd_lap_mat",
                   "hat_rw_normd_lap_mat")


def laplacian(adj, kind: str = "sym_normd_lap_mat") -> torch.Tensor:
    """Legacy Laplacian-variant factory (float32), the JAX package's
    ``laplacian``: identity, combinatorial D − A, symmetric and random-walk
    normalised I − D^-1/2 A D^-1/2 and I − D^-1 A (isolated nodes get
    zero rows), their ``wid_`` rescaling 2L/λ_max − I and their ``hat_``
    renormalised forms with self-loops, D̃^-1/2 (A+I) D̃^-1/2 and D̃^-1 (A+I)."""
    A = torch.as_tensor(adj, dtype=torch.float32)
    n = A.shape[0]
    I = torch.eye(n, dtype=A.dtype, device=A.device)
    deg = A.sum(dim=1)
    if kind == "id_mat":
        return I
    if kind == "com_lap_mat":
        return torch.diag(deg) - A
    if kind in ("sym_normd_lap_mat", "wid_sym_normd_lap_mat", "hat_sym_normd_lap_mat"):
        d_inv_sqrt = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)),
                                 torch.zeros_like(deg))
        sym = I - (d_inv_sqrt[:, None] * A) * d_inv_sqrt[None, :]
        if kind == "sym_normd_lap_mat":
            return sym
        if kind == "wid_sym_normd_lap_mat":
            return 2.0 * sym / power_iteration_lambda_max(sym) - I
        wd_inv_sqrt = torch.rsqrt(deg + 1.0)
        return (wd_inv_sqrt[:, None] * (A + I)) * wd_inv_sqrt[None, :]
    if kind in ("rw_normd_lap_mat", "wid_rw_normd_lap_mat", "hat_rw_normd_lap_mat"):
        d_inv = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1e-30), torch.zeros_like(deg))
        rw = I - d_inv[:, None] * A
        if kind == "rw_normd_lap_mat":
            return rw
        if kind == "wid_rw_normd_lap_mat":
            return 2.0 * rw / power_iteration_lambda_max(rw) - I
        return (1.0 / (deg + 1.0))[:, None] * (A + I)
    raise ValueError(f"unknown laplacian kind {kind!r}")
