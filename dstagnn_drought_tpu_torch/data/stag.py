"""Spatial-Temporal Aware Graph (STAG) construction on the device.

Counterpart of ``dstagnn_drought_tpu/data/stag.py``, float32 throughout:

  * per-node probability marginals from per-timestep L2 norms (zero norms
    clamped to 1e-12);
  * pairwise cosine cost matrices D[s,t] = 1 − cos(x_i[s], x_j[t]), clipped
    to [0, 1], one (M, T, T) block of node pairs at a time (``torch.bmm``);
  * entropic optimal transport by log-domain Sinkhorn iterations, batched
    over the block (in place of the reference's exact linear program);
  * symmetrization, ``adj = 1 − sta + I``, per-row top-⌈sparsity·N⌉
    selection and the reference's binary stag / weighted strg CSVs, with
    numpy.

``order='reference'`` takes each row's *smallest* adj entries (the most
dissimilar neighbours), as the reference's exact generator does;
``order='similar'`` the largest, as its fast variant does.
:func:`fast_sta_matrix` is the reference's PCA approximation: a cosine
distance in the top principal components, gated by a spatial cutoff.

The entry points take a ``device`` (default ``cuda``, which raises without a
card; ``device='cpu'`` runs on the CPU). The JAX package runs this on the
TPU as XLA, with no Pallas kernel; here it is PyTorch ops.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from dstagnn_drought_tpu_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Sinkhorn optimal transport
# ---------------------------------------------------------------------------

def sinkhorn_distance(
    p: torch.Tensor, q: torch.Tensor, D: torch.Tensor,
    eps: float = 0.01, num_iters: int = 200,
) -> torch.Tensor:
    """Entropic-regularized OT cost <P, D>, log-domain stabilized.

    p, q: (..., T) marginals (may contain zeros); D: (..., T, T) cost. The
    leading axes are a batch of pairs. A zero mass gives a -inf potential
    and a zero row or column of P; where a whole marginal is zero the
    log-sum-exp of an all -inf row is -inf and P is 0 there, as in JAX."""
    neg_inf = torch.tensor(-torch.inf, dtype=p.dtype, device=p.device)
    logp = torch.where(p > 0, torch.log(torch.clamp(p, min=1e-38)), neg_inf)
    logq = torch.where(q > 0, torch.log(torch.clamp(q, min=1e-38)), neg_inf)
    mK = -D / eps  # log kernel
    f = torch.zeros_like(p)
    g = torch.zeros_like(q)
    for _ in range(num_iters):
        # row/col log-sum-exp updates on potentials
        f = logp - torch.logsumexp(mK + g[..., None, :], dim=-1)
        g = logq - torch.logsumexp(mK + f[..., :, None], dim=-2)
    logP = mK + f[..., :, None] + g[..., None, :]
    P = torch.where(torch.isfinite(logP), torch.exp(logP), 0.0)
    return (P * D).sum(dim=(-2, -1))


def _marginals_and_normed(data: torch.Tensor):
    """data (T, N, F) → marginals (N, T) and unit feature vectors (N, T, F)."""
    x = data.permute(1, 0, 2)  # (N, T, F)
    norms = torch.linalg.norm(x, dim=2)  # (N, T)
    norms = torch.where(norms == 0, 1e-12, norms)
    marg = norms / (norms.sum(dim=1, keepdim=True) + 1e-12)
    return marg, x / norms[:, :, None]


def _pair_block_distances(
    marg: torch.Tensor, xn: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor,
    eps: float, num_iters: int,
) -> torch.Tensor:
    """Sinkhorn STA distances for a block of node pairs. ii/jj: (M,)."""
    # cosine cost: (M, T, T) by batched matmul
    D = 1.0 - torch.bmm(xn[ii], xn[jj].transpose(1, 2))
    D = torch.clamp(torch.nan_to_num(D, nan=1.0), 0.0, 1.0)
    return sinkhorn_distance(marg[ii], marg[jj], D, eps=eps, num_iters=num_iters)


def sta_matrix(
    data: np.ndarray,
    *,
    eps: float = 0.01,
    num_iters: int = 200,
    block_size: int = 4096,
    progress: bool = False,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Full (N, N) spatial-temporal aware distance matrix of a (T, N, F)
    signal: the upper-triangle pairs in blocks of ``block_size`` (the last
    padded with pair (0, 0)), symmetrized, zero diagonal."""
    device = resolve_device(device)
    data = torch.as_tensor(np.asarray(data, np.float32), device=device)
    T, N, F = data.shape
    marg, xn = _marginals_and_normed(data)

    iu, ju = np.triu_indices(N, k=1)
    n_pairs = iu.shape[0]
    out = np.zeros((n_pairs,), np.float32)
    for start in range(0, n_pairs, block_size):
        end = min(start + block_size, n_pairs)
        ii = np.zeros((block_size,), np.int64)
        jj = np.zeros((block_size,), np.int64)
        ii[: end - start] = iu[start:end]
        jj[: end - start] = ju[start:end]
        d = _pair_block_distances(marg, xn, torch.from_numpy(ii).to(device),
                                  torch.from_numpy(jj).to(device), eps, num_iters)
        out[start:end] = d.cpu().numpy()[: end - start]
        if progress:
            print(f"STAG pairs {end}/{n_pairs}", flush=True)

    sta = np.zeros((N, N), np.float32)
    sta[iu, ju] = out
    return sta + sta.T


# ---------------------------------------------------------------------------
# fast approximate variant (reference data/fast_STAG_gen.py)
# ---------------------------------------------------------------------------

def fast_sta_matrix(
    data: np.ndarray,
    coords: np.ndarray | None = None,
    *,
    n_components: int = 12,
    max_distance: float = 10.0,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """PCA-reduced pairwise cosine distance gated by a spatial cutoff.

    data: (T, N, F); coords: (N, 2) spatial coordinates (default: the
    reference's grid-index heuristic over non-NaN pixels). The cosine is
    invariant to the SVD's per-component signs."""
    device = resolve_device(device)
    T, N, F = data.shape
    flat = np.transpose(np.nan_to_num(data), (1, 0, 2)).reshape(N, T * F)
    # PCA via SVD of the centered matrix
    centered = torch.as_tensor(flat - flat.mean(axis=0, keepdims=True),
                               dtype=torch.float32, device=device)
    _, _, vt = torch.linalg.svd(centered, full_matrices=False)
    reduced = centered @ vt[:n_components].T  # (N, n_components)

    norms = torch.linalg.norm(reduced, dim=1) + 1e-12
    xn = reduced / norms[:, None]
    cos_dist = 1.0 - xn @ xn.T  # (N, N)

    if coords is None:
        valid = ~np.isnan(data[0, :, 0])
        coords = np.array(np.where(valid)).T
        if coords.shape[0] != N:
            coords = np.stack([np.arange(N), np.zeros(N)], axis=1)
    c = torch.as_tensor(np.asarray(coords, np.float32), device=device)
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(dim=-1)
    gate = d2 <= max_distance**2

    sta = torch.triu(torch.where(gate, cos_dist, 0.0), diagonal=1)
    return (sta + sta.T).cpu().numpy().astype(np.float32)


# ---------------------------------------------------------------------------
# sparsification + reference CSV formats
# ---------------------------------------------------------------------------

def sparsify(
    sta: np.ndarray, sparsity: float = 0.01, order: str = "reference"
) -> tuple[np.ndarray, np.ndarray]:
    """adj = 1 − sta + I; per-row top-⌈sparsity·N⌉ → (binary A, weighted R).

    order='reference': each row's smallest adj entries; order='similar':
    the largest."""
    N = sta.shape[0]
    adj = 1.0 - sta + np.identity(N, dtype=sta.dtype)
    top = max(1, int(N * sparsity))
    if order == "reference":
        nbrs = np.argsort(adj, axis=1, kind="stable")[:, :top]
    elif order == "similar":
        nbrs = np.argsort(-adj, axis=1, kind="stable")[:, :top]
    else:
        raise ValueError(f"unknown order {order!r}")
    A = np.zeros_like(adj)
    R = np.zeros_like(adj)
    rows = np.arange(N)[:, None]
    A[rows, nbrs] = 1.0
    R[rows, nbrs] = adj[rows, nbrs]
    return A, R


def _tag(sparsity: float) -> str:
    return f"{int(sparsity * 100):03d}"


def save_stag_csvs(
    A: np.ndarray, R: np.ndarray, out_dir: str, dataset_name: str,
    sparsity: float = 0.01,
) -> tuple[str, str]:
    """Write the reference's ``stag_{tag}_{name}.csv`` (binary, ``%.1f``) and
    ``strg_{tag}_{name}.csv`` (weighted, ``%.18g``), tag =
    ``{int(sparsity*100):03d}``."""
    a_path = os.path.join(out_dir, f"stag_{_tag(sparsity)}_{dataset_name}.csv")
    r_path = os.path.join(out_dir, f"strg_{_tag(sparsity)}_{dataset_name}.csv")
    np.savetxt(a_path, A, delimiter=",", fmt="%.1f")
    np.savetxt(r_path, R, delimiter=",", fmt="%.18g")
    return a_path, r_path


def generate_stag(
    data: np.ndarray,
    dataset_name: str,
    out_dir: str,
    *,
    sparsity: float = 0.01,
    method: str = "sinkhorn",
    order: str = "reference",
    coords: np.ndarray | None = None,
    eps: float = 0.01,
    num_iters: int = 200,
    block_size: int = 4096,
    save_npy: bool = True,
    progress: bool = False,
    device: str | torch.device | None = None,
):
    """End-to-end STAG generation (Sinkhorn or fast) with the reference's
    outputs: (sta, A, R, (stag csv path, strg csv path)), and the STA matrix
    as ``stag_{tag}_{name}.npy`` with ``save_npy``."""
    if method == "sinkhorn":
        sta = sta_matrix(data, eps=eps, num_iters=num_iters, block_size=block_size,
                         progress=progress, device=device)
    elif method == "fast":
        sta = fast_sta_matrix(data, coords, device=device)
    else:
        raise ValueError(f"unknown method {method!r}")
    os.makedirs(out_dir, exist_ok=True)
    if save_npy:
        np.save(os.path.join(out_dir, f"stag_{_tag(sparsity)}_{dataset_name}.npy"), sta)
    A, R = sparsify(sta, sparsity, order)
    a_path, r_path = save_stag_csvs(A, R, out_dir, dataset_name, sparsity)
    return sta, A, R, (a_path, r_path)
