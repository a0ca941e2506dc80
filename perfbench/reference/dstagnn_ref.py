"""Plain float32 DSTAGNN in PyTorch: the yardstick that decides ``correct``.

Written from the model's description, with no kernel, no cache and no
batching, and importing nothing of the program: a functional forward over a
dict of parameters keyed by the reference implementation's ``state_dict``
names, the weighted SmoothL1 loss, and Adam written out by hand.

The semantics are those of the DSTAGNN reference (Lan et al., ICML 2022)
as this repository trains it; the departures from the published code that
it shares with the program are named where they occur:
  * the temporal attention's softmax runs over the query axis, the value
    contraction over the key axis (the reference's own quirk);
  * a block whose input has F > 1 features takes no temporal embedding, and
    the incoming attention scores are averaged over their feature axis when
    the width changes;
  * the residual of a block whose width changes is a 1x1 conv (the
    reference's multichannel residual breaks on shapes);
  * the Chebyshev "polynomials" follow the elementwise recurrence
    T_k = 2 L ⊙ T_{k-1} - T_{k-2} (an ASTGCN quirk), with L = 2(D - W)/λ - I
    and λ from 200 steps of power iteration started from
    ``torch.randn(N)`` of a CPU generator seeded 0 (the published code takes
    the exact eigenvalue; see ``lambda_max``);
  * on a block-sparse graph (``valid``) the spatial softmax of each target
    runs over its in-neighbours and itself only (the BELL semantics).
Everything runs in float32 except λ, which is worked out in float64.
"""
from __future__ import annotations

import math

import torch

BETAS, EPS = (0.9, 0.999), 1e-8


# ---------------------------------------------------------------------------
# graph constants
# ---------------------------------------------------------------------------

def lambda_max(lap: torch.Tensor, iters: int = 200) -> float:
    """Largest eigenvalue of the Laplacian by power iteration, in float64.
    200 steps from a seeded start are the configuration's stated method;
    on a 93 x 23 raster they stop about 1e-3 below the true eigenvalue."""
    n = lap.shape[0]
    v = torch.randn(n, generator=torch.Generator().manual_seed(0)).double()
    lap = lap.double()
    v = v / v.norm()
    for _ in range(iters):
        w = lap @ v
        v = w / w.norm().clamp_min(1e-30)
    return float(v @ (lap @ v))


def cheb_polys(adj, K: int) -> torch.Tensor:
    """(K, N, N) float32 Chebyshev planes of the scaled Laplacian of ``adj``."""
    w = torch.as_tensor(adj, dtype=torch.float64)
    lap = torch.diag(w.sum(dim=1)) - w
    lt = 2.0 * lap / lambda_max(lap) - torch.eye(w.shape[0], dtype=torch.float64)
    polys = [torch.eye(w.shape[0], dtype=torch.float64), lt]
    for _ in range(2, K):
        polys.append(2.0 * lt * polys[-1] - polys[-2])
    return torch.stack(polys[:K]).float()


def neighbourhood(adj) -> torch.Tensor:
    """(N, N) bool: source i may attend to target j (an edge i → j, or i = j)."""
    a = torch.as_tensor(adj) != 0
    return a | torch.eye(a.shape[0], dtype=torch.bool)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _ln(x, w, b):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * w + b


def _block(p, pre, x, res_att, spec, cheb, adj_pa, valid):
    B, N, F, T = x.shape
    H, dk, dv, K = spec["n_heads"], spec["d_k"], spec["d_v"], spec["K"]
    # temporal embedding and attention over the time axis, token width N
    te = x.permute(0, 2, 3, 1)                                    # (B, F, T, N)
    if F == 1:
        te = _ln(te + p[pre + "EmbedT.pos_embed.weight"],
                 p[pre + "EmbedT.norm.weight"], p[pre + "EmbedT.norm.bias"])
    if res_att.dim() == 5 and res_att.shape[1] not in (1, F):
        res_att = res_att.mean(dim=1, keepdim=True)
    q = (te @ p[pre + "TAt.W_Q.weight"].t()).reshape(B, F, T, H, dk)
    k = (te @ p[pre + "TAt.W_K.weight"].t()).reshape(B, F, T, H, dk)
    v = (te @ p[pre + "TAt.W_V.weight"].t()).reshape(B, F, T, H, dv)
    scores = torch.einsum("bfqhd,bfkhd->bfhqk", q, k) / math.sqrt(dk) + res_att
    att = torch.softmax(scores, dim=3)
    ctx = torch.einsum("bfhqk,bfkhd->bfqhd", att, v).reshape(B, F, T, H * dv)
    tat = _ln(ctx @ p[pre + "TAt.fc.weight"].t() + te,
              p[pre + "TAt.layer_norm.weight"], p[pre + "TAt.layer_norm.bias"])
    # the 1 x F pre-conv over (T, F) to d_model, the spatial embedding
    w_pre = p[pre + "pre_conv.weight"][:, :, 0, :]                  # (d, T, F)
    xs = torch.einsum("bftn,dtf->bnd", tat, w_pre) + p[pre + "pre_conv.bias"]
    emb = _ln(xs + p[pre + "EmbedS.pos_embed.weight"],
              p[pre + "EmbedS.norm.weight"], p[pre + "EmbedS.norm.bias"])
    # spatial attention: one head a Chebyshev order, raw scores
    qs = (emb @ p[pre + "SAt.W_Q.weight"].t()).reshape(B, N, K, dk)
    ks = (emb @ p[pre + "SAt.W_K.weight"].t()).reshape(B, N, K, dk)
    s = torch.einsum("bihd,bjhd->bhij", qs, ks) / math.sqrt(dk)    # (B, K, N, N)
    masks = torch.stack([p[pre + f"cheb_conv_SAt.mask.{i}"] for i in range(K)])
    s = s + (adj_pa * masks)[None]
    if valid is not None:
        s = s.masked_fill(~valid, -math.inf)
    a = cheb[None] * torch.softmax(s, dim=2)                       # softmax over sources
    C = x.shape[2]
    agg = torch.einsum("bkij,bim->bkjm", a, x.reshape(B, N, C * T)).reshape(B, K, N, C, T)
    theta = torch.stack([p[pre + f"cheb_conv_SAt.Theta.{i}"] for i in range(K)])
    gcn = torch.relu(torch.einsum("bkjct,kco->bjot", agg, theta))  # (B, N, Co, T)
    # gated temporal convs of widths 3, 5, 7 over time, concatenated in time
    Co = gcn.shape[2]
    outs = []
    for width in (3, 5, 7):
        w = p[pre + f"gtu{width}.con2out.weight"][:, :, 0, :]          # (2Co, Co, width)
        cols = gcn.unfold(3, width, 1)                                # (B, N, Co, T', width)
        y = torch.einsum("bnctw,ocw->bnot", cols, w) + p[pre + f"gtu{width}.con2out.bias"][:, None]
        outs.append(torch.tanh(y[:, :, :Co]) * torch.sigmoid(y[:, :, Co:]))
    tc = torch.cat(outs, dim=3) @ p[pre + "fcmy.0.weight"].t() + p[pre + "fcmy.0.bias"]
    tc = torch.relu(tc) if F == 1 else torch.relu(gcn + tc)
    if F == Co:
        res = x
    else:
        res = (torch.einsum("bnft,cf->bnct", x, p[pre + "residual_conv.weight"][:, :, 0, 0])
               + p[pre + "residual_conv.bias"][:, None])
    y = torch.relu(res + tc).permute(0, 1, 3, 2)                   # (B, N, T, Co)
    y = _ln(y, p[pre + "ln.weight"], p[pre + "ln.bias"]).permute(0, 1, 3, 2)
    return y, scores


def forward(p: dict, x: torch.Tensor, spec: dict, consts: dict) -> torch.Tensor:
    """x (B, N, F, T) → predictions (B, N, num_for_predict). ``consts``:
    ``cheb`` (K, N, N), ``adj_pa`` (N, N), ``valid`` (N, N) bool or None."""
    res_att = torch.zeros((), device=x.device)
    outs = []
    for i in range(spec["nb_block"]):
        x, res_att = _block(p, f"BlockList.{i}.", x, res_att, spec, consts["cheb"],
                            consts["adj_pa"], consts.get("valid"))
        outs.append(x)
    cat = torch.cat(outs, dim=-1)                                  # (B, N, Co, T·nb)
    h = (torch.einsum("bnct,dtc->bnd", cat, p["final_conv.weight"][:, :, 0, :])
         + p["final_conv.bias"])
    return h @ p["final_fc.weight"].t() + p["final_fc.bias"]


def loss(pred, y, weights) -> torch.Tensor:
    """SmoothL1 (beta 1) per sample, weighted, over the weights' sum."""
    d = (pred - y).abs()
    per = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).flatten(1).mean(dim=1)
    return (per * weights).sum() / weights.sum().clamp_min(1.0)


def train(p: dict, batches, spec: dict, consts: dict, lr: float):
    """Adam over ``batches`` (x, y, weights) from parameters ``p``. Returns
    (losses, gradients of the first step, parameters after the last)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    s = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for t, (x, y, w) in enumerate(batches, start=1):
        value = loss(forward(p, x, spec, consts), y, w)
        grads = torch.autograd.grad(value, list(p.values()), allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g for v, g in zip(p.values(), grads)]
        losses.append(float(value.detach()))
        if t == 1:
            first = {k: g.detach().clone() for k, g in zip(p, grads)}
        with torch.no_grad():
            for (k, v), g in zip(p.items(), grads):
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                s[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                m_hat = m[k] / (1 - BETAS[0] ** t)
                s_hat = s[k] / (1 - BETAS[1] ** t)
                v -= lr * m_hat / (s_hat.sqrt() + EPS)
    return losses, first, {k: v.detach() for k, v in p.items()}
