"""The port's fused temporal attention (ops/cuda/tat_fused.py) against the
JAX package's Pallas kernel, run in interpret mode on the CPU.

On CPU tensors the wrapper takes the plain PyTorch version; the CUDA kernels
are held against that version on the card (the ``cuda`` case below, skipped
here, and chip_smoke.py). Tolerances are the JAX fused-kernel tests'
(tests/test_tat_fused.py): forward 1e-4, gradients 2e-3; in bfloat16 one
bf16 ulp of the output's scale (2^-7 ≈ 8e-3 at |x| < 2, both sides compute
in float32 and round once).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstagnn_drought_tpu.ops.pallas.tat_fused import (
    fused_temporal_attention as jax_fused,
)
from dstagnn_drought_tpu_torch.ops.cuda import tat_fused

torch.set_num_threads(1)

B, F, T, N, H, DK, DV = 2, 3, 6, 20, 2, 8, 8
NAMES = ("x", "pos", "g0", "b0", "wq", "wk", "wv", "wo", "g1", "b1", "res")


def _tensors(seed=0, res_shape=(B, F, H, T, T)):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    return dict(
        x=mk(B, F, T, N), pos=mk(T, N),
        g0=np.full(N, 1.1, np.float32), b0=np.full(N, 0.05, np.float32),
        wq=mk(N, H * DK), wk=mk(N, H * DK), wv=mk(N, H * DV), wo=mk(H * DV, N),
        g1=np.full(N, 0.9, np.float32), b1=np.full(N, -0.02, np.float32),
        res=mk(*res_shape),
    )


def _kw(a, embed, lib):
    return dict(pos=a["pos"] if embed else None, ln0_scale=a["g0"] if embed else None,
                ln0_bias=a["b0"] if embed else None, wq=a["wq"], wk=a["wk"], wv=a["wv"],
                wo=a["wo"], ln_scale=a["g1"], ln_bias=a["b1"], n_heads=H, d_k=DK, d_v=DV)


def _loss(o, s, lib):
    return (o ** 2).sum() + lib.sin(s).sum()


def _jax(a, embed, scalar_res):
    def f(t):
        res = jnp.zeros(()) if scalar_res else t["res"]
        o, s = jax_fused(t["x"], res, **_kw(t, embed, jnp))
        return _loss(o, s, jnp), (o, s)

    (_, (o, s)), g = jax.value_and_grad(f, has_aux=True)(
        {k: jnp.asarray(v) for k, v in a.items()})
    return np.asarray(o), np.asarray(s), {k: np.asarray(v) for k, v in g.items()}


def _port(a, embed, scalar_res, dtype=torch.float32):
    t = {k: torch.from_numpy(v).to(dtype).requires_grad_(True) for k, v in a.items()}
    res = torch.zeros((), dtype=dtype) if scalar_res else t["res"]
    o, s = tat_fused.fused_temporal_attention(t["x"], res, **_kw(t, embed, torch))
    _loss(o.float(), s.float(), torch).backward()
    return o, s, t


@pytest.mark.parametrize("res", ["broadcast", "scalar"])
@pytest.mark.parametrize("embed", [True, False], ids=["embed", "no_embed"])
def test_forward_and_grads_match_jax(embed, res):
    """res 'broadcast' is the (B, 1, H, T, T) score residual of block 2,
    spread over F; 'scalar' is block 1's zero."""
    a = _tensors(res_shape=(B, 1, H, T, T))
    scalar = res == "scalar"
    j_o, j_s, j_g = _jax(a, embed, scalar)
    o, s, t = _port(a, embed, scalar)
    assert o.shape == (B, F, T, N) and s.shape == (B, F, H, T, T)
    np.testing.assert_allclose(o.detach().numpy(), j_o, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(s.detach().numpy(), j_s, atol=1e-4, rtol=1e-4)
    for name in NAMES:
        if (name == "res" and scalar) or (name in ("pos", "g0", "b0") and not embed):
            assert t[name].grad is None
            continue
        np.testing.assert_allclose(t[name].grad.numpy(), j_g[name], atol=2e-3, rtol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("embed", [True, False], ids=["embed", "no_embed"])
def test_bfloat16_forward_matches_jax(embed):
    a = _tensors(seed=1)
    bf = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in a.items()}
    j_o, j_s = jax_fused(bf["x"], bf["res"], **_kw(bf, embed, jnp))
    t = {k: torch.from_numpy(v).bfloat16() for k, v in a.items()}
    o, s = tat_fused.fused_temporal_attention(t["x"], t["res"], **_kw(t, embed, torch))
    assert o.dtype == s.dtype == torch.bfloat16
    for got, want in ((o, j_o), (s, j_s)):
        want = np.asarray(want.astype(jnp.float32))
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.float().numpy(), want, atol=8e-3 * scale, rtol=8e-3)


def _kernel_args(dtype=torch.float32):
    a = _tensors()
    x = torch.from_numpy(a["x"]).reshape(B * F, T, N)
    wqkv = torch.from_numpy(np.concatenate([a["wq"], a["wk"], a["wv"]], axis=1))
    args = [x, torch.from_numpy(a["pos"]), torch.from_numpy(a["g0"]),
            torch.from_numpy(a["b0"]), wqkv, torch.from_numpy(a["wo"]),
            torch.from_numpy(a["g1"]), torch.from_numpy(a["b1"]),
            torch.from_numpy(a["res"]).reshape(B * F, H, T, T)]
    return [t.to(dtype) for t in args]


def test_kernels_refuse_what_they_do_not_take():
    args = _kernel_args()
    dims = dict(n_heads=H, d_k=DK, d_v=DV, embed=True)
    with pytest.raises(ValueError, match="CUDA"):
        tat_fused.tat_forward_cuda(*args, **dims)
    with pytest.raises(TypeError, match="float32"):
        tat_fused.tat_forward_cuda(args[0].double(), *args[1:], **dims)
    with pytest.raises(ValueError, match="contiguous"):
        tat_fused.tat_forward_cuda(args[0].transpose(0, 1).contiguous().transpose(0, 1),
                                   *args[1:], **dims)
    with pytest.raises(ValueError, match="wo must be"):
        tat_fused.tat_forward_cuda(*args[:5], args[5][:, :3], *args[6:], **dims)
    with pytest.raises(ValueError, match="CUDA"):
        tat_fused.tat_backward_cuda(*args, args[0], args[8], **dims)
    # a row's activations must fit one block's shared memory
    assert tat_fused.smem_bytes(12, 170, 3, 32, 32, backward=True) < 227 * 1024
    assert tat_fused.smem_bytes(48, 2139, 2, 32, 32, backward=False) > 227 * 1024


def test_cpu_path_counts_no_launch():
    before = (tat_fused.fwd_launches, tat_fused.bwd_launches)
    _port(_tensors(), True, False)
    assert (tat_fused.fwd_launches, tat_fused.bwd_launches) == before


def test_bfloat16_rounds_only_the_outputs():
    """In bfloat16 the function runs in float32 on the widened inputs and
    rounds out and scores once, as the TPU kernel does: equal, bit for bit,
    to the float32 function on the same (bf16-exact) values, rounded."""
    args = _kernel_args(torch.bfloat16)
    dims = dict(n_heads=H, d_k=DK, d_v=DV, embed=True)
    o, s = tat_fused.tat_fused(*args, **dims)
    o32, s32 = tat_fused.tat_fused(*[t.float() for t in args], **dims)
    assert torch.equal(o, o32.bfloat16()) and torch.equal(s, s32.bfloat16())


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for embed in (True, False):
        cpu = _kernel_args()
        leaves = [[t.cuda().requires_grad_(True) for t in cpu] for _ in range(2)]
        dims = dict(n_heads=H, d_k=DK, d_v=DV, embed=embed)
        before = (tat_fused.fwd_launches, tat_fused.bwd_launches)
        o, s = tat_fused.tat_fused(*leaves[0], **dims)
        o_p, s_p = tat_fused.tat_fused_plain(*leaves[1], **dims)
        _loss(o, s, torch).backward()
        _loss(o_p, s_p, torch).backward()
        torch.cuda.synchronize()
        assert (tat_fused.fwd_launches, tat_fused.bwd_launches) == (before[0] + 1,
                                                                     before[1] + 1)
        torch.testing.assert_close(o, o_p, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(s, s_p, atol=1e-4, rtol=1e-4)
        for k, p in zip(leaves[0], leaves[1]):
            # without the embedding, pos and LN0 are off the plain path
            want = p.grad if p.grad is not None else torch.zeros_like(p)
            torch.testing.assert_close(k.grad, want, atol=2e-3, rtol=2e-3)
