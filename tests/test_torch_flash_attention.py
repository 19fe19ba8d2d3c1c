"""The port's flash attention (plain versions on the CPU) against the JAX
package's ``flash_attention`` (its Pallas kernels in interpret mode): forward
and q/k/v gradients from the same numpy inputs, through both JAX backward
paths (the single-tile fused kernel and the split dq / dk-dv kernels)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.ops.flash_attention import _fwd as jax_fwd
from dedloc_tpu.ops.flash_attention import _unpack_heads
from dedloc_tpu.ops.flash_attention import flash_attention as jax_flash
from dedloc_tpu_torch.ops import flash_attention as port

TOL = dict(atol=2e-5, rtol=2e-5)  # fp32, as tests/test_flash_attention.py


def _inputs(seed, b=2, s=128, h=2, d=32, mask="none"):
    rng = np.random.default_rng(seed)
    shape = (b, s, h, d)
    arrs = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("q", "k", "v", "w")}
    keep = np.ones((b, s), np.float32)
    if mask == "padding":
        keep[0, s - 38:] = 0.0  # a short sample
        keep[1, :] = 0.0  # an all-padding sample: every key masked
    arrs["bias"] = np.where(keep > 0, 0.0, -1e9).astype(np.float32)
    return arrs


def _jax(inp, block_q, block_k):
    q, k, v, bias, w = (jnp.asarray(inp[n]) for n in ("q", "k", "v", "bias", "w"))

    out, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, bias, block_q=block_q,
                                  block_k=block_k), q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(w)]


def _torch(inp):
    q, k, v = (torch.tensor(inp[n]).requires_grad_() for n in ("q", "k", "v"))
    out = port.flash_attention(q, k, v, torch.tensor(inp["bias"]))
    (out * torch.tensor(inp["w"])).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize(
    "s,block_q,block_k,mask",
    [
        # one tile covers the sequence: the fused single-tile backward
        (128, 128, 128, "none"),
        (128, 128, 128, "padding"),
        # the same path at the blocks of tests/test_flash_attention.py
        (64, 64, 64, "padding"),
        # split dq / dk-dv backward, online softmax over several tiles
        (128, 32, 16, "none"),
        (128, 32, 16, "padding"),
    ],
)
def test_matches_jax_forward_and_grads(s, block_q, block_k, mask):
    inp = _inputs(0, s=s, mask=mask)
    out_j, g_j = _jax(inp, block_q, block_k)
    out_t, g_t = _torch(inp)
    np.testing.assert_allclose(out_t, out_j, **TOL, err_msg="out")
    for a, b, name in zip(g_t, g_j, "qkv"):
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"d{name}")


def test_all_masked_sample_averages_v_uniformly():
    """With the finite -1e9 bias and no -inf special case, a sample whose
    keys are all masked attends uniformly (as the TPU kernel does)."""
    inp = _inputs(1, mask="padding")
    out, _ = port.flash_fwd(*(torch.tensor(inp[n]) for n in ("q", "k", "v", "bias")))
    uniform = inp["v"][1].mean(axis=0, keepdims=True)
    np.testing.assert_allclose(out[1].numpy(), np.broadcast_to(uniform, out[1].shape),
                               atol=1e-5, rtol=1e-5)


def test_lse_matches_dense_logsumexp():
    inp = _inputs(2, s=64, mask="padding")
    q, k, v, bias = (torch.tensor(inp[n]) for n in ("q", "k", "v", "bias"))
    _, lse = port.flash_fwd(q, k, v, bias)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    ref = torch.logsumexp(s + bias[:, None, None, :], dim=-1)
    torch.testing.assert_close(lse, ref.reshape(-1, 64), atol=1e-5, rtol=1e-5)


def test_bfloat16_forward_matches_jax():
    inp = _inputs(3, mask="padding")
    q, k, v = (jnp.asarray(inp[n], jnp.bfloat16) for n in ("q", "k", "v"))
    out_j = jax_flash(q, k, v, jnp.asarray(inp["bias"]), block_q=128, block_k=128)
    out_t = port.flash_attention(
        *(torch.tensor(inp[n]).bfloat16() for n in ("q", "k", "v")),
        torch.tensor(inp["bias"]))
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)


def test_bias_gets_a_zero_gradient():
    inp = _inputs(4, s=16)
    q, k, v = (torch.tensor(inp[n]) for n in ("q", "k", "v"))
    bias = torch.tensor(inp["bias"]).requires_grad_()
    port.flash_attention(q, k, v, bias).sum().backward()
    assert bias.grad is not None and not bias.grad.any()


def _assert_close_per_sample(got, want, tol, name):
    """|got - want| <= tol * max|want[b]| + tol * |want| in every sample b, as
    chip_smoke.py's check_per_sample: an all-padding sample's gradients are
    hundreds of times a real sample's, so one atol for the batch would leave
    the real samples unchecked."""
    ref = np.abs(want)
    atol = tol * ref.reshape(ref.shape[0], -1).max(axis=1).reshape(-1, 1, 1, 1)
    err = np.abs(got - want)
    bad = err > atol + tol * ref
    assert not bad.any(), (f"{name}: {int(bad.sum())} elements beyond tolerance, "
                           f"max abs err {err.max():.3e}")


@pytest.mark.parametrize(
    "s,block_q,block_k,mask",
    [
        # the fused single-tile backward (the S=512 path's JAX kernel)
        (128, 128, 128, "none"),
        (128, 128, 128, "padding"),
        # the split dq / dk-dv backward (the S=16,384 path's JAX kernels)
        (128, 32, 16, "none"),
        (128, 32, 16, "padding"),
    ],
)
def test_bfloat16_backward_matches_jax(s, block_q, block_k, mask):
    """The port's plain backward in bf16 (the function the card's kernels
    are held to) against JAX's flash_attention vjp in bf16, Pallas kernels
    in interpret mode; bf16 tolerance of the forward test, per sample."""
    inp = _inputs(5, s=s, mask=mask)
    bias = jnp.asarray(inp["bias"])
    qj, kj, vj, wj = (jnp.asarray(inp[n], jnp.bfloat16) for n in ("q", "k", "v", "w"))
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, bias, block_q=block_q,
                                               block_k=block_k), qj, kj, vj)
    g_j = [np.asarray(g.astype(jnp.float32)) for g in vjp(wj)]

    qt, kt, vt = (torch.tensor(inp[n]).bfloat16().requires_grad_() for n in ("q", "k", "v"))
    out = port.flash_attention(qt, kt, vt, torch.tensor(inp["bias"]))
    g_t = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(inp["w"]).bfloat16())
    for got, want, name in zip(g_t, g_j, "qkv"):
        assert got.dtype == torch.bfloat16
        _assert_close_per_sample(got.float().numpy(), want, 3e-2, f"d{name}")


@pytest.mark.parametrize("tile", [port.FWD_TILE, port.BWD_TILE], ids=["forward", "backward"])
def test_check_common_limits_s_to_the_grid(tile):
    """The grids are (B*H, S / tile) with y at most 65535: the wrappers'
    check takes S up to 65535 tiles of the kernel's tile size and refuses
    one row more. It reads only metadata, so CPU tensors stand in."""
    def inputs(s):
        x = torch.empty((1, 1, 1, 64), dtype=torch.bfloat16).expand(1, s, 1, 64)
        return x, x, x, torch.empty((1, s), dtype=torch.float32)

    most = port.MAX_GRID_Y * tile
    assert port._check_common(*inputs(most), tile) == (1, most, 1, 64)
    with pytest.raises(ValueError, match=f"at most {port.MAX_GRID_Y} tiles of {tile}"):
        port._check_common(*inputs(most + 1), tile)


KERNEL_KEY_TILE = 128  # keys per streamed tile of the forward kernel (FWD_BK)


def _forward_kernel_replay(q, k, v, bias, key_tile=KERNEL_KEY_TILE):
    """The CUDA forward's arithmetic on the CPU, one key tile at a time:
    s = q.k * scale + bias in fp32 (keys past S padded with zero K/V rows
    and a -inf bias, as the kernel's TMA zero fill and bias row); the true
    running max from -1e30; base-2 exps with the difference taken first;
    l and O rescaled by the correction; p rounded to bf16 before P.V; the
    final division. Returns (out in q's dtype, lse [B*H, S])."""
    b, s, h, d = q.shape
    scale, log2e = 1.0 / d ** 0.5, 1.4426950408889634
    n = -(-s // key_tile) * key_tile
    pad = lambda x: torch.nn.functional.pad(port._heads_first(x), (0, 0, 0, n - s))
    qh, kh, vh = port._heads_first(q), pad(k), pad(v)
    kb = torch.nn.functional.pad(bias.float(), (0, n - s), value=-float("inf"))
    m = torch.full((b, h, s, 1), port.NEG_INF)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, n, key_tile):
        cols = slice(k0, k0 + key_tile)
        sc = qh @ kh[:, :, cols].transpose(-1, -2) * scale + kb[:, None, None, cols]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * log2e)
        p = torch.exp2((sc - m_new) * log2e)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.bfloat16().float() @ vh[:, :, cols]
        m = m_new
    safe_l = l.clamp_min(1e-30)
    out = (acc / safe_l).to(q.dtype).permute(0, 2, 1, 3)
    return out, (m + torch.log(safe_l)).reshape(b * h, s)


@pytest.mark.parametrize("d", [64, 128])
def test_forward_kernel_algorithm_matches_jax_bfloat16(d):
    """The forward kernel's tile-by-tile arithmetic against JAX's forward
    (``_fwd``, Pallas in interpret mode) in bf16 at S=300, ragged against
    the key tile, with a short sample and an all-padding sample (which
    averages V uniformly); bf16 per-sample tolerance of the tests above."""
    inp = _inputs(6, s=300, d=d, mask="padding")
    b, s, h, _ = inp["q"].shape
    to3 = lambda x: jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1, 3).reshape(b * h, s, d)
    bias3 = jnp.broadcast_to(jnp.asarray(inp["bias"])[:, None, :], (b, h, s)).reshape(b * h, 1, s)
    out3, lse_j = jax_fwd(to3(inp["q"]), to3(inp["k"]), to3(inp["v"]), bias3, 100, 100, True)
    out_j = np.asarray(_unpack_heads(out3, b * h, d).astype(jnp.float32))
    out_j = out_j.reshape(b, h, s, d).transpose(0, 2, 1, 3)

    out, lse = _forward_kernel_replay(
        *(torch.tensor(inp[n]).bfloat16() for n in ("q", "k", "v")), torch.tensor(inp["bias"]))
    assert out.dtype == torch.bfloat16
    _assert_close_per_sample(out.float().numpy(), out_j, 3e-2, "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j).reshape(b * h, s),
                               atol=1e-3, rtol=1e-5, err_msg="lse")
    # the all-padding sample: p = 1 for every key, a uniform average of V
    v_mean = torch.tensor(inp["v"][1]).bfloat16().float().mean(dim=0)
    torch.testing.assert_close(out[1].float(), v_mean.expand_as(out[1]), atol=1e-2, rtol=1e-2)
