"""The port's ``blockwise_attention`` and ``dense_attention``
(``parallel/ring_attention.py``) against the JAX package's, from the same
numpy inputs: the output and the q/k/v gradients under a fixed random
cotangent, with and without padding, on block sizes that split the sequence
evenly, unevenly (JAX's ``S // block`` blocks of equal size) and not at
all."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.parallel import ring_attention as jax_ra
from dedloc_tpu_torch.parallel import ring_attention as port

# fp32: the same arithmetic up to summation order (as the flash tests)
TOL = dict(atol=2e-5, rtol=2e-5)
S = 96


def _inputs(seed, mask, b=2, h=2, d=16):
    rng = np.random.default_rng(seed)
    shape = (b, S, h, d)
    arrs = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("q", "k", "v", "w")}
    keep = np.ones((b, S), np.float32)
    if mask == "padding":
        keep[0, S - 29:] = 0.0  # a short sample
        keep[1, 40:] = 0.0
    arrs["bias"] = np.where(keep > 0, 0.0, -1e9).astype(np.float32)
    return arrs


def _call(mod, fn, block, q, k, v, bias):
    if fn == "dense":
        return mod.dense_attention(q, k, v, bias)
    return mod.blockwise_attention(q, k, v, bias, block_size=block)


def _jax(inp, fn, block, with_bias):
    q, k, v, w = (jnp.asarray(inp[n]) for n in ("q", "k", "v", "w"))
    bias = jnp.asarray(inp["bias"]) if with_bias else None
    out, vjp = jax.vjp(lambda q, k, v: _call(jax_ra, fn, block, q, k, v, bias),
                       q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(w)]


def _torch(inp, fn, block, with_bias):
    q, k, v = (torch.tensor(inp[n]).requires_grad_() for n in ("q", "k", "v"))
    bias = torch.tensor(inp["bias"]) if with_bias else None
    out = _call(port, fn, block, q, k, v, bias)
    (out * torch.tensor(inp["w"])).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize(
    "fn,block,mask",
    [
        ("blockwise", 32, "none"),  # 3 blocks of 32
        ("blockwise", 32, "padding"),
        ("blockwise", 40, "padding"),  # S // 40 = 2 blocks of 48
        ("blockwise", 16, "padding"),  # 6 blocks
        ("blockwise", 512, "padding"),  # one block covers the sequence
        ("blockwise", 32, "no bias"),
        ("dense", None, "none"),
        ("dense", None, "padding"),
        ("dense", None, "no bias"),
    ],
)
def test_matches_jax_forward_and_grads(fn, block, mask):
    inp = _inputs(0, mask)
    with_bias = mask != "no bias"
    out_j, g_j = _jax(inp, fn, block, with_bias)
    out_t, g_t = _torch(inp, fn, block, with_bias)
    np.testing.assert_allclose(out_t, out_j, **TOL, err_msg="out")
    for a, b, name in zip(g_t, g_j, "qkv"):
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"d{name}")

