"""The port's fused add+LayerNorm (plain versions on the CPU) against the JAX
package's ``ln_residual`` (its Pallas kernel in interpret mode): forward y,
and da/dgamma/dbeta through autograd, from the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.ops.fused_ln import ln_residual as jax_ln_residual
from dedloc_tpu_torch.ops import fused_ln as port

# fp32: the same fp32 arithmetic up to reduction order; bf16: one rounding
# of the output (and of x̂ for the backward) at bf16's 2^-8 relative step
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    h = shape[-1]
    return dict(
        x=rng.standard_normal(shape).astype(np.float32),
        r=rng.standard_normal(shape).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32),
        beta=(0.1 * rng.standard_normal(h)).astype(np.float32),
        w=rng.standard_normal(shape).astype(np.float32),
    )


def _jax(inp, dtype):
    x, r = (jnp.asarray(inp[k], dtype) for k in ("x", "r"))
    gamma, beta, w = (jnp.asarray(inp[k]) for k in ("gamma", "beta", "w"))

    def loss(x, r, g, b):
        return jnp.sum(jax_ln_residual(x, r, g, b, block_n=16)
                       .astype(jnp.float32) * w)

    y = jax_ln_residual(x, r, gamma, beta, block_n=16)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(x, r, gamma, beta)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    return f32(y), [f32(g) for g in grads]


def _torch(inp, dtype):
    x, r = (torch.tensor(inp[k]).to(dtype).requires_grad_() for k in ("x", "r"))
    gamma, beta = (torch.tensor(inp[k]).requires_grad_() for k in ("gamma", "beta"))
    y = port.ln_residual(x, r, gamma, beta)
    (y.float() * torch.tensor(inp["w"])).sum().backward()
    f32 = lambda t: t.detach().float().numpy()
    return f32(y), [f32(t.grad) for t in (x, r, gamma, beta)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 256), (4, 12, 96)])
def test_matches_jax_forward_and_grads(shape, dtype):
    """Leading dimensions and an H that is not a power of two included."""
    inp = _inputs(0, shape)
    y_j, g_j = _jax(inp, getattr(jnp, dtype))
    y_t, g_t = _torch(inp, getattr(torch, dtype))
    assert y_t.shape == shape
    np.testing.assert_allclose(y_t, y_j, **TOL[dtype], err_msg="y")
    for a, b, name in zip(g_t, g_j, ["dx", "dr", "dgamma", "dbeta"]):
        np.testing.assert_allclose(a, b, **TOL[dtype], err_msg=name)


def test_y_only_variant_without_grad():
    """Under no_grad the y-only forward runs and gives the same y."""
    inp = _inputs(1, (32, 64))
    args = [torch.tensor(inp[k]) for k in ("x", "r", "gamma", "beta")]
    with torch.no_grad():
        y = port.ln_residual(*args)
    y_full, xhat, rstd = port.ln_fwd(*args, eps=1e-12)
    assert xhat is not None and rstd.shape == (32,)
    y_only, none_xhat, none_rstd = port.ln_fwd(*args, eps=1e-12,
                                               with_residuals=False)
    assert none_xhat is None and none_rstd is None
    torch.testing.assert_close(y, y_full, rtol=0, atol=0)
    torch.testing.assert_close(y_only, y_full, rtol=0, atol=0)
    y_j = jax_ln_residual(*(jnp.asarray(inp[k]) for k in ("x", "r", "gamma", "beta")),
                          block_n=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)


def test_residual_branches_get_identical_cotangent():
    inp = _inputs(2, (16, 32))
    x, r = (torch.tensor(inp[k]).requires_grad_() for k in ("x", "r"))
    y = port.ln_residual(x, r, torch.tensor(inp["gamma"]), torch.tensor(inp["beta"]))
    (y ** 2).sum().backward()
    torch.testing.assert_close(x.grad, r.grad, rtol=0, atol=0)


def test_xhat_is_stored_in_the_input_dtype():
    """The backward reads x̂ back in bf16 (as the TPU kernel stores it) and
    rstd in fp32, rather than recomputing them."""
    inp = _inputs(3, (8, 64))
    x, r = (torch.tensor(inp[k]).bfloat16() for k in ("x", "r"))
    _, xhat, rstd = port.ln_fwd(x, r, torch.tensor(inp["gamma"]),
                                torch.tensor(inp["beta"]), eps=1e-12)
    assert xhat.dtype == torch.bfloat16 and rstd.dtype == torch.float32
