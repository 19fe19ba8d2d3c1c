"""The port's Switch-MoE FFN (``dedloc_tpu_torch/parallel/moe.py``) against
the JAX package's ``moe_ffn`` on the same weights and tokens: the cases of
``tests/test_moe.py`` (per-token reference, capacity drops, balanced aux,
exact overflow fall-through, a starved expert, uneven token counts, the
hand-computed aux), the routing itself, the gradients of x, router, wi and
wo, and bf16. The index dispatch is held to the dense einsum plain version
bitwise in fp32."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.parallel import moe as jmoe
from dedloc_tpu_torch.parallel import moe

SMALL = dict(hidden_size=8, ffn_size=16, num_experts=4, capacity_factor=1.0)
# fp32 tolerances: y and aux 1e-5; gradients 1e-4 of each leaf's max |ref|
Y_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4
# bf16: 2e-2 of max |ref| on the tokens whose top-1/top-2 gate margin
# exceeds MARGIN (the two frameworks' fp32 router products may order a
# closer pair differently), and such tokens are at least 99% of them
BF16_TOL = 2e-2
MARGIN = 1e-5


def _cfgs(dtype_j=jnp.float32, dtype_t=torch.float32, **kw):
    kw = {**SMALL, **kw}
    return jmoe.MoEConfig(dtype=dtype_j, **kw), moe.MoEConfig(dtype=dtype_t, **kw)


def _jparams(cfg, seed, router=None):
    """Weights at ``init_moe_params``'s scales, drawn with numpy."""
    rng = np.random.default_rng(seed)
    h, f, e = cfg.hidden_size, cfg.ffn_size, cfg.num_experts
    draw = lambda shape, scale: (rng.normal(0, 1, shape) * scale).astype(np.float32)
    params = {"router": jnp.asarray(draw((h, e), h ** -0.5)),
              "wi": jnp.asarray(draw((e, h, f), h ** -0.5), cfg.dtype),
              "wo": jnp.asarray(draw((e, f, h), f ** -0.5), cfg.dtype)}
    if router is not None:
        params["router"] = jnp.asarray(router, jnp.float32)
    return params


def _tparams(jparams, dtype=torch.float32):
    out = {}
    for k, v in jparams.items():
        t = torch.from_numpy(np.array(jnp.asarray(v, jnp.float32)))
        out[k] = t if k == "router" else t.to(dtype)
    return out


@functools.partial(jax.jit, static_argnums=2)
def _jax_routing_jit(params, x, cfg):
    gates = jax.nn.softmax(x.astype(jnp.float32) @ params["router"], axis=-1)
    idx = jnp.argmax(gates, axis=-1)
    assign = jax.nn.one_hot(idx, cfg.num_experts, dtype=jnp.float32)
    position = (jnp.cumsum(assign, axis=0) * assign - 1.0).max(axis=-1)
    return idx, position, gates


def _jax_routing(params, x, cfg):
    """The JAX layer's routing, step for step (parallel/moe.py:91-102)."""
    idx, position, gates = _jax_routing_jit(params, x, cfg)
    return np.asarray(idx), np.asarray(position).astype(np.int64), np.asarray(gates)


def _run_jax(params, x, cfg, **jit_kw):
    y, aux = jax.jit(lambda p, v: jmoe.moe_ffn(p, v, cfg), **jit_kw)(params, x)
    return np.asarray(jnp.asarray(y, jnp.float32)), float(aux)


def _run_port(fn, params, x, cfg):
    y, aux = fn(params, x, cfg)
    return y.float().numpy(), float(aux)


def _tokens(rng, t, h, scale=1.0, positive=False):
    x = rng.normal(0, scale, (t, h)).astype(np.float32)
    return np.abs(x) + 0.1 if positive else x


def _forced(cfg, expert):
    r = np.zeros((cfg.hidden_size, cfg.num_experts), np.float32)
    r[:, expert] = 10.0
    return r


# (name, config overrides, seed, tokens, router): the cases of tests/test_moe.py
CASES = {
    "per_token_reference": (dict(), 0, lambda rng: _tokens(rng, 12, 8), None),
    "capacity_drops": (dict(hidden_size=4, ffn_size=8, num_experts=2,
                            capacity_factor=0.5), 1,
                       lambda rng: np.ones((4, 4), np.float32), 0),
    "overflow_fall_through": (dict(hidden_size=4, ffn_size=8, num_experts=2), 5,
                              lambda rng: _tokens(rng, 6, 4, positive=True), 0),
    "starved_experts": (dict(hidden_size=4, ffn_size=8, capacity_factor=2.0), 6,
                        lambda rng: _tokens(rng, 8, 4, positive=True), 1),
    "uneven_random": (dict(hidden_size=4, ffn_size=8), 7,
                      lambda rng: _tokens(rng, 13, 4), None),
    "uneven_one_expert": (dict(hidden_size=4, ffn_size=8), 7,
                          lambda rng: np.full((13, 4), 3.0, np.float32), None),
    "uneven_wide": (dict(hidden_size=4, ffn_size=8), 7,
                    lambda rng: _tokens(rng, 13, 4, scale=5.0), None),
    "many_tokens": (dict(hidden_size=32, ffn_size=64, capacity_factor=1.25), 9,
                    lambda rng: _tokens(rng, 256, 32), None),
}


@functools.lru_cache(maxsize=None)
def _made(name):
    over, seed, make_x, forced = CASES[name]
    jcfg, tcfg = _cfgs(**over)
    router = None if forced is None else _forced(jcfg, forced)
    jp = _jparams(jcfg, seed, router)
    return jcfg, tcfg, jp, make_x(np.random.default_rng(seed))


def _case(name):
    jcfg, tcfg, jp, x = _made(name)
    return jcfg, tcfg, jp, _tparams(jp), x.copy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_routing_equals_jax_exactly(name):
    jcfg, tcfg, jp, tp, x = _case(name)
    idx, pos, _gates = _jax_routing(jp, jnp.asarray(x), jcfg)
    r = moe.route(tp["router"], torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(r.expert.numpy(), idx)
    np.testing.assert_array_equal(r.position.numpy(), pos)
    assert r.capacity == max(1, math.ceil(x.shape[0] / jcfg.num_experts
                                          * jcfg.capacity_factor))
    np.testing.assert_array_equal(r.keep.numpy(), pos < r.capacity)


@pytest.mark.parametrize("fn", ["moe_ffn", "moe_ffn_dense"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fp32_y_and_aux_match_jax(name, fn):
    jcfg, tcfg, jp, tp, x = _case(name)
    want_y, want_aux = _run_jax(jp, jnp.asarray(x), jcfg)
    got_y, got_aux = _run_port(getattr(moe, fn), tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got_y, want_y, **Y_TOL)
    assert got_aux == pytest.approx(want_aux, rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_index_dispatch_equals_dense_plain_version_bitwise(name):
    _jcfg, tcfg, _jp, tp, x = _case(name)
    xt = torch.from_numpy(x)
    y_i, aux_i = moe.moe_ffn(tp, xt, tcfg)
    y_d, aux_d = moe.moe_ffn_dense(tp, xt, tcfg)
    assert torch.equal(y_i, y_d)
    assert torch.equal(aux_i, aux_d)


def test_capacity_drops_give_zeros_after_the_first_token():
    jcfg, tcfg, jp, tp, x = _case("capacity_drops")
    y, _ = moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    assert bool((y[0] != 0).any())
    assert torch.equal(y[1:], torch.zeros_like(y[1:]))


def test_overflow_fall_through_is_exactly_the_tokens_past_capacity():
    jcfg, tcfg, jp, tp, x = _case("overflow_fall_through")
    y, _ = moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    capacity = moe.capacity_for(x.shape[0], tcfg)
    assert capacity == 3
    assert bool((y[:capacity] != 0).any(dim=-1).all())
    assert torch.equal(y[capacity:], torch.zeros_like(y[capacity:]))


def test_balanced_router_gives_aux_one():
    jcfg, tcfg = _cfgs(hidden_size=4, ffn_size=8, capacity_factor=1.25)
    jp = _jparams(jcfg, 2, np.zeros((4, 4), np.float32))
    x = np.random.default_rng(0).normal(0, 1, (16, 4)).astype(np.float32)
    _, aux = moe.moe_ffn(_tparams(jp), torch.from_numpy(x), tcfg)
    assert float(aux) == pytest.approx(1.0, rel=1e-5)
    assert float(aux) == pytest.approx(_run_jax(jp, jnp.asarray(x), jcfg)[1],
                                       rel=1e-6)


def test_aux_matches_hand_computed_batch():
    jcfg, tcfg = _cfgs(hidden_size=2, ffn_size=4, num_experts=2,
                       capacity_factor=1.25)
    jp = _jparams(jcfg, 8, np.array([[2.0, 0.0], [0.0, 2.0]], np.float32))
    x = np.array([[1, 0], [1, 0], [1, 0], [0, 1]], np.float32)
    _, aux = moe.moe_ffn(_tparams(jp), torch.from_numpy(x), tcfg)
    q = math.exp(2.0) / (math.exp(2.0) + 1.0)
    proxy = [(3 * q + (1 - q)) / 4, (3 * (1 - q) + q) / 4]
    assert float(aux) == pytest.approx(2.0 * (0.75 * proxy[0] + 0.25 * proxy[1]),
                                       rel=1e-5)


def _port_grads(fn, tp, x, cfg):
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = fn(leaves, xt, cfg)
    loss = (y.float() ** 2).mean() + 0.01 * aux
    grads = torch.autograd.grad(loss, [xt] + [leaves[k] for k in ("router", "wi", "wo")])
    return dict(zip(("x", "router", "wi", "wo"), (g.numpy() for g in grads)))


def _jax_grads(jp, x, cfg):
    def loss(p, v):
        y, aux = jmoe.moe_ffn(p, v, cfg)
        return jnp.mean(y ** 2) + 0.01 * aux

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    return {"x": np.asarray(gx), **{k: np.asarray(gp[k]) for k in ("router", "wi", "wo")}}


@pytest.mark.parametrize("fn", ["moe_ffn", "moe_ffn_dense"])
@pytest.mark.parametrize("name", ["per_token_reference", "starved_experts",
                                  "uneven_random", "many_tokens"])
def test_fp32_gradients_match_jax(name, fn):
    jcfg, tcfg, jp, tp, x = _case(name)
    want = _jax_grads(jp, x, jcfg)
    got = _port_grads(getattr(moe, fn), tp, x, tcfg)
    for leaf in ("x", "router", "wi", "wo"):
        scale = np.abs(want[leaf]).max()
        assert scale > 0, f"no gradient reached {leaf}"
        np.testing.assert_allclose(got[leaf], want[leaf], rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale, err_msg=leaf)


def test_starved_experts_get_exactly_zero_expert_gradients():
    _jcfg, tcfg, _jp, tp, x = _case("starved_experts")
    got = _port_grads(moe.moe_ffn, tp, x, tcfg)
    for e in (0, 2, 3):
        assert not got["wi"][e].any() and not got["wo"][e].any()
    assert got["wi"][1].any() and got["router"].any()
    starved = dict(tp, wi=tp["wi"].clone())
    starved["wi"][[0, 2, 3]] = 0.0
    y, _ = moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    y2, _ = moe.moe_ffn(starved, torch.from_numpy(x), tcfg)
    assert torch.equal(y, y2)


def test_bf16_matches_jax_on_tokens_with_a_gate_margin():
    jcfg, tcfg = _cfgs(jnp.bfloat16, torch.bfloat16, hidden_size=32,
                       ffn_size=64, capacity_factor=1.25)
    jp = _jparams(jcfg, 11)
    x = np.random.default_rng(11).normal(0, 1, (512, 32)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, want_aux = _run_jax(jp, xb, jcfg, compiler_options={
        "xla_allow_excess_precision": False})
    _idx, _pos, gates = _jax_routing(jp, xb, jcfg)
    top2 = np.sort(gates, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN
    assert clear.mean() >= 0.99
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for fn in (moe.moe_ffn, moe.moe_ffn_dense):
        got, got_aux = fn(_tparams(jp, torch.bfloat16), xt, tcfg)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[clear], want[clear], rtol=0,
                                   atol=BF16_TOL * scale)
        assert got_aux == pytest.approx(want_aux, rel=1e-5)


def test_a_mesh_is_refused_with_the_slice_named():
    _jcfg, tcfg, _jp, tp, x = _case("per_token_reference")
    for fn in (moe.moe_ffn, moe.moe_ffn_dense):
        with pytest.raises(NotImplementedError, match="parallel-axes slice"):
            fn(tp, torch.from_numpy(x), tcfg, mesh=object())


def test_init_moe_params_shapes_dtypes_and_scales():
    cfg = moe.MoEConfig(hidden_size=64, ffn_size=256, num_experts=4,
                        dtype=torch.bfloat16)
    p = moe.init_moe_params(cfg, torch.Generator().manual_seed(0))
    assert p["router"].shape == (64, 4) and p["router"].dtype == torch.float32
    assert p["wi"].shape == (4, 64, 256) and p["wi"].dtype == torch.bfloat16
    assert p["wo"].shape == (4, 256, 64) and p["wo"].dtype == torch.bfloat16
    assert float(p["wi"].float().std()) == pytest.approx(1 / 8, rel=0.05)
    assert float(p["wo"].float().std()) == pytest.approx(1 / 16, rel=0.05)
    again = moe.init_moe_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_the_router_product_refuses_tf32_on_the_card():
    """Routing is discrete: on the card the router's fp32 product refuses
    to run with TF32 on, and leaves the process-wide setting as it is."""
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            moe.check_ieee_fp32(torch.device("cuda"))
        assert torch.backends.cuda.matmul.allow_tf32 is True
        moe.check_ieee_fp32(torch.device("cpu"))
        torch.backends.cuda.matmul.allow_tf32 = False
        moe.check_ieee_fp32(torch.device("cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
