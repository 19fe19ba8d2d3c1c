"""The port's expert-parallel Switch FFN (``parallel/moe.py`` with a mesh),
mirroring the JAX package's tests/test_moe.py:72: experts split over 4
gloo ranks of an expert axis equal the one-device layer (outputs, aux and
every gradient); a dp=2 case whose router sends every token to one expert,
where only the slice's capacity and running positions (an exclusive prefix
of the counts over the data shards) keep the right tokens; and the tiny
ALBERT-MoE on a dp2 x ep2 mesh against the JAX trainer's slice over 2
LAMB steps."""
import jax
import numpy as np
import pytest
import torch

from dedloc_tpu.parallel.mesh import make_mesh
from dedloc_tpu.parallel.moe import MoEConfig as JaxMoEConfig
from dedloc_tpu.parallel.moe import init_moe_params
from dedloc_tpu.parallel.moe import moe_ffn as jax_moe_ffn
from dedloc_tpu_torch.parallel import moe as pm
from torch_mesh_jax import (
    assert_matches_jax,
    assert_replicas_bitwise,
    batches,
    jax_steps,
    port_inputs,
    weights,
)
from torch_mesh_ranks import run_ranks

CFG = dict(hidden_size=8, ffn_size=16, num_experts=4, capacity_factor=1.0)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(0)
    params = {k: np.asarray(v) for k, v in
              init_moe_params(JaxMoEConfig(**CFG), jax.random.PRNGKey(3)).items()}
    x = rng.normal(0, 1, (16, 8)).astype(np.float32)
    # every token onto expert 0 (positive tokens keep the forced logit
    # 10 * sum(x_row) positive)
    skew = np.zeros_like(params["router"])
    skew[:, 0] = 10.0
    x_skew = (np.abs(rng.normal(0, 1, (16, 8))) + 0.1).astype(np.float32)
    inputs = dict(cfg=CFG, params=params, x=x, router_skew=skew, x_skew=x_skew)
    out = run_ranks(tmp_path_factory.mktemp("moe"), 4, "moe", inputs)
    return inputs, out


def _one_device(inputs, router=None, x=None):
    cfg = pm.MoEConfig(**CFG)
    p = {k: torch.tensor(np.array(v)).requires_grad_() for k, v in inputs["params"].items()}
    if router is not None:
        p["router"] = torch.from_numpy(router).requires_grad_()
    xt = torch.from_numpy(inputs["x"] if x is None else x).clone().requires_grad_()
    y, aux = pm.moe_ffn(p, xt, cfg)
    grads = torch.autograd.grad((y ** 2).mean() + aux, [p["router"], p["wi"], p["wo"], xt])
    return y.detach().numpy(), float(aux.detach()), [g.numpy() for g in grads]


def test_moe_expert_sharded_matches_local(case):
    inputs, out = case
    y, aux, grads = _one_device(inputs)
    mesh = make_mesh(4, axis_names=("expert",))
    jy, jaux = jax.jit(lambda p, v: jax_moe_ffn(p, v, JaxMoEConfig(**CFG), mesh=mesh))(
        inputs["params"], inputs["x"])
    for rank, o in enumerate(out):
        assert o["wi_shape"] == (1, 8, 16)
        np.testing.assert_allclose(o["y"], y, rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(o["y"], np.asarray(jy), rtol=2e-5, atol=1e-6)
        assert o["aux"] == pytest.approx(aux, rel=1e-6)
        assert o["aux"] == pytest.approx(float(jaux), rel=1e-5)
        g_router, g_wi, g_wo, g_x = o["grads"]
        np.testing.assert_allclose(g_router, grads[0], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(g_wi, grads[1][rank:rank + 1], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(g_wo, grads[2][rank:rank + 1], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(g_x, grads[3], rtol=1e-4, atol=1e-7)


def test_skewed_routing_keeps_the_slices_first_tokens(case):
    inputs, out = case
    cfg = pm.MoEConfig(**CFG)
    x = torch.from_numpy(inputs["x_skew"])
    r = pm.route(torch.from_numpy(inputs["router_skew"]), x, cfg)
    assert r.capacity == 4 and int(r.keep.sum()) == 4  # tokens 0-3 only
    y, aux, _ = _one_device(inputs, inputs["router_skew"], inputs["x_skew"])
    for o in out:
        d = o["coords_dm"]["data"]
        expert, position, keep, capacity, got_aux = o["skew_route"]
        rows = slice(8 * d, 8 * d + 8)
        assert capacity == r.capacity
        np.testing.assert_array_equal(expert, r.expert.numpy()[rows])
        np.testing.assert_array_equal(position, r.position.numpy()[rows])
        np.testing.assert_array_equal(keep, r.keep.numpy()[rows])
        # a shard routing alone would keep ceil(8 / 4) = 2 of its own tokens
        assert int(keep.sum()) == (4 if d == 0 else 0)
        assert got_aux == pytest.approx(aux, rel=1e-6)
        np.testing.assert_allclose(o["skew_y"], y[rows], rtol=2e-5, atol=1e-7)


def test_albert_moe_dp2_ep2_matches_jax(tmp_path):
    extra = dict(moe_experts=4)
    w, b = weights(**extra), batches()
    axes, shape = ("data", "expert"), (2, 2)
    ref = jax_steps(axes, shape, w, b, cfg=extra)
    outs = run_ranks(tmp_path, 4, "albert_steps", port_inputs(axes, shape, w, b, cfg=extra))
    assert_matches_jax(outs[0], ref)
    assert_replicas_bitwise(outs, axes, shape)
    assert outs[0]["shapes"]["albert.encoder.layer.block.moe_wi"] == (2, 32, 64)
