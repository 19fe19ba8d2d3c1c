"""The port's flat LAMB apply against the JAX package's, the per-leaf
chain, the guarded rollback, and the shared-state names of the optax
chain."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.averaging.device_flat import DeviceFlatPipeline as JaxPipeline
from dedloc_tpu.averaging.partition import TreeLayout
from dedloc_tpu.collaborative.optimizer import _tree_to_named
from dedloc_tpu.core.config import CollaborationArguments
from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.models.albert import AlbertForPreTraining as JaxModel
from dedloc_tpu.optim.lamb import lamb as jax_lamb
from dedloc_tpu.optim.schedules import linear_warmup_linear_decay as jax_linear
from dedloc_tpu.parallel import train_step as jax_ts
from dedloc_tpu.roles import common as jax_common
from dedloc_tpu_torch.core.config import TrainingArguments
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.optim.flat import (
    expand_segments,
    segment_sizes,
    segment_sumsq,
    spec_spans,
)
from dedloc_tpu_torch.optim.lamb import Lamb
from dedloc_tpu_torch.optim.schedules import linear_warmup_linear_decay
from dedloc_tpu_torch.parallel.train_step import (
    TrainState,
    make_flat_apply_step,
    make_guarded_apply_step,
)
from dedloc_tpu_torch.roles.common import build_flat_opt_factory, build_optimizer

RECIPE = dict(learning_rate=5e-2, warmup_steps=0, total_steps=10,
              weight_decay=0.01, max_grad_norm=1.0)
STEPS = 3
# as tests/test_torch_train_step.py: fp32 on both sides, differences from
# reduction order amplified slightly by the Adam direction m / sqrt(v)
TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def setup():
    """JAX ALBERT-tiny params, their wire spec, and 3 seeded flat gradient
    buffers in that spec's order (one with a large norm, so the global
    clip engages)."""
    params = JaxModel(JaxConfig.tiny(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    spec = JaxPipeline.for_tree(params).spec
    layout = TreeLayout(spec)
    rng = np.random.default_rng(1)
    flats = [rng.standard_normal(layout.total_size).astype(np.float32) * s
             for s in (1e-3, 3e-2, 1e-3)]
    return params, spec, flats


def _jax_args():
    args = CollaborationArguments()
    args.training = dataclasses.replace(args.training, **RECIPE)
    return args


@pytest.fixture(scope="module")
def jax_traj(setup):
    """The JAX package's flat apply, 3 steps: the full shared state (params
    and optax chain, JAX names) after each."""
    params, spec, flats = setup
    args = _jax_args()
    tx = jax_common.build_optimizer(args)
    fn = jax_ts.make_flat_apply_step(
        jax_common.build_flat_opt_factory(args)(spec, params), spec)
    state = jax_ts.TrainState.create(jax.tree.map(jnp.copy, params), tx)
    out = []
    for flat in flats:
        state, ok = fn(state, jnp.asarray(flat))
        assert bool(ok)
        out.append(_tree_to_named(jax.device_get((state.params, state.opt_state))))
    return out


def _port_state(params_jax):
    named = {jax.tree_util.keystr(p): np.asarray(x)
             for p, x in jax.tree_util.tree_flatten_with_path(params_jax)[0]}
    params = convert.params_from_jax(named)
    tx = build_optimizer(TrainingArguments(**RECIPE))
    return tx, TrainState.create(params, tx)


def _shared(state, tx):
    return convert.state_to_jax(state.params, state.opt_state,
                                clip=tx.max_grad_norm is not None,
                                schedule=tx.has_schedule)


@pytest.fixture(scope="module")
def port_flat_traj(setup):
    params, spec, flats = setup
    tx, state = _port_state(params)
    fn = make_flat_apply_step(
        build_flat_opt_factory(TrainingArguments(**RECIPE))(spec, state.params), spec)
    out = []
    for flat in flats:
        state, ok = fn(state, torch.from_numpy(flat))
        assert bool(ok)
        out.append(_shared(state, tx))
    return out


@pytest.mark.parametrize("step", range(STEPS))
def test_flat_apply_matches_jax(jax_traj, port_flat_traj, step):
    ours, theirs = port_flat_traj[step], jax_traj[step]
    assert sorted(ours) == sorted(theirs)
    for name, ref in theirs.items():
        assert ours[name].dtype == ref.dtype, name
        if ref.dtype == np.int32:
            assert ours[name] == ref, name
        else:
            np.testing.assert_allclose(ours[name], ref, **TOL, err_msg=f"{step} {name}")


def test_flat_apply_matches_the_per_leaf_chain(setup, port_flat_traj):
    """The guarded per-leaf apply (the port's Lamb) from the same state and
    gradients lands on the flat apply's state."""
    params, spec, flats = setup
    tx, state = _port_state(params)
    apply = make_guarded_apply_step(tx)
    layout = TreeLayout(spec)
    for step, flat in enumerate(flats):
        named = layout.unflatten(flat)
        grads = {}
        for name, p in state.params.items():
            jname, transpose = convert.grad_name(name, p.ndim)
            g = torch.from_numpy(np.array(named[jname]))
            grads[name] = g.t().contiguous() if transpose else g
        state, ok = apply(state, grads)
        assert bool(ok)
        ours = _shared(state, tx)
        for name, ref in port_flat_traj[step].items():
            np.testing.assert_allclose(ours[name], ref, atol=1e-6, rtol=1e-5,
                                       err_msg=f"{step} {name}")


@pytest.mark.parametrize("kind", ["flat", "leaf"])
def test_non_finite_update_rolls_back_bitwise(setup, kind):
    params, spec, flats = setup
    tx, state = _port_state(params)
    if kind == "flat":
        fn = make_flat_apply_step(
            build_flat_opt_factory(TrainingArguments(**RECIPE))(spec, state.params),
            spec, from_tree=True)
    else:
        fn = make_guarded_apply_step(tx)
    grads = {n: torch.full_like(p, 1e-3) for n, p in state.params.items()}
    state, ok = fn(state, grads)  # one good step: nonzero moments and counts
    assert bool(ok)
    before = {k: v.copy() for k, v in _shared(state, tx).items()}
    grads[next(iter(grads))][0] = float("nan")
    state, ok = fn(state, grads)
    assert not bool(ok)
    after = _shared(state, tx)
    for name, ref in before.items():
        assert after[name].tobytes() == ref.tobytes(), name
    assert int(state.step) == 1


def test_two_flat_applies_from_the_same_state_are_bitwise_equal(setup):
    params, spec, flats = setup
    results = []
    for _ in range(2):
        tx, state = _port_state(params)
        fn = make_flat_apply_step(
            build_flat_opt_factory(TrainingArguments(**RECIPE))(spec, state.params), spec)
        for flat in flats:
            state, _ok = fn(state, torch.from_numpy(flat))
        results.append(_shared(state, tx))
    for name in results[0]:
        assert results[0][name].tobytes() == results[1][name].tobytes(), name


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("schedule", [False, True])
def test_state_names_are_the_optax_chains(setup, clip, schedule):
    """``state_to_jax`` gives exactly the names, dtypes and shapes the JAX
    trainer shares for (params, lamb opt_state), and ``state_from_jax``
    carries them back bitwise."""
    params, _spec, _flats = setup
    lr_j = jax_linear(1e-3, 2, 10) if schedule else 1e-3
    lr_t = linear_warmup_linear_decay(1e-3, 2, 10) if schedule else 1e-3
    jtx = jax_lamb(lr_j, max_grad_norm=1.0 if clip else None)
    jstate = jtx.init(params)
    # nonzero moments and counts, so a swapped leaf would show
    jstate = jax.tree.map(
        lambda x: x + 3 if x.dtype == jnp.int32 else x + 0.25, jstate)
    theirs = _tree_to_named(jax.device_get((params, jstate)))
    ttx = Lamb(lr_t, max_grad_norm=1.0 if clip else None)
    assert ttx.has_schedule == schedule
    tparams, tstate = convert.state_from_jax(theirs)
    ours = convert.state_to_jax(tparams, tstate, clip=clip, schedule=schedule)
    assert sorted(ours) == sorted(theirs)
    for name, ref in theirs.items():
        assert ours[name].dtype == ref.dtype and ours[name].shape == ref.shape
        assert ours[name].tobytes() == np.asarray(ref).tobytes(), name
    assert tstate.count == 3 and tstate.schedule_count == (3 if schedule else 0)


def test_segment_reductions_are_per_leaf_norms():
    gen = torch.Generator().manual_seed(0)
    shapes = [(3, 4), (0,), (), (7,)]
    spec = [(f"l{i}", s, np.float32) for i, s in enumerate(shapes)]
    spans = spec_spans(spec)
    total = sum(s for _o, s in spans)
    flat = torch.randn(total, generator=gen)
    sumsq = segment_sumsq(flat, spans)
    for (o, s), got in zip(spans, sumsq):
        torch.testing.assert_close(got, (flat[o:o + s] ** 2).sum())
    expanded = expand_segments(torch.arange(4.0), segment_sizes(spans, "cpu"), total)
    assert expanded.tolist() == [0.0] * 12 + [2.0] + [3.0] * 7
