"""The port's LARS against the JAX package's: the per-leaf ``Lars`` over 3
steps of a warmup-cosine schedule (a zero-norm leaf, clip on and off), the
guarded apply, ``FlatLars`` through the flat apply (with and without the
prototype ``post_apply``) against the per-leaf one, the NaN rollback, the
cosine schedule's 0-d tensor path, and SwAV's local fused step with LARS."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.optim.flat import FlatLars as JaxFlatLars
from dedloc_tpu.optim.lars import lars as jax_lars
from dedloc_tpu.optim.schedules import linear_warmup_cosine_annealing as jax_cosine
from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models.swav import make_prototype_post_apply
from dedloc_tpu_torch.optim.flat import FlatLars, spec_spans
from dedloc_tpu_torch.optim.lars import Lars, LarsState
from dedloc_tpu_torch.optim.schedules import linear_warmup_cosine_annealing
from dedloc_tpu_torch.parallel.train_step import (
    FlatLayout,
    TrainState,
    make_apply_step,
    make_flat_apply_step,
    make_guarded_apply_step,
)
from test_torch_swav import (  # noqa: E402
    GRAD_FLOOR,
    GRAD_RTOL,
    B,
    JaxSpec,
    _fp32_cfg,
    _pair,
    _rel,
    _tree_to_named,
    jax_batches,
    jswav,
    swav,
)

STEPS = 3
SCHEDULE = (0.3, 2, 10)  # peak lr, warmup steps, total steps: lr 0 at step 0
# fp32 on both sides; the per-layer norms sum in different orders and the
# schedule's cos differs by at most one ulp between numpy, torch and XLA:
# params and momentum within 1e-6 relative of each leaf's largest |ref|
RTOL = 1e-6
# the schedule's tensor path against its numpy path (and JAX's): the same
# float32 operations but cos, which may differ by one ulp (2^-23 near -1,
# where 1 + cos cancels): within 2e-7 relative or that ulp times the
# cosine's amplitude 0.5 x peak lr
SCHED_RTOL = 2e-7


def _tree(seed=0):
    """{name: array}: a kernel, a bias, a zero leaf (norm 0: the rate falls
    back to lr) and a conv kernel."""
    rng = np.random.default_rng(seed)
    return {"dense": rng.standard_normal((5, 3)).astype(np.float32),
            "bias": rng.standard_normal(7).astype(np.float32) * 0.1,
            "zero": np.zeros(4, np.float32),
            "conv": rng.standard_normal((3, 2, 3, 3)).astype(np.float32) * 0.2}


def _grads(seed):
    return {k: v * 0.5 + 0.01 for k, v in _tree(seed + 1).items()}


@pytest.mark.parametrize("clip", [True, False])
def test_lars_matches_jax_over_three_steps(clip):
    params = _tree()
    jtx = jax_lars(jax_cosine(*SCHEDULE), weight_decay=1e-4, clip=clip)
    ttx = Lars(linear_warmup_cosine_annealing(*SCHEDULE), weight_decay=1e-4, clip=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ttx.init(tp)
    apply = make_apply_step(ttx)
    state = TrainState(step=0, params=tp, opt_state=tstate)
    for step in range(STEPS):
        g = _grads(step)
        updates, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        state = apply(state, {k: torch.from_numpy(v) for k, v in g.items()})
        assert state.opt_state.schedule_count == int(jstate[1].count) == step + 1
        for k in params:
            _rel(state.params[k].numpy(), jp[k], RTOL)
            _rel(state.opt_state.momentum[k].numpy(), jstate[0].momentum[k], RTOL)


def test_guarded_apply_matches_jax():
    """The guarded per-leaf apply (counts on the device, the schedule's
    tensor path) lands where the JAX chain does."""
    params = _tree(3)
    jtx = jax_lars(jax_cosine(*SCHEDULE), weight_decay=1e-4)
    ttx = Lars(linear_warmup_cosine_annealing(*SCHEDULE), weight_decay=1e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = TrainState.create(tp, ttx)
    apply = make_guarded_apply_step(ttx)
    for step in range(STEPS):
        g = _grads(step + 3)
        updates, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        state, ok = apply(state, {k: torch.from_numpy(v) for k, v in g.items()})
        assert bool(ok) and int(state.step) == step + 1
        assert int(state.opt_state.schedule_count) == int(jstate[1].count)
        for k in params:
            _rel(state.params[k].numpy(), jp[k], RTOL)


@pytest.fixture(scope="module")
def swav_setup():
    """The tiny SwAV model's params (conv kernels included), the wire spec
    of its gradients, and 3 seeded flat gradient buffers in that order."""
    _jm, _vars, model, _stats = _pair(jswav.SwAVConfig.tiny(), swav.SwAVConfig.tiny(),
                                      seed=4)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    spec = DeviceFlatPipeline.for_tree(params).spec
    total = sum(int(np.prod(s)) for _n, s, _d in spec)
    rng = np.random.default_rng(5)
    flats = [rng.standard_normal(total).astype(np.float32) * s for s in (1e-2, 3e-1, 1e-2)]
    return params, spec, flats


def _fresh(params, tx):
    return TrainState.create({n: p.clone() for n, p in params.items()}, tx)


def _swav_tx():
    return Lars(linear_warmup_cosine_annealing(*SCHEDULE), weight_decay=1e-4)


def _flat_tx(spec):
    return FlatLars(spec, [False] * len(spec), linear_warmup_cosine_annealing(*SCHEDULE),
                    weight_decay=1e-4)


def _leaf_grads(layout, flat):
    return {n: g.clone() for n, g in layout.views(torch.from_numpy(flat)).items()}


@pytest.mark.parametrize("post", [False, True])
def test_flat_lars_matches_the_per_leaf_apply(swav_setup, post):
    """Flat LARS (segment norms over the wire layout, conv kernels
    permuted) against the guarded per-leaf apply over 3 steps, with and
    without the prototype re-normalisation as ``post_apply``."""
    params, spec, flats = swav_setup
    post_apply = make_prototype_post_apply() if post else None
    tx = _swav_tx()
    flat_state, leaf_state = _fresh(params, tx), _fresh(params, tx)
    flat = make_flat_apply_step(_flat_tx(spec), spec, post_apply=post_apply)
    leaf = make_guarded_apply_step(tx, post_apply=post_apply)
    layout = FlatLayout(spec, params)
    for f in flats:
        flat_state, ok1 = flat(flat_state, torch.from_numpy(f))
        leaf_state, ok2 = leaf(leaf_state, _leaf_grads(layout, f))
        assert bool(ok1) and bool(ok2)
        for n in params:
            _rel(flat_state.params[n].numpy(), leaf_state.params[n].numpy(), RTOL)
            _rel(flat_state.opt_state.momentum[n].numpy(),
                 leaf_state.opt_state.momentum[n].numpy(), RTOL)
    assert int(flat_state.step) == int(leaf_state.step) == STEPS
    assert int(flat_state.opt_state.schedule_count) == STEPS
    norms = flat_state.params["head.prototypes0.weight"].norm(dim=1)
    if post:
        np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-6)
    else:
        assert float((norms - 1).abs().max()) > 1e-3


def test_flat_lars_matches_jax_flat_lars(swav_setup):
    """One ``FlatLars`` step (candidate, then commit) over the spec's leaves
    against the JAX package's ``FlatLars.update`` on the same flat buffers
    (the JAX class fed the same spec): the new momentum and parameters."""
    params, spec, flats = swav_setup
    layout = FlatLayout(spec, params)
    spans = spec_spans(spec)
    fp = torch.cat([convert.to_jax_layout(params[n], perm).reshape(-1)
                    for n, _o, _s, _shape, perm in layout.entries])
    mom = torch.from_numpy(flats[0] * 0.1)
    g = torch.from_numpy(flats[1])
    count = torch.tensor(1, dtype=torch.int32)
    leaves = lambda flat: [flat[o:o + s] for o, s in spans]
    new_p, new_mom = fp.clone(), mom.clone()
    out = [torch.empty(s) for _o, s in spans]
    ftx = _flat_tx(spec)
    opt = LarsState(momentum=None, schedule_count=count)
    neg_rate = ftx.candidate(ftx.table.bind([leaves(g), leaves(fp), leaves(mom), out]),
                             opt)
    ftx.commit(ftx.table.bind([leaves(g), leaves(new_p), leaves(new_mom), out]),
               torch.tensor(True), neg_rate)
    jtx = JaxFlatLars(spec, [False] * len(spec), jax_cosine(*SCHEDULE), weight_decay=1e-4)
    jupd, jmom = jtx.update(jnp.asarray(flats[1]), jnp.asarray(fp.numpy()),
                            jnp.asarray(mom.numpy()), jnp.asarray(1, jnp.int32))
    _rel(new_mom.numpy(), jmom, RTOL)
    _rel(new_p.numpy(), fp.numpy() + np.asarray(jupd), RTOL)


@pytest.mark.parametrize("flat_apply", [False, True])
def test_nan_gradient_rolls_everything_back_bitwise(swav_setup, flat_apply):
    params, spec, flats = swav_setup
    tx = _swav_tx()
    post = make_prototype_post_apply()
    apply = (make_flat_apply_step(_flat_tx(spec), spec, post_apply=post) if flat_apply
             else make_guarded_apply_step(tx, post_apply=post))
    layout = FlatLayout(spec, params)
    state = _fresh(params, tx)
    grads = (lambda f: torch.from_numpy(f)) if flat_apply else (
        lambda f: _leaf_grads(layout, f))
    state, ok = apply(state, grads(flats[0]))
    assert bool(ok)
    before = {n: p.clone() for n, p in state.params.items()}
    mom = {n: m.clone() for n, m in state.opt_state.momentum.items()}
    counts = (int(state.step), int(state.opt_state.schedule_count))
    bad = flats[1].copy()
    bad[17] = np.nan
    state, ok = apply(state, grads(bad))
    assert not bool(ok)
    assert (int(state.step), int(state.opt_state.schedule_count)) == counts
    for n in params:
        assert torch.equal(state.params[n], before[n]), n
        assert torch.equal(state.opt_state.momentum[n], mom[n]), n


@pytest.mark.parametrize("args", [(0.3, 5, 100), (0.6, 10, 313), (4.8, 3, 7, 0.01, 1e-4),
                                  (0.1, 0, 10)])
def test_cosine_tensor_path_equals_the_numpy_path(args):
    sched = linear_warmup_cosine_annealing(*args)
    steps = range(0, 120)
    host = np.array([sched(s) for s in steps], np.float32)
    dev = np.array([float(sched(torch.tensor(s, dtype=torch.int32))) for s in steps],
                   np.float32)
    atol = 0.5 * args[0] * np.finfo(np.float32).eps
    np.testing.assert_allclose(dev, host, rtol=SCHED_RTOL, atol=atol)
    jx = np.array([float(jax_cosine(*args)(s)) for s in steps], np.float32)
    np.testing.assert_allclose(dev, jx, rtol=SCHED_RTOL, atol=atol)


def test_lars_state_names_round_trip():
    """``Lars.state_views`` carries the JAX SwAV peer's names
    (``[1][0].momentum...``, ``[1][1].count``) and ``state_from_named``
    reads them back exactly."""
    params = {"head.proj0.weight": torch.randn(4, 3),
              "trunk.stem_conv.weight": torch.randn(8, 3, 7, 7)}
    tx = Lars(0.1)
    state = LarsState(momentum={n: torch.randn_like(p) for n, p in params.items()},
                      schedule_count=5)
    named = {k: v.contiguous().numpy() for k, v in tx.state_views(params, state).items()}
    assert sorted(named) == sorted([
        "[0]['head']['proj0']['kernel']", "[0]['trunk']['stem_conv']['kernel']",
        "[1][0].momentum['head']['proj0']['kernel']",
        "[1][0].momentum['trunk']['stem_conv']['kernel']", "[1][1].count"])
    assert named["[0]['trunk']['stem_conv']['kernel']"].shape == (7, 7, 3, 8)
    p2, s2 = tx.state_from_named(named)
    assert s2.schedule_count == 5
    for n in params:
        assert torch.equal(p2[n], params[n]) and torch.equal(s2.momentum[n], state.momentum[n])
    with pytest.raises(KeyError):
        tx.state_from_named({**named, "[1][2].mu": np.zeros(1)})


def test_local_fused_step_with_lars_matches_jax():
    """SwAV's ``make_swav_train_step`` with LARS and the queue on for 2
    steps: the loss, the params after each update and the prototypes
    re-normalised (tolerances: ``tests/test_torch_swav.py``)."""
    jcfg, tcfg = _fp32_cfg(True, queue_length=16), _fp32_cfg(False, queue_length=16)
    jmodel, variables, model, stats = _pair(jcfg, tcfg, seed=1)
    jtx = jax_lars(learning_rate=0.5, weight_decay=1e-4)
    jq = jswav.SwAVQueue.create(jcfg, jax.random.PRNGKey(2))
    jstate = jswav.SwAVTrainState(
        step=jnp.zeros([], jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=jtx.init(variables["params"]),
        queue=jq)
    ttx = Lars(learning_rate=0.5, weight_decay=1e-4)
    params = dict(model.named_parameters())
    tstate = swav.SwAVTrainState(step=0, params=params, batch_stats=stats,
                                 opt_state=ttx.init(params),
                                 queue=swav.SwAVQueue(torch.tensor(np.asarray(jq.embeddings))))
    jstep = jswav.make_swav_train_step(jmodel, jcfg, jtx)
    tstep = swav.make_swav_train_step(model, tcfg, ttx)
    batches = jax_batches(JaxSpec.tiny(), B, seed=9)
    for _ in range(2):
        crops = next(batches)
        jstate, jm = jstep(jstate, [jnp.asarray(c) for c in crops], True)
        tstate, tm = tstep(tstate, [torch.from_numpy(c) for c in crops], True)
        # the second step's loss reads params one LARS update apart
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=GRAD_RTOL)
        want = _tree_to_named(jstate.params)
        got = convert.params_to_jax(tstate.params)
        for name, ref in want.items():
            _rel(got[name], ref, GRAD_RTOL, GRAD_FLOOR)
    w = tstate.params["head.prototypes0.weight"].detach().numpy()
    np.testing.assert_allclose(np.linalg.norm(w, axis=1), 1.0, atol=1e-6)
    assert tstate.step == 2
