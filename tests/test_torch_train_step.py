"""The port's LAMB, schedules, train steps and MLM masking against the JAX
package's, from the same weights and numpy batches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.core.config import CollaborationArguments
from dedloc_tpu.data.mlm import SpecialTokens as JaxSpecialTokens
from dedloc_tpu.data.mlm import mask_tokens as jax_mask_tokens
from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.models.albert import AlbertForPreTraining as JaxModel
from dedloc_tpu.optim.schedules import linear_warmup_cosine_annealing as jax_cosine
from dedloc_tpu.optim.schedules import linear_warmup_linear_decay as jax_linear
from dedloc_tpu.parallel import train_step as jax_ts
from dedloc_tpu.roles import common as jax_common
from dedloc_tpu_torch.core.config import TrainingArguments
from dedloc_tpu_torch.data.mlm import SpecialTokens, mask_tokens
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models.albert import (
    AlbertConfig,
    AlbertForPreTraining,
    init_weights,
)
from dedloc_tpu_torch.optim.schedules import (
    linear_warmup_cosine_annealing,
    linear_warmup_linear_decay,
)
from dedloc_tpu_torch.parallel.train_step import (
    TrainState,
    make_accumulate_step,
    make_apply_step,
    make_local_train_step,
    zeros_like_grads,
)
from dedloc_tpu_torch.roles.common import (
    build_loss_fn,
    build_optimizer,
    drop_collator_keys,
    synthetic_mlm_batches,
)

# warmup 2 of 10 steps (the lr is 0 at step 0), clipping at 1.0 engaged at
# init, weight decay on the masked leaves; a large lr so 5 steps move params
RECIPE = dict(learning_rate=5e-2, warmup_steps=2, total_steps=10,
              weight_decay=0.01, max_grad_norm=1.0, clamp_value=10000.0)
STEPS, ACCUM = 5, 2
# fp32 on both sides; differences come from reduction order in the forward
# and backward, amplified slightly by the Adam direction m / sqrt(v)
PARAM_TOL = dict(atol=2e-5, rtol=1e-4)


def _batches(n):
    it = synthetic_mlm_batches(AlbertConfig.tiny(), batch_size=2,
                               seq_length=32, seed=1)
    return [next(it) for _ in range(n)]


@pytest.fixture(scope="module")
def lamb_trajectories():
    """JAX accumulate x2 + apply for 5 steps, and the port's, from the same
    weights and batches: params after every step."""
    batches = _batches(STEPS * ACCUM)
    jmodel = JaxModel(JaxConfig.tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(batches[0]["input_ids"]))["params"]
    args = CollaborationArguments()
    args.training = dataclasses.replace(args.training, **RECIPE)
    tx = jax_common.build_optimizer(args)
    state = jax_ts.TrainState.create(params, tx)
    acc = jax_ts.make_accumulate_step(jax_common.build_loss_fn(jmodel))
    apply = jax_ts.make_apply_step(tx)
    named0 = {jax.tree_util.keystr(p): np.asarray(x)
              for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    jax_traj = []
    for step in range(STEPS):
        g, n = jax_ts.zeros_like_grads(state.params), jnp.zeros([], jnp.int32)
        for i in range(ACCUM):
            mb = jax_common.drop_collator_keys(batches[step * ACCUM + i])
            g, n, _ = acc(state.params, g, n, mb, jax.random.PRNGKey(step))
        state = apply(state, jax.tree.map(lambda x: x / n, g))
        jax_traj.append({jax.tree_util.keystr(p): np.asarray(x) for p, x in
                         jax.tree_util.tree_flatten_with_path(state.params)[0]})

    model = AlbertForPreTraining(AlbertConfig.tiny(dtype=torch.float32))
    model.load_state_dict(convert.params_from_jax(named0))
    ptx = build_optimizer(TrainingArguments(**RECIPE))
    params_t = dict(model.named_parameters())
    pstate = TrainState.create(params_t, ptx)
    pacc = make_accumulate_step(build_loss_fn(model))
    papply = make_apply_step(ptx)
    port_traj = []
    for step in range(STEPS):
        g, n = zeros_like_grads(params_t), 0
        for i in range(ACCUM):
            mb = drop_collator_keys(batches[step * ACCUM + i], device="cpu")
            g, n, _ = pacc(params_t, g, n, mb)
        pstate = papply(pstate, {k: v / n for k, v in g.items()})
        port_traj.append(convert.params_to_jax(pstate.params))
    return named0, jax_traj, port_traj, pstate


@pytest.mark.parametrize("step", range(STEPS))
def test_lamb_matches_jax_after_each_step(lamb_trajectories, step):
    named0, jax_traj, port_traj, _ = lamb_trajectories
    for name in named0:
        np.testing.assert_allclose(port_traj[step][name], jax_traj[step][name],
                                   **PARAM_TOL, err_msg=f"step {step} {name}")


def test_lamb_moved_every_param_after_warmup(lamb_trajectories):
    """Step 0 runs at lr 0 (warmup); the later steps move the params."""
    named0, jax_traj, port_traj, state = lamb_trajectories
    for name, w0 in named0.items():
        np.testing.assert_array_equal(port_traj[0][name], w0, err_msg=name)
    moved = [n for n in named0 if not np.array_equal(port_traj[-1][n], named0[n])]
    assert len(moved) >= 25  # all but rows/params the batches never touch
    assert state.step == STEPS and state.opt_state.count == STEPS
    assert state.opt_state.schedule_count == STEPS


def test_accumulate_and_apply_equals_local_train_step():
    batches = _batches(ACCUM)
    tx_args = TrainingArguments(**RECIPE)
    results = []
    for fused in (False, True):
        model = AlbertForPreTraining(AlbertConfig.tiny(dtype=torch.float32))
        init_weights(model, torch.Generator().manual_seed(3))
        tx = build_optimizer(tx_args)
        params = dict(model.named_parameters())
        state = TrainState.create(params, tx)
        loss_fn = build_loss_fn(model)
        mbs = [drop_collator_keys(b, device="cpu") for b in batches]
        for _ in range(3):  # past the lr=0 warmup step
            if fused:
                stacked = {k: torch.stack([mb[k] for mb in mbs]) for k in mbs[0]}
                state, metrics = make_local_train_step(loss_fn, tx, ACCUM)(state, stacked)
                assert set(metrics) >= {"loss", "mlm_loss", "sop_loss", "mlm_acc"}
            else:
                g, n = zeros_like_grads(params), 0
                for mb in mbs:
                    g, n, _ = make_accumulate_step(loss_fn)(params, g, n, mb)
                assert n == ACCUM
                state = make_apply_step(tx)(state, {k: v / n for k, v in g.items()})
        results.append({k: v.detach().clone() for k, v in state.params.items()})
    for name in results[0]:
        torch.testing.assert_close(results[1][name], results[0][name],
                                   atol=1e-6, rtol=1e-5, msg=name)


def test_schedules_match_jax():
    for port_fn, jax_fn, kw in (
        (linear_warmup_linear_decay, jax_linear, {}),
        (linear_warmup_cosine_annealing, jax_cosine,
         dict(warmup_start_lr=1e-4, eta_min=1e-5)),
    ):
        ours = port_fn(1.76e-3, 50, 400, **kw)
        theirs = jax_fn(1.76e-3, 50, 400, **kw)
        for step in (0, 1, 25, 49, 50, 51, 200, 399, 400, 500):
            np.testing.assert_allclose(ours(step), float(theirs(step)),
                                       rtol=1e-6, atol=1e-12, err_msg=str(step))


def test_mask_tokens_matches_jax_package():
    rng = np.random.default_rng(7)
    batch = {
        "input_ids": rng.integers(5, 1000, (4, 64)).astype(np.int32),
        "attention_mask": np.ones((4, 64), np.int32),
        "special_tokens_mask": np.zeros((4, 64), np.int32),
    }
    batch["attention_mask"][2, 50:] = 0
    batch["special_tokens_mask"][:, 0] = 1
    ours = mask_tokens(batch, np.random.default_rng(11),
                       SpecialTokens(vocab_size=1000), max_predictions=13)
    theirs = jax_mask_tokens(batch, np.random.default_rng(11),
                             JaxSpecialTokens(vocab_size=1000), max_predictions=13)
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


def test_synthetic_batches_match_jax_package():
    ours = synthetic_mlm_batches(AlbertConfig.tiny(), 3, 64, seed=5)
    theirs = jax_common.synthetic_mlm_batches(JaxConfig.tiny(), 3, 64, seed=5)
    for _ in range(2):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
