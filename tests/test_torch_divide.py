"""Divisions where the reference divides: ``utils/device.divide`` is an IEEE
division by a 0-d tensor on the dividend's device, and the three sites that
use it (LAMB's debias at int counts, the local step's ``g / accum`` and
dense attention's ``/ sqrt(d)``) match the JAX package on the CPU. On CUDA a
Python-number divisor is a multiply by its reciprocal; ``chip_smoke.py``'s
path phase holds the card to the CPU bitwise at these sites."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.core.config import CollaborationArguments
from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.models.albert import AlbertForPreTraining as JaxModel
from dedloc_tpu.optim.lamb import lamb as jax_lamb
from dedloc_tpu.parallel import train_step as jax_ts
from dedloc_tpu.parallel.ring_attention import dense_attention as jax_dense
from dedloc_tpu.roles import common as jax_common
from dedloc_tpu_torch.core.config import TrainingArguments
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models.albert import AlbertConfig, AlbertForPreTraining
from dedloc_tpu_torch.optim.lamb import Lamb
from dedloc_tpu_torch.parallel.ring_attention import dense_attention
from dedloc_tpu_torch.parallel.train_step import TrainState, make_local_train_step
from dedloc_tpu_torch.roles.common import (
    build_loss_fn,
    build_optimizer,
    drop_collator_keys,
    synthetic_mlm_batches,
)
from dedloc_tpu_torch.utils.device import divide

# as tests/test_torch_train_step.py: fp32 on both sides, reduction order
PARAM_TOL = dict(atol=2e-5, rtol=1e-4)
# one LAMB update on the same grads: only the norms' summation order differs
UPDATE_TOL = dict(atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("d", [3, 255.0, 0.999, 1 - 0.9 ** 3, math.sqrt(80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_divide_is_an_ieee_division_by_a_device_scalar(d, dtype):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32)).to(dtype)
    got = divide(x, d)
    assert got.dtype == dtype and got.device == x.device
    want = x / torch.tensor(d, dtype=dtype)
    assert torch.equal(got, want)
    if dtype == torch.float32:
        np.testing.assert_array_equal(
            got.numpy(), x.numpy() / np.float32(d))


def test_a_reciprocal_multiply_is_not_the_division():
    """Why the divisor is a tensor: x * (1 / 3) != x / 3 in fp32."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                         .astype(np.float32))
    assert not torch.equal(divide(x, 3), x * np.float32(1 / 3))


def _jax_tiny_params():
    ids = jnp.zeros((2, 16), jnp.int32)
    params = JaxModel(JaxConfig.tiny(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), ids)["params"]
    named = {jax.tree_util.keystr(p): np.asarray(x)
             for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    return params, named


def _named(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_lamb_update_matches_jax_at_counts_1_to_3():
    """Int counts (the local path): the bias-corrected moments divide by
    host floats, which ``divide`` keeps IEEE on any device."""
    params, named = _jax_tiny_params()
    rng = np.random.default_rng(2)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 1e-2
              for k, v in named.items()} for _ in range(3)]
    jtx = jax_lamb(1e-2, weight_decay=0.01)
    jstate = jtx.init(params)
    jupdate = jax.jit(jtx.update)
    ptx = Lamb(learning_rate=1e-2, weight_decay=0.01)
    pparams = convert.params_from_jax(named)
    pstate = ptx.init(pparams)
    for count, g in enumerate(grads, start=1):
        treedef = jax.tree_util.tree_structure(params)
        jg = jax.tree_util.tree_unflatten(
            treedef, [g[jax.tree_util.keystr(p)] for p, _ in
                      jax.tree_util.tree_flatten_with_path(params)[0]])
        jupd, jstate = jupdate(jg, jstate, params)
        pupd, pstate = ptx.update(convert.params_from_jax(g), pstate, pparams)
        assert pstate.count == count
        ours, theirs = convert.params_to_jax(pupd), _named(jupd)
        for name in theirs:
            np.testing.assert_allclose(ours[name], theirs[name], **UPDATE_TOL,
                                       err_msg=f"count {count} {name}")
        jnu = _named(jstate[0].nu)
        for name, nu in convert.params_to_jax(pstate.nu).items():
            np.testing.assert_allclose(nu, jnu[name], **UPDATE_TOL,
                                       err_msg=f"count {count} {name}")


def test_local_train_step_with_3_micro_batches_matches_jax():
    """``make_local_train_step`` at ``grad_accum_steps=3``: each micro-batch
    adds ``g / 3`` (a division, as the JAX scan's) to the accumulator."""
    recipe = dict(learning_rate=5e-2, warmup_steps=0, total_steps=10,
                  weight_decay=0.01, max_grad_norm=1.0)
    it = synthetic_mlm_batches(AlbertConfig.tiny(), batch_size=2,
                               seq_length=32, seed=4)
    micro = [drop_collator_keys(next(it), device="cpu") for _ in range(3)]
    stacked = {k: np.stack([m[k].numpy() for m in micro]) for k in micro[0]}
    params, named = _jax_tiny_params()
    args = CollaborationArguments()
    args.training = dataclasses.replace(args.training, **recipe)
    jmodel = JaxModel(JaxConfig.tiny(dtype=jnp.float32))
    tx = jax_common.build_optimizer(args)
    step = jax_ts.make_local_train_step(jax_common.build_loss_fn(jmodel), tx, 3)
    jstate, _ = step(jax_ts.TrainState.create(params, tx),
                     {k: jnp.asarray(v) for k, v in stacked.items()},
                     jax.random.PRNGKey(0))
    model = AlbertForPreTraining(AlbertConfig.tiny(dtype=torch.float32))
    model.load_state_dict(convert.params_from_jax(named))
    ptx = build_optimizer(TrainingArguments(**recipe))
    pstate = TrainState.create(dict(model.named_parameters()), ptx)
    pstate, _ = make_local_train_step(build_loss_fn(model), ptx, 3)(
        pstate, {k: torch.from_numpy(v) for k, v in stacked.items()})
    ours, theirs = convert.params_to_jax(pstate.params), _named(jstate.params)
    moved = 0
    for name in theirs:
        np.testing.assert_allclose(ours[name], theirs[name], **PARAM_TOL,
                                   err_msg=name)
        moved += not np.array_equal(theirs[name], named[name])
    assert moved >= 25


def test_dense_attention_scale_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 24, 2, 80)).astype(np.float32)
               for _ in range(3))
    bias = np.where(rng.random((2, 24)) < 0.2, -1e9, 0.0).astype(np.float32)
    ours = dense_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    theirs = jax_dense(*(jnp.asarray(a) for a in (q, k, v, bias)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               atol=1e-6, rtol=1e-5)
