"""The port's graft entry points (``dedloc_tpu_torch/graft_entry.py``, the
counterpart of ``__graft_entry__.py``): ``dryrun_multichip(4)``'s step on
4 gloo CPU ranks — a (data 1, model 2, seq 2) mesh, tensor and sequence
parallel with ring attention — held against the JAX package's
``make_local_train_step`` on one device, from the same weights (carried by
``models/convert.py``) and the same numpy batch, in fp32; the ZeRO-1 apply,
pipeline, expert and role-MoE dryruns on the same ranks; and ``entry``'s
ALBERT-large forward on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.collaborative.optimizer import _named_to_tree
from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.models.albert import AlbertForPreTraining as JaxModel
from dedloc_tpu.models.albert import albert_pretraining_loss
from dedloc_tpu.optim import lamb as jax_lamb
from dedloc_tpu.parallel.train_step import TrainState, make_local_train_step
from dedloc_tpu_torch import graft_entry
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models.albert import AlbertForPreTraining, init_weights

N = 4
# fp32 on both sides: the slice reduces over gloo (TP sums, the ring's
# online softmax, the loss's psum of sums) in another order than XLA's one
# device does; LAMB's trust ratio carries that into the params
LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def _weights():
    model = AlbertForPreTraining(graft_entry.dryrun_config(N))
    init_weights(model, torch.Generator().manual_seed(3))
    return convert.params_to_jax(dict(model.named_parameters()))


def _jax_step(weights):
    cfg = graft_entry.dryrun_config(N)
    jcfg = JaxConfig.tiny(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                          intermediate_size=cfg.intermediate_size,
                          num_attention_heads=cfg.num_attention_heads,
                          max_position_embeddings=cfg.max_position_embeddings,
                          dtype=jnp.float32)
    model = JaxModel(jcfg)
    batch = graft_entry.dryrun_batch(N)
    like = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros(batch["input_ids"].shape[1:], jnp.int32))["params"])
    params = _named_to_tree({k: jnp.asarray(v) for k, v in weights.items()}, like)
    tx = jax_lamb(**graft_entry.LAMB)

    def loss_fn(p, b, rng):
        mlm, sop = model.apply({"params": p}, b["input_ids"], b["attention_mask"],
                               b["token_type_ids"])
        return albert_pretraining_loss(mlm, sop, b["mlm_labels"], b["sop_labels"])

    step = make_local_train_step(loss_fn, tx, grad_accum_steps=graft_entry.ACCUM)
    state, metrics = step(TrainState.create(params, tx),
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(1))
    named = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
             jax.tree_util.tree_flatten_with_path(state.params)[0]}
    return float(metrics["loss"]), int(state.step), named


@pytest.fixture(scope="module")
def dryrun():
    weights = _weights()
    port = graft_entry._dryrun_step(N, "cpu", weights)
    return port, _jax_step(weights)


def test_the_mesh_is_tensor_and_sequence_parallel(dryrun):
    port, _ref = dryrun
    assert port["mesh"] == {"data": 1, "model": 2, "seq": 2}


def test_step_loss_matches_the_jax_one_device_step(dryrun):
    port, (loss, step, _params) = dryrun
    assert step == 1
    np.testing.assert_allclose(port["loss"], loss, rtol=LOSS_RTOL)


def test_updated_params_match_the_jax_one_device_step(dryrun):
    port, (_loss, _step, params) = dryrun
    assert sorted(port["params"]) == sorted(params)
    for name, want in params.items():
        np.testing.assert_allclose(port["params"][name], want, err_msg=name,
                                   **PARAM_TOL)


def test_zero_apply_and_the_other_dryruns_ran_on_every_rank(dryrun):
    port, _ref = dryrun
    assert port["counts"] == [(1, 2)] * N  # (the step's, the ZeRO apply's)
    assert np.isfinite(port["pipeline_loss"]) and np.isfinite(port["moe_loss"])
    assert port["role_moe"]["step"] >= 1


def test_entry_is_the_albert_large_forward_on_the_cpu():
    fn, args = graft_entry.entry("cpu")
    params, input_ids, attention_mask = args
    assert tuple(input_ids.shape) == (4, 128)
    assert len(params) == 32
    mlm, sop = fn(*args)
    assert tuple(mlm.shape) == (4, 128, 30000) and tuple(sop.shape) == (4, 2)
    assert torch.isfinite(mlm).all() and torch.isfinite(sop).all()


def test_entry_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
