"""The port's long-context path against the JAX package's: a tiny ALBERT whose
sequence (S=256) spans four attention blocks of 64, so JAX's flash backward
takes the split ``_dq_kernel``/``_dkv_kernel`` pair (in interpret mode), with
the ``dots_no_batch_attn`` remat policy of the S=16,384 bench; then the same
with ``attention_impl="blockwise"``. The same weights (``models/convert.py``)
and numpy batch (one padded sample) go to both; compared are the MLM and SOP
logits, the loss and the gradient of every named parameter. The port runs
its plain versions on the CPU."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.models.albert import AlbertForPreTraining as JaxModel
from dedloc_tpu.models.albert import albert_pretraining_loss_gathered as jax_loss
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models.albert import AlbertConfig, AlbertForPreTraining
from dedloc_tpu_torch.roles.common import (
    build_loss_fn,
    drop_collator_keys,
    synthetic_mlm_batches,
)

# the module (``dedloc_tpu.ops`` re-exports its function under the same name)
jax_flash = importlib.import_module("dedloc_tpu.ops.flash_attention")

SEQ = 256
LONG = dict(max_position_embeddings=SEQ, attention_block_size=64,
            remat_policy="dots_no_batch_attn")
IMPLS = ("flash", "blockwise")
# the tolerances of tests/test_torch_albert.py. fp32: loss 1e-5; grads as
# tests/test_fused_ln.py (5e-4 abs / 5e-3 rel). bf16: the two frameworks
# round to bf16 at slightly different places, so logits agree to a few bf16
# steps (2^-8 relative) and the loss to 2e-2.
FP32 = dict(loss=1e-5, logits=dict(atol=1e-5, rtol=1e-5),
            grads=dict(atol=5e-4, rtol=5e-3))
BF16 = dict(loss=2e-2, logits=dict(atol=5e-2, rtol=5e-2))
N_LEAVES = 32


def _batch():
    cfg = AlbertConfig.tiny(max_position_embeddings=SEQ)
    batch = next(synthetic_mlm_batches(cfg, batch_size=2, seq_length=SEQ, seed=0))
    batch["attention_mask"][1, 160:] = 0  # one padded sample
    batch["token_type_ids"][:, SEQ // 2:] = 1
    return batch


def _jax_named(params):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}


def _no_fused_backward(*args, **kwargs):
    raise AssertionError("S > block: JAX must take the split backward")


def _jax_reference(dtype, impl, batch, with_grads):
    ids = jnp.asarray(batch["input_ids"])
    params = JaxModel(JaxConfig.tiny(dtype=dtype, max_position_embeddings=SEQ)
                      ).init(jax.random.PRNGKey(0), ids)["params"]
    model = JaxModel(JaxConfig.tiny(dtype=dtype, attention_impl=impl, **LONG))
    assert model.cfg.remat
    jb = {k: jnp.asarray(batch[k]) for k in drop_collator_keys(batch, "cpu")}

    def loss_and_logits(params):  # one forward pass for both
        mlm, sop = model.apply({"params": params}, jb["input_ids"],
                               jb["attention_mask"], jb["token_type_ids"],
                               mlm_positions=jb["mlm_positions"])
        loss, _ = jax_loss(mlm, sop, jb["mlm_label_ids"], jb["mlm_weights"],
                           jb["sop_labels"])
        return loss, (mlm, sop)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_flash, "_bwd_fused", _no_fused_backward)
        if with_grads:
            (loss, (mlm, sop)), grads = jax.jit(
                jax.value_and_grad(loss_and_logits, has_aux=True))(params)
            grads = _jax_named(grads)
        else:
            loss, (mlm, sop) = jax.jit(loss_and_logits)(params)
            grads = None
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    return dict(named=_jax_named(params), mlm=f32(mlm), sop=f32(sop),
                loss=float(loss), grads=grads)


def _port(dtype, impl, named, batch):
    model = AlbertForPreTraining(AlbertConfig.tiny(dtype=dtype, attention_impl=impl,
                                                   **LONG))
    assert model.cfg.remat
    model.load_state_dict(convert.params_from_jax(named))
    tb = drop_collator_keys(batch, device="cpu")
    params = dict(model.named_parameters())
    mlm, sop = model(tb["input_ids"], tb["attention_mask"], tb["token_type_ids"],
                     mlm_positions=tb["mlm_positions"])
    loss, _ = build_loss_fn(model)(params, tb)
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(mlm=mlm.detach().float().numpy(), sop=sop.detach().float().numpy(),
                loss=float(loss.detach()),
                grads=convert.params_to_jax(dict(zip(params, grads))))


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.fixture(scope="module")
def fp32_cases(batch):
    cases = {}

    def get(impl):
        if impl not in cases:
            ref = _jax_reference(jnp.float32, impl, batch, with_grads=True)
            cases[impl] = ref, _port(torch.float32, impl, ref["named"], batch)
        return cases[impl]

    return get


@pytest.mark.parametrize("impl", IMPLS)
def test_fp32_logits_and_loss_match(fp32_cases, impl):
    ref, port = fp32_cases(impl)
    assert port["mlm"].shape == ref["mlm"].shape == (2, 42, 512)
    np.testing.assert_allclose(port["mlm"], ref["mlm"], **FP32["logits"])
    np.testing.assert_allclose(port["sop"], ref["sop"], **FP32["logits"])
    assert abs(port["loss"] - ref["loss"]) <= FP32["loss"]


@pytest.mark.parametrize("leaf", range(N_LEAVES))
@pytest.mark.parametrize("impl", IMPLS)
def test_fp32_gradient_of_every_leaf_matches(fp32_cases, impl, leaf):
    ref, port = fp32_cases(impl)
    assert len(ref["grads"]) == N_LEAVES
    name = sorted(ref["grads"])[leaf]
    np.testing.assert_allclose(port["grads"][name], ref["grads"][name],
                               **FP32["grads"], err_msg=name)


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_logits_and_loss_match(batch, impl):
    ref = _jax_reference(jnp.bfloat16, impl, batch, with_grads=False)
    port = _port(torch.bfloat16, impl, ref["named"], batch)
    np.testing.assert_allclose(port["mlm"], ref["mlm"], **BF16["logits"])
    np.testing.assert_allclose(port["sop"], ref["sop"], **BF16["logits"])
    assert abs(port["loss"] - ref["loss"]) <= BF16["loss"]
    # at init the loss sits near ln(vocab) + ln(2)
    assert abs(port["loss"] - (np.log(512) + np.log(2))) < 0.5
