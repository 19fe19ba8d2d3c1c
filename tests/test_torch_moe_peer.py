"""A port Switch-MoE ALBERT peer beside a JAX one: bf16 logits and loss
against the JAX model on the same weights and batch, the gradient schema
fingerprint a port MoE peer joins with equal to a JAX MoE peer's, trainer
checkpoints loading in both directions with equal losses, and the trainer
role taking a global step with ``--training.moe_experts``. The fp32 parity
of logits, loss and every gradient is ``tests/test_torch_moe_model.py``."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.averaging.averager import schema_fingerprint as jax_fingerprint
from dedloc_tpu.collaborative.optimizer import _named_to_tree, _tree_to_named
from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.models.albert import AlbertForPreTraining as JaxModel
from dedloc_tpu.optim.lamb import lamb as jax_lamb
from dedloc_tpu.roles.common import build_loss_fn as jax_build_loss_fn
from dedloc_tpu.utils.checkpoint import load_latest_checkpoint as jax_load
from dedloc_tpu.utils.checkpoint import save_checkpoint as jax_save
from dedloc_tpu_torch.averaging.averager import schema_fingerprint
from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models.albert import AlbertConfig, AlbertForPreTraining
from dedloc_tpu_torch.optim.lamb import Lamb
from dedloc_tpu_torch.roles.common import (
    build_loss_fn,
    build_model,
    drop_collator_keys,
    synthetic_mlm_batches,
)
from dedloc_tpu_torch.roles.trainer import run_trainer
from dedloc_tpu_torch.utils.checkpoint import load_latest_checkpoint, save_checkpoint

MOE = dict(moe_experts=4, moe_capacity_factor=1.25, moe_aux_weight=0.01)
# remat "" is the builders' default (remat on, policy "nothing", dense
# attention, no fused add+LN); "fused_ln" the recipe's, with flash attention
POLICIES = {"": dict(), "fused_ln": dict(remat_policy="fused_ln", fused_ln=True,
                                         attention_impl="flash")}
# the tolerances of tests/test_torch_albert.py's dense model
FP32 = dict(loss=1e-5, logits=dict(atol=1e-5, rtol=1e-5),
            grads=dict(atol=5e-4, rtol=5e-3))
BF16 = dict(loss=2e-2, logits=dict(atol=5e-2, rtol=5e-2))
MOE_LEAVES = ("moe_router", "moe_wi", "moe_wo")


def _batch():
    cfg = AlbertConfig.tiny()
    batch = next(synthetic_mlm_batches(cfg, batch_size=2, seq_length=64, seed=0))
    batch["attention_mask"][1, 40:] = 0  # one padded sample
    batch["token_type_ids"][:, 32:] = 1
    return batch


def _jax_named(tree):
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_init(batch):
    """The JAX MoE model's parameter tree (its shapes from ``eval_shape``)
    with values drawn by numpy: normal(0.02) kernels, embeddings and MoE
    leaves, LayerNorm scales near one, small biases."""
    shapes = jax.eval_shape(lambda: JaxModel(JaxConfig.tiny(**MOE)).init(
        jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"]))["params"])
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return jnp.asarray(1.0 + rng.normal(0, 0.1, leaf.shape), jnp.float32)
        scale = 0.01 if name.endswith("bias']") else 0.02
        return jnp.asarray(rng.normal(0, scale, leaf.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_run(params, batch, dtype, policy, with_grads, **jit_kw):
    model = JaxModel(JaxConfig.tiny(dtype=dtype, **MOE, **POLICIES[policy]))
    jb = {k: jnp.asarray(batch[k]) for k in drop_collator_keys(batch, "cpu")}
    loss_fn = jax_build_loss_fn(model)

    def loss_and_logits(params):
        loss, metrics = loss_fn(params, jb, jax.random.PRNGKey(1))
        (mlm, sop), _ = model.apply(
            {"params": params}, jb["input_ids"], jb["attention_mask"],
            jb["token_type_ids"], mlm_positions=jb["mlm_positions"],
            mutable=("losses",))
        return loss, (mlm, sop, metrics["moe_aux"])

    if with_grads:
        (loss, (mlm, sop, aux)), grads = jax.jit(
            jax.value_and_grad(loss_and_logits, has_aux=True), **jit_kw)(params)
        grads = _jax_named(grads)
    else:
        loss, (mlm, sop, aux) = jax.jit(loss_and_logits, **jit_kw)(params)
        grads = None
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    return dict(mlm=f32(mlm), sop=f32(sop), loss=float(loss), aux=float(aux),
                grads=grads)


def _port_model(named, dtype, policy):
    model = AlbertForPreTraining(AlbertConfig.tiny(dtype=dtype, **MOE,
                                                   **POLICIES[policy]))
    model.load_state_dict(convert.params_from_jax(named))
    return model


def _port_run(named, batch, dtype, policy):
    model = _port_model(named, dtype, policy)
    tb = drop_collator_keys(batch, device="cpu")
    params = dict(model.named_parameters())
    losses = {}
    mlm, sop = model(tb["input_ids"], tb["attention_mask"], tb["token_type_ids"],
                     mlm_positions=tb["mlm_positions"], losses=losses)
    loss, metrics = build_loss_fn(model)(params, tb)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert torch.equal(losses["moe_aux"], metrics["moe_aux"])
    return dict(mlm=mlm.detach().float().numpy(),
                sop=sop.detach().float().numpy(), loss=float(loss.detach()),
                aux=float(metrics["moe_aux"].detach()),
                grads=convert.params_to_jax(dict(zip(params, grads))))


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.fixture(scope="module")
def jparams(batch):
    return _jax_init(batch)


@pytest.fixture(scope="module")
def named(jparams):
    return _jax_named(jparams)


@pytest.mark.parametrize("policy", ["fused_ln"])
def test_bf16_logits_and_loss_match(batch, jparams, named, policy):
    ref = _jax_run(jparams, batch, jnp.bfloat16, policy, with_grads=False,
                   compiler_options={"xla_allow_excess_precision": False})
    port = _port_run(named, batch, torch.bfloat16, policy)
    np.testing.assert_allclose(port["mlm"], ref["mlm"], **BF16["logits"])
    np.testing.assert_allclose(port["sop"], ref["sop"], **BF16["logits"])
    assert abs(port["loss"] - ref["loss"]) <= BF16["loss"]


def test_gradient_schema_fingerprint_equals_a_jax_moe_peers(jparams):
    _cfg, model = build_model("tiny", device="cpu", **MOE)
    ours = {convert.grad_name(n, p.ndim)[0]:
            convert.to_jax_layout(torch.zeros_like(p), convert.grad_name(n, p.ndim)[1]).numpy()
            for n, p in model.named_parameters()}
    theirs = _tree_to_named(jax.tree.map(jnp.zeros_like, jparams))
    assert schema_fingerprint(ours) == jax_fingerprint(theirs)
    dense = build_model("tiny", device="cpu")[1]
    assert len(list(dense.parameters())) == 32 != len(ours)


def _jax_lamb_state(jparams):
    tx = jax_lamb(1e-3, weight_decay=0.01)
    state = jax.tree.map(lambda x: x + 3 if x.dtype == jnp.int32 else x + 0.25,
                         tx.init(jparams))
    return tx, state


def _port_loss(params, batch):
    model = AlbertForPreTraining(AlbertConfig.tiny(dtype=torch.float32, **MOE))
    model.load_state_dict(params)
    loss, _ = build_loss_fn(model)(dict(model.named_parameters()),
                                   drop_collator_keys(batch, device="cpu"))
    return float(loss)


def _jax_loss(jparams, batch):
    model = JaxModel(JaxConfig.tiny(dtype=jnp.float32, **MOE))
    jb = {k: jnp.asarray(batch[k]) for k in drop_collator_keys(batch, "cpu")}
    loss, _ = jax.jit(jax_build_loss_fn(model))(jparams, jb, jax.random.PRNGKey(1))
    return float(loss)


def test_a_jax_moe_checkpoint_loads_into_the_port(tmp_path, batch, jparams):
    _tx, jstate = _jax_lamb_state(jparams)
    jax_save(str(tmp_path), 3, _tree_to_named(jax.device_get((jparams, jstate))),
             metadata={"step": 3, "local_step": 3})
    step, named, _meta = load_latest_checkpoint(str(tmp_path))
    params, lamb_state = convert.state_from_jax(named)
    assert step == 3 and lamb_state.count == 3
    for leaf in MOE_LEAVES:
        mu = lamb_state.mu[f"albert.encoder.layer.block.{leaf}"]
        assert mu.shape == jparams["albert"]["encoder"]["layer"]["block"][leaf].shape
        assert bool((mu == 0.25).all())
    assert abs(_port_loss(params, batch) - _jax_loss(jparams, batch)) <= FP32["loss"]


def test_a_port_moe_checkpoint_loads_into_jax(tmp_path, batch, jparams):
    _cfg, model = build_model("tiny", device="cpu", seed=5, **MOE)
    params = {k: v.detach() for k, v in model.named_parameters()}
    tx = Lamb(learning_rate=1e-3, weight_decay=0.01, max_grad_norm=1.0)
    state = tx.init(params)
    save_checkpoint(str(tmp_path), 2,
                    convert.state_to_jax(params, state, clip=True, schedule=False),
                    metadata={"step": 2, "local_step": 2})
    _step, named, _meta = jax_load(str(tmp_path))
    jtx = jax_lamb(1e-3, weight_decay=0.01, max_grad_norm=1.0)
    like = (jparams, jtx.init(jparams))
    loaded_params, _opt = _named_to_tree(named, like)
    assert abs(_jax_loss(loaded_params, batch) - _port_loss(params, batch)) <= FP32["loss"]


def test_the_trainer_role_takes_a_global_step_with_experts(tmp_path, monkeypatch):
    monkeypatch.setenv("DEDLOC_FORCE_CPU", "1")
    args = parse_config(CollaborationArguments, [
        "--dht.experiment_prefix", "torch-moe-trainer",
        "--dht.listen_host", "127.0.0.1",
        "--training.model_size", "tiny",
        "--training.moe_experts", "4",
        "--training.moe_capacity_factor", "1.25",
        "--training.moe_aux_weight", "0.01",
        "--training.per_device_batch_size", "2",
        "--training.seq_length", "32",
        "--training.gradient_accumulation_steps", "2",
        "--training.warmup_steps", "0",
        "--training.max_local_steps", "2",
        "--training.save_steps", "1",
        "--training.output_dir", str(tmp_path / "out"),
        "--training.train_log_path", str(tmp_path / "train.jsonl"),
        "--optimizer.target_batch_size", "4",
        "--averager.metadata_expiration", "0.2",
        "--averager.min_refresh_period", "0.1",
        "--averager.default_refresh_period", "0.2",
        "--checkpoint.cache_dir", "none",
    ])
    state = run_trainer(args)
    assert any(n.endswith("moe_wi") for n in state.params)
    records = [json.loads(line) for line in
               (tmp_path / "train.jsonl").read_text().splitlines()]
    assert records and all(np.isfinite(r["loss"]) for r in records)
    _step, named, _meta = load_latest_checkpoint(str(tmp_path / "out"))
    assert "[0]['albert']['encoder']['layer']['block']['moe_wi']" in named


def test_weight_decay_covers_the_moe_leaves_as_the_jax_mask_does(jparams):
    from dedloc_tpu.optim.lamb import albert_weight_decay_mask as jax_mask
    from dedloc_tpu_torch.optim.lamb import albert_weight_decay_mask

    _cfg, model = build_model("tiny", device="cpu", **MOE)
    params = dict(model.named_parameters())
    mask = albert_weight_decay_mask(params)
    ours = {convert.grad_name(n, p.ndim)[0]: mask[n] for n, p in params.items()}
    theirs = _tree_to_named(jax_mask(jparams))
    assert ours == {k: bool(v) for k, v in theirs.items()}
    assert all(ours[f"['albert']['encoder']['layer']['block']['{leaf}']"]
               for leaf in MOE_LEAVES)
