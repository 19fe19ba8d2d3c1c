"""The port's Switch-MoE ALBERT-large against the JAX package's at full width
and depth: 8 experts, capacity factor 1.25, the 24 applications of the
shared block, on the weights the port draws from seed 0 (carried by
``models/convert.py``) and the first sample of the full-width cell's probe
batch (``chip_smoke.py``: 1 x 512 tokens, C = 80). Per application, the
routing of the tokens each package sends to the expert FFN: the clear tokens
routed alike, the share dropped over capacity, aux, and the hidden states
themselves, in bf16 as the cell runs. Both packages' routing collapses onto
one expert in the later applications of this model at init: the collapse is
the model's, not the port's.

``python tests/test_torch_moe_large.py`` prints the table per application."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dedloc_tpu.parallel.moe as jax_moe
from dedloc_tpu.collaborative.optimizer import _named_to_tree
from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.models.albert import AlbertForPreTraining as JaxModel
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models.albert import (
    AlbertConfig,
    AlbertForPreTraining,
    init_weights,
    recorded_routing,
)
from dedloc_tpu_torch.roles.common import drop_collator_keys, synthetic_mlm_batches

MOE = dict(moe_experts=8, moe_capacity_factor=1.25, moe_aux_weight=0.01)
APPLICATIONS = 24
MARGIN = 1e-5  # a clear token: top-1/top-2 gate margin above this
# per application, after up to 24 applications in bf16: the clear tokens
# routed alike, |dropped share port - JAX|, aux relative, and the hidden
# states' relative error (readings: >= 0.984, <= 0.004, <= 1.7e-3, <= 3.2e-2)
ROUTED_ALIKE = 0.97
DROPPED_TOL = 0.02
AUX_REL = 1e-2
HIDDEN_REL = 0.1


def _port(cfg, batch):
    """The port's model from seed 0, one forward: each application's routing
    and its expert-FFN input (the attention's output)."""
    model = AlbertForPreTraining(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    hidden = []
    handle = model.albert.encoder.layer.block.attention.register_forward_hook(
        lambda _m, _a, out: hidden.append(
            out.detach().float().reshape(-1, out.shape[-1]).numpy()))
    tb = drop_collator_keys(batch, device="cpu")
    try:
        with recorded_routing(model) as seen, torch.no_grad():
            model(tb["input_ids"], tb["attention_mask"], tb["token_type_ids"],
                  mlm_positions=tb["mlm_positions"])
    finally:
        handle.remove()
    return model, seen, hidden


def _jax(model, batch):
    """The JAX model on the port's weights, each application's routing read
    from inside its scan through a host callback around ``moe_ffn``."""
    jm = JaxModel(JaxConfig.large(**MOE))
    like = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    named = convert.params_to_jax({k: v.detach() for k, v in model.named_parameters()})
    params = _named_to_tree({k: jnp.asarray(v) for k, v in named.items()}, like)
    seen, real = [], jax_moe.moe_ffn

    def observed(p, x, cfg, mesh=None, axis="expert"):
        y, aux = real(p, x, cfg, mesh=mesh, axis=axis)
        # moe_ffn's own routing expressions
        gates = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
        expert = jnp.argmax(gates, axis=-1)
        assign = jax.nn.one_hot(expert, cfg.num_experts, dtype=jnp.float32)
        position = jnp.cumsum(assign, axis=0) * assign - 1.0
        capacity = max(1, math.ceil(x.shape[0] / cfg.num_experts
                                    * cfg.capacity_factor))
        keep = jnp.any((position < capacity) & (assign > 0), axis=-1)
        jax.debug.callback(
            lambda *a: seen.append(tuple(np.asarray(v) for v in a)),
            x.astype(jnp.float32), gates, expert, keep, aux, ordered=True)
        return y, aux

    jb = {k: jnp.asarray(v) for k, v in drop_collator_keys(batch, "cpu").items()}
    forward = jax.jit(lambda p: jm.apply(
        {"params": p}, jb["input_ids"], jb["attention_mask"], jb["token_type_ids"],
        mlm_positions=jb["mlm_positions"], mutable=("losses",)),
        compiler_options={"xla_allow_excess_precision": False})
    jax_moe.moe_ffn = observed
    try:
        jax.block_until_ready(forward(params))
    finally:
        jax_moe.moe_ffn = real
    return seen


def witness():
    """Per application: the JAX and port routing of one full-width forward."""
    cfg = AlbertConfig.large(**MOE)
    batch = next(synthetic_mlm_batches(cfg, 12, 512, 7))
    batch = {k: v[:1] for k, v in batch.items()}
    model, port, port_hidden = _port(cfg, batch)
    rows = []
    for r, ours, (x, gates, expert, keep, aux) in zip(port, port_hidden,
                                                      _jax(model, batch)):
        top2 = np.sort(gates, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > MARGIN
        rows.append(dict(
            routed_alike=float(np.mean(r.expert.numpy()[clear] == expert[clear])),
            clear=float(clear.mean()),
            dropped_port=1.0 - float(r.keep.float().mean()),
            dropped_jax=1.0 - float(keep.mean()),
            aux_port=float(r.aux), aux_jax=float(aux),
            busiest_port=int(np.bincount(r.expert.numpy(), minlength=8).max()),
            busiest_jax=int(np.bincount(expert, minlength=8).max()),
            hidden_rel=float(np.linalg.norm(ours - x) / np.linalg.norm(x)),
        ))
    return rows


@pytest.fixture(scope="module")
def rows():
    return witness()


def test_both_packages_apply_the_block_24_times(rows):
    assert len(rows) == APPLICATIONS


@pytest.mark.parametrize("application", range(APPLICATIONS))
def test_the_application_routes_as_in_jax(rows, application):
    row = rows[application]
    assert row["clear"] > 0.99
    assert row["routed_alike"] >= ROUTED_ALIKE, row
    assert abs(row["dropped_port"] - row["dropped_jax"]) <= DROPPED_TOL, row
    assert abs(row["aux_port"] - row["aux_jax"]) <= AUX_REL * row["aux_jax"], row
    assert row["hidden_rel"] <= HIDDEN_REL, row


def test_the_routing_collapses_in_both_packages(rows):
    """Most tokens pick one expert in the later applications of both, and
    most ride the residual: a property of the model at init."""
    for side in ("port", "jax"):
        assert max(r[f"busiest_{side}"] for r in rows) > 0.9 * 512
        assert max(r[f"dropped_{side}"] for r in rows) > 0.75


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    keys = ("routed_alike", "dropped_port", "dropped_jax", "aux_port", "aux_jax",
            "busiest_port", "busiest_jax", "hidden_rel")
    print("application " + " ".join(keys))
    for i, row in enumerate(witness()):
        print(i, " ".join(repr(row[k]) for k in keys))
    model = AlbertForPreTraining(AlbertConfig.large(**MOE))
    init_weights(model, torch.Generator().manual_seed(0))
    router = model.albert.encoder.layer.block.moe_router.detach()
    print("router_sum", float(router.double().sum()))
