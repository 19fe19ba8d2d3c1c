"""The JAX references of the mesh tests: the JAX trainer's slice pieces
(``make_mesh``, ``put_batch``, the Megatron/EP rules, ZeRO-1, the mesh
accumulate and guarded apply) on the 8-device virtual CPU mesh of
``tests/conftest.py``, and the shared inputs both packages run."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding

from dedloc_tpu.collaborative.optimizer import _named_to_tree
from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.models.albert import AlbertForPreTraining as JaxModel
from dedloc_tpu.optim.lamb import lamb as jax_lamb
from dedloc_tpu.parallel import train_step as jts
from dedloc_tpu.parallel.mesh import make_mesh, put_batch
from dedloc_tpu.parallel.sharding import (
    ALBERT_EP_RULES,
    ALBERT_TP_RULES,
    partition_specs,
)
from dedloc_tpu.parallel.zero import opt_state_shardings
from dedloc_tpu.roles.common import build_loss_fn
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models.albert import AlbertConfig, AlbertForPreTraining, init_weights
from dedloc_tpu_torch.roles.common import synthetic_mlm_batches

# the clip engaged at init, weight decay on the masked leaves, a large
# constant rate so two steps move the params
LAMB = dict(learning_rate=5e-2, weight_decay=0.01, max_grad_norm=1.0)
BATCH, SEQ, STEPS, ACCUM = 8, 32, 2, 2
# fp32 on both sides; the tolerances of tests/test_torch_train_step.py and
# tests/test_torch_moe_model.py: reduction order differs (GSPMD's collectives
# against gloo's), amplified slightly by LAMB's m / sqrt(v)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=5e-4, rtol=5e-3)
PARAM_TOL = dict(atol=2e-5, rtol=1e-4)


def weights(seed: int = 0, **cfg):
    """The port's seeded tiny weights under the JAX names (full)."""
    model = AlbertForPreTraining(AlbertConfig.tiny(dtype=torch.float32, **cfg))
    init_weights(model, torch.Generator().manual_seed(seed))
    return convert.params_to_jax(dict(model.named_parameters()))


def batches(seed: int = 1, uneven: bool = False):
    """STEPS x ACCUM micro-batches of the slice (BATCH x SEQ). ``uneven``:
    the second half of the first micro-batch keeps one masked token per
    row, so data shards hold very different masked-token counts."""
    it = synthetic_mlm_batches(AlbertConfig.tiny(), BATCH, SEQ, seed)
    out = [[next(it) for _ in range(ACCUM)] for _ in range(STEPS)]
    if uneven:
        w = out[0][0]["mlm_weights"]
        w[BATCH // 2:, 1:] = 0.0
    return out


def jax_steps(axes, shape, weights, batches, cfg=None, zero=False):
    """The JAX trainer's slice on a mesh of ``shape`` over ``axes``: the
    micro-batches accumulated, the mean applied by the guarded apply, per
    step. Returns metrics per micro-batch, the mean gradients and the
    params after the steps (numpy, JAX names)."""
    n = int(np.prod(shape))
    mesh = make_mesh(n, axis_names=tuple(axes),
                     shape=tuple(shape) if len(shape) > 1 else None)
    over = dict(cfg or {}, dtype=jnp.float32)
    if "seq" in axes:
        over.update(ring_mesh=mesh, attention_impl="ring")
    if "pipe" in axes:
        over["pipe_mesh"] = mesh
    if "expert" in axes:
        over["moe_mesh"] = mesh
    model = JaxModel(JaxConfig.tiny(**over))
    like = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((BATCH, SEQ), jnp.int32))["params"])
    params = _named_to_tree({k: jnp.asarray(v) for k, v in weights.items()}, like)
    tx = jax_lamb(**LAMB)
    state = jts.TrainState.create(params, tx)
    rules = (tuple(ALBERT_TP_RULES if "model" in axes else ())
             + tuple(ALBERT_EP_RULES if "expert" in axes else ()))
    p_sh = None
    if rules:
        p_sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                            partition_specs(state.params, rules))
    o_sh = None
    if zero or rules:
        o_sh = opt_state_shardings(state.opt_state, mesh,
                                   axis="data" if zero else None,
                                   tp_rules=rules or None)
    from jax.sharding import PartitionSpec as P

    repl = NamedSharding(mesh, P())
    state = state.replace(step=jax.device_put(state.step, repl),
                          params=jax.device_put(state.params, p_sh or repl),
                          opt_state=jax.device_put(state.opt_state, o_sh or repl))
    seq_axis = "seq" if "seq" in axes else None
    accumulate = jts.make_accumulate_step(build_loss_fn(model), mesh=mesh,
                                          seq_axis=seq_axis, seq_length=SEQ,
                                          param_sharding=p_sh)
    apply = jts.make_guarded_apply_step(tx, mesh=mesh, opt_state_sharding=o_sh,
                                        param_sharding=p_sh)
    out = {"metrics": [], "grads": [], "ok": []}
    rng = jax.random.PRNGKey(0)
    for micro_batches in batches:
        grad_acc = jts.zeros_like_grads(state.params)
        n_acc = jnp.zeros([], jnp.int32)
        step_metrics = []
        for micro in micro_batches:
            b = put_batch({k: np.asarray(v) for k, v in micro.items()
                           if k in KEYS}, mesh, seq_axis=seq_axis, seq_length=SEQ)
            grad_acc, n_acc, metrics = accumulate(state.params, grad_acc, n_acc,
                                                  b, rng)
            step_metrics.append({k: float(v) for k, v in metrics.items()})
        mean = jax.tree.map(lambda g: g / n_acc, grad_acc)
        out["metrics"].append(step_metrics)
        out["grads"].append(named(mean))
        state, ok = apply(state, mean)
        out["ok"].append(bool(ok))
    out["params"] = named(state.params)
    return out


KEYS = ("input_ids", "attention_mask", "token_type_ids", "mlm_positions",
        "mlm_label_ids", "mlm_weights", "sop_labels")


def named(tree):
    return {jax.tree_util.keystr(p): np.asarray(jax.device_get(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_inputs(axes, shape, weights, batches, cfg=None, zero=False):
    """The inputs of ``torch_mesh_cases.albert_steps``."""
    return dict(axes=tuple(axes), shape=tuple(shape),
                cfg=dict(cfg or {}, dtype=torch.float32), weights=weights,
                batches=[[{k: v for k, v in m.items() if k in KEYS} for m in s]
                         for s in batches],
                lamb=LAMB, zero=zero, seq_length=SEQ)


def assert_matches_jax(port, ref):
    """The slice's losses, mean gradients and final params against JAX's."""
    for step, (pm, jm) in enumerate(zip(port["metrics"], ref["metrics"])):
        for p, j in zip(pm, jm):
            for k in ("loss", "mlm_loss", "sop_loss"):
                np.testing.assert_allclose(p[k], j[k], rtol=LOSS_RTOL,
                                           err_msg=f"step {step} {k}")
    for step, (pg, jg) in enumerate(zip(port["grads"], ref["grads"])):
        assert sorted(pg) == sorted(jg)
        for k in jg:
            np.testing.assert_allclose(pg[k], jg[k], err_msg=f"step {step} {k}",
                                       **GRAD_TOL)
    for k, v in ref["params"].items():
        np.testing.assert_allclose(port["params"][k], v, err_msg=k, **PARAM_TOL)
    assert port["ok"] == ref["ok"] == [True] * STEPS


def assert_replicas_bitwise(outs, axes, shape):
    """Every block that ranks hold in common is bitwise equal across them:
    for each leaf, the ranks with the same coordinates on the axes the
    leaf is split over hold the same bytes (parameters and moments)."""
    from dedloc_tpu_torch.parallel.mesh import MeshLayout

    layout = MeshLayout(axes, shape)
    specs = dict(outs[0]["pspecs"])
    specs.update({f"{f}:{k}": v for k, v in outs[0]["ospecs"].items()
                  for f in ("mu", "nu")})
    for leaf, spec in specs.items():
        split = [a for a in spec if a is not None]
        groups = {}
        for rank, o in enumerate(outs):
            key = tuple(layout.coords(rank)[a] for a in split)
            groups.setdefault(key, set()).add(o["digests"][leaf])
        for key, digests in groups.items():
            assert len(digests) == 1, f"{leaf}: ranks at {key} differ"
    counts = {o["counts"] for o in outs}
    assert len(counts) == 1, counts
