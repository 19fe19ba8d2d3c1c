"""What each rank of a CPU mesh test runs (``torch_mesh_ranks.run_ranks``).
Torch and the port only: the JAX references run in the test process."""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.parallel import mesh as M


def _t(x):
    return torch.as_tensor(np.asarray(x))


def collectives(rank, world, inputs):
    """Each collective forward and backward on a (data=2, model=2) mesh."""
    mesh = M.make_mesh(world, ("data", "model"), (2, 2), device_type="cpu")
    x = _t(inputs["x"][rank]).requires_grad_()
    w = _t(inputs["w"][rank])
    out = {"coords": mesh.index, "backend": mesh.backend}
    for name, fn in (
        ("psum_data", lambda v: M.psum(v, mesh, "data")),
        ("psum_both", lambda v: M.psum(v, mesh, ("data", "model"))),
        ("pmean_model", lambda v: M.pmean(v, mesh, "model")),
        ("copy_to_data", lambda v: M.copy_to(v, mesh, "data")),
        ("gather_model", lambda v: M.gather(v, mesh, "model", dim=1)),
        ("ppermute_ring", lambda v: M.ppermute(v, mesh, "data", [(0, 1), (1, 0)])),
        ("ppermute_shift", lambda v: M.ppermute(v, mesh, "model", [(0, 1)])),
    ):
        y = fn(x)
        wy = torch.as_tensor(np.asarray(inputs["w_" + name][rank]))
        (g,) = torch.autograd.grad((y * wy).sum(), x)
        out[name] = (y.detach().numpy(), g.numpy())
    del w
    # bf16 rides the wire as bits: exact
    b = _t(inputs["x"][rank]).to(torch.bfloat16)
    out["gather_bf16"] = M.all_gather(b, mesh, "data").float().numpy()
    out["finite"] = bool(M.all_finite([x.detach()], mesh))
    bad = x.detach().clone()
    if rank == 3:
        bad[0, 0] = float("nan")
    out["finite_one_nan"] = bool(M.all_finite([bad], mesh))
    # put_batch over data and seq
    seq_mesh = M.make_mesh(world, ("data", "seq"), (2, 2), device_type="cpu")
    batch = {k: np.asarray(v) for k, v in inputs["batch"].items()}
    local = M.put_batch(batch, seq_mesh, seq_axis="seq", seq_length=8)
    out["put_batch"] = {k: v.numpy() for k, v in local.items()}
    # a mesh the world cannot hold, and a shape that does not hold it
    errors = {}
    for key, call in (("world", lambda: M.make_mesh(2, device_type="cpu")),
                      ("shape", lambda: M.make_mesh(world, ("data", "model"),
                                                    (2, 3), device_type="cpu"))):
        try:
            call()
        except ValueError as e:
            errors[key] = str(e)
    out["errors"] = errors
    return out


# ------------------------------------------------------------ the ALBERT step


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()


def albert_steps(rank, world, inputs):
    """A tiny ALBERT slice: ``inputs["steps"]`` LAMB steps of accumulated
    micro-batches through the port's mesh builders, on the given axes."""
    from dedloc_tpu_torch.models.albert import AlbertConfig, AlbertForPreTraining
    from dedloc_tpu_torch.optim.lamb import Lamb
    from dedloc_tpu_torch.parallel.sharding import (
        partition_specs,
        rules_for,
        shard_module,
    )
    from dedloc_tpu_torch.parallel.train_step import (
        TrainState,
        make_accumulate_step,
        make_guarded_apply_step,
        reduce_grads,
        zeros_like_grads,
    )
    from dedloc_tpu_torch.parallel.zero import opt_state_shardings, shard_opt_state
    from dedloc_tpu_torch.roles.common import build_loss_fn
    from dedloc_tpu_torch.utils.device import divide

    axes, shape = inputs["axes"], inputs["shape"]
    mesh = M.make_mesh(world, axes, shape, device_type="cpu")
    over = dict(inputs["cfg"], mesh=mesh)
    if "seq" in axes:
        over.update(ring_mesh=mesh, attention_impl="ring")
    if "pipe" in axes:
        over["pipe_mesh"] = mesh
    if "expert" in axes:
        over["moe_mesh"] = mesh
    cfg = AlbertConfig.tiny(**over)
    model = AlbertForPreTraining(cfg)
    model.load_state_dict(convert.params_from_jax(inputs["weights"]))
    full_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    rules = rules_for(mesh)
    shard_module(model, mesh, rules)
    params = dict(model.named_parameters())
    pspecs = partition_specs(params, rules)
    tx = Lamb(**inputs["lamb"])
    state = TrainState.create(params, tx)
    ospecs = opt_state_shardings(state.opt_state, mesh,
                                 axis="data" if inputs.get("zero") else None,
                                 tp_rules=rules, full_shapes=full_shapes)
    state.opt_state = shard_opt_state(state.opt_state, mesh, shardings=ospecs,
                                      param_specs=pspecs)
    accumulate = make_accumulate_step(build_loss_fn(model))
    apply = make_guarded_apply_step(tx, mesh=mesh, opt_state_sharding=ospecs,
                                    param_sharding=pspecs)
    seq = inputs.get("seq_length")
    out = {"metrics": [], "grads": [], "ok": []}
    for micro_batches in inputs["batches"]:
        grad_acc, n = zeros_like_grads(params), 0
        step_metrics = []
        for micro in micro_batches:
            batch = M.put_batch(micro, mesh, seq_axis="seq" if "seq" in axes else None,
                                seq_length=seq)
            grad_acc, n, metrics = accumulate(params, grad_acc, n, batch)
            step_metrics.append({k: float(v) for k, v in metrics.items()})
        mean = {k: divide(g, n) for k, g in reduce_grads(grad_acc, mesh, pspecs).items()}
        out["metrics"].append(step_metrics)
        out["grads"].append(convert.params_to_jax_gathered(mean, mesh, rules))
        state, ok = apply(state, mean)
        out["ok"].append(bool(ok))
    out["params"] = convert.params_to_jax_gathered(params, mesh, rules)
    # the JAX weights cut straight to this rank's blocks
    blocks = convert.params_from_jax_sharded(inputs["weights"], mesh, rules)
    out["blocks_shapes"] = {k: tuple(v.shape) for k, v in blocks.items()}
    # per rank: digests of the parameter and moment blocks it holds, and
    # their shapes (replicated leaves must agree bitwise across ranks)
    out["digests"] = {k: _digest(p) for k, p in params.items()}
    out["shapes"] = {k: tuple(p.shape) for k, p in params.items()}
    for field in ("mu", "nu"):
        for k, t in getattr(state.opt_state, field).items():
            out["digests"][f"{field}:{k}"] = _digest(t)
            out["shapes"][f"{field}:{k}"] = tuple(t.shape)
    out["pspecs"] = {k: tuple(v) for k, v in pspecs.items()}
    out["ospecs"] = {k: tuple(v) for k, v in ospecs.mu.items()}
    out["counts"] = (int(state.opt_state.count), int(state.step))
    return out


# --------------------------------------------------------------- pipeline


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _reduce(t, mesh, axes):
    return M.all_reduce(t, mesh, axes).numpy()


def pipeline(rank, world, inputs):
    """The JAX pipeline tests' cases on a 4-stage pipe axis, and dp2 x pp2."""
    from dedloc_tpu_torch.parallel.pipeline import (
        last_stage_grad,
        pipeline_apply,
        stage_param_sharding,
    )

    mesh = M.make_mesh(world, ("pipe",), device_type="cpu")
    full = {k: _t(v) for k, v in inputs["params"].items()}
    out = {"fwd": pipeline_apply(_stage, full, _t(inputs["micro"]), mesh).numpy()}
    params = {k: v.clone().requires_grad_() for k, v in full.items()}
    y = pipeline_apply(_stage, params, _t(inputs["micro2"]), mesh)
    loss = ((y - _t(inputs["tgt"])) ** 2).mean()
    gw, gb = torch.autograd.grad(last_stage_grad(loss, mesh), [params["w"], params["b"]])
    # each stage's part of the gradient; the sum over the pipe is the whole
    out["grads"] = {"w": _reduce(gw, mesh, "pipe"), "b": _reduce(gb, mesh, "pipe")}
    out["loss"] = float(loss)
    # this rank's [1, ...] block of the stacked params
    spec = stage_param_sharding(mesh)
    block = {k: v[M.local_block(v.shape, spec, mesh)] for k, v in full.items()}
    out["block_shape"] = tuple(block["w"].shape)
    out["fwd_block"] = pipeline_apply(_stage, block, _t(inputs["micro3"]), mesh).numpy()
    errors = {}
    for key, call in (
        ("stages", lambda: pipeline_apply(
            _stage, {"w": torch.zeros(8, 16, 16), "b": torch.zeros(8, 16)},
            torch.zeros(2, 2, 16), mesh)),
        ("micro_spec", lambda: pipeline_apply(
            _stage, full, torch.zeros(2, 2, 16), mesh, micro_spec=M.P("pipe"))),
    ):
        try:
            call()
        except ValueError as e:
            errors[key] = str(e)
    out["errors"] = errors
    # dp2 x pp2: each rank holds its data rows of every microbatch
    dp = M.make_mesh(world, ("data", "pipe"), (2, 2), device_type="cpu")
    two = {k: v[:2] for k, v in full.items()}
    micro = inputs["micro_dp"]
    local = _t(micro[:, 2 * dp.axis_index("data"):2 * dp.axis_index("data") + 2])
    out["fwd_dp"] = pipeline_apply(_stage, two, local, dp,
                                   micro_spec=M.P(None, "data")).numpy()
    out["coords_dp"] = dp.index
    return out


def ring(rank, world, inputs):
    """Ring attention over a 4-rank seq axis, against the dense reference
    in the test: outputs with and without a key mask, and gradients."""
    from dedloc_tpu_torch.parallel.ring_attention import ring_attention

    mesh = M.make_mesh(world, ("seq",), device_type="cpu")
    s = inputs["q"].shape[1] // world
    cut = lambda a: _t(a[:, rank * s:(rank + 1) * s]).contiguous()
    q, k, v = (cut(inputs[n]) for n in "qkv")
    out = {"plain": ring_attention(q, k, v, mesh=mesh).numpy(),
           "masked": ring_attention(q, k, v, cut(inputs["bias"]), mesh=mesh).numpy()}
    q, k, v = (cut(inputs[n + "2"]).requires_grad_() for n in "qkv")
    loss = (ring_attention(q, k, v, mesh=mesh) ** 2).sum()
    # each rank's loss is its queries' part; the ring carries the keys'
    # gradients back to their ranks
    out["grads"] = [g.numpy() for g in torch.autograd.grad(loss, [q, k, v])]
    return out


def moe(rank, world, inputs):
    """``moe_ffn`` with experts over a 4-rank expert axis against the one
    device layer, and slice-wide routing on a (data=2, expert=2) mesh."""
    from dedloc_tpu_torch.parallel import moe as pm

    cfg = pm.MoEConfig(**inputs["cfg"])
    full = {k: _t(v) for k, v in inputs["params"].items()}
    x = _t(inputs["x"])
    mesh = M.make_mesh(world, ("expert",), device_type="cpu")
    specs = pm.expert_param_sharding(mesh)
    local = {k: full[k][M.local_block(full[k].shape, specs[k], mesh)].clone()
             .requires_grad_() for k in full}
    xg = x.clone().requires_grad_()
    y, aux = pm.moe_ffn(local, xg, cfg, mesh=mesh)
    loss = (y ** 2).mean() + aux
    grads = torch.autograd.grad(loss, [local["router"], local["wi"], local["wo"], xg])
    out = {"y": y.detach().numpy(), "aux": float(aux), "wi_shape": tuple(local["wi"].shape),
           "grads": [g.numpy() for g in grads]}
    # slice-wide routing: two data shards of the tokens, experts split too
    dm = M.make_mesh(world, ("data", "expert"), (2, 2), device_type="cpu")
    t = inputs["x_skew"].shape[0] // 2
    d = dm.axis_index("data")
    xs = _t(inputs["x_skew"][d * t:(d + 1) * t])
    skew = dict(full, router=_t(inputs["router_skew"]))
    r = pm.route(skew["router"], xs, cfg, dm)
    out["skew_route"] = (r.expert.numpy(), r.position.numpy(), r.keep.numpy(),
                         r.capacity, float(r.aux))
    ne = cfg.num_experts // 2
    e = dm.axis_index("expert")
    skew_local = {"router": skew["router"], "wi": skew["wi"][e * ne:(e + 1) * ne],
                  "wo": skew["wo"][e * ne:(e + 1) * ne]}
    out["skew_y"] = pm.moe_ffn(skew_local, xs, cfg, mesh=dm)[0].numpy()
    out["coords_dm"] = dm.index
    return out


def zero(rank, world, inputs):
    """A ZeRO-1 LAMB apply over a 4-rank data axis against the replicated
    apply (the JAX package's tests/test_zero.py case)."""
    from dedloc_tpu_torch.optim.lamb import Lamb
    from dedloc_tpu_torch.parallel.train_step import TrainState, make_apply_step
    from dedloc_tpu_torch.parallel.zero import opt_state_shardings, shard_opt_state

    mesh = M.make_mesh(world, ("data",), device_type="cpu")
    tx = Lamb(learning_rate=1e-2, weight_decay=0.01)
    grads = {k: _t(v) for k, v in inputs["grads"].items()}
    fresh = lambda: {k: _t(v).clone() for k, v in inputs["params"].items()}
    rep = make_apply_step(tx)(TrainState.create(fresh(), tx), grads)
    state = TrainState.create(fresh(), tx)
    ospecs = opt_state_shardings(state.opt_state, mesh)
    state.opt_state = shard_opt_state(state.opt_state, mesh)
    new = make_apply_step(tx, mesh=mesh, opt_state_sharding=ospecs)(state, grads)
    return {"replicated": {k: v.numpy() for k, v in rep.params.items()},
            "sharded": {k: v.numpy() for k, v in new.params.items()},
            "moment_shapes": {k: tuple(v.shape) for k, v in new.opt_state.mu.items()},
            "specs": {k: tuple(v) for k, v in ospecs.mu.items()}}
