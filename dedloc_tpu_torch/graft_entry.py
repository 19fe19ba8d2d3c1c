"""Entry points of the port: a forward on the flagship model and a
multi-rank sharding dryrun (the counterpart of ``__graft_entry__.py``).

``entry``            — the ALBERT-large forward (the reference's canonical
                       workload, albert/run_trainer.py) and its example
                       arguments, 4 x 128.
``dryrun_multichip`` — one full train step (forward, backward, an
                       accumulation of 2, LAMB) over an n-rank
                       ``(data, model, seq)`` mesh from ``mesh_shape_for``
                       with real dp/tp/sp layouts on tiny shapes, then the
                       ZeRO-1 apply on the same mesh; then pipeline, expert
                       and role-MoE dryruns on the same ranks, and two
                       collaborative slice peers (one tensor-parallel, one
                       pipeline-parallel) averaging over a real DHT.

Ranks are processes joined over gloo (``parallel/mesh.py``): on the CPU
when the caller asks for it (``device_type="cpu"``), otherwise sharing the
card, one process per rank, as the trainer's slices do.

Reductions against the reference, which runs on 8 virtual devices: the
port's tests spawn at most 4 ranks, so with n = 4 the mesh is (1, 2, 2)
(tensor x sequence parallel, the reference's 8 give data 2 as well); the
pipeline and expert dryruns are dp2 x pp2 and dp2 x ep2 (the reference:
dp2 x pp4 and dp2 x ep4); the role-MoE peer is one slice of 4 ranks, dp2 x
ep2 (the same as the reference's); and the two collaborative slices have 2
ranks each, tp2 and pp2 (the reference's have 4 virtual devices each, dp2
x tp2 and dp2 x pp2). The step runs in fp32, so that it can be held
against the JAX package's one-device step on the same weights and batch.

    python -m dedloc_tpu_torch.graft_entry     # entry + dryrun_multichip(4)
"""
from __future__ import annotations

import os
import pickle
import re
import sys
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from dedloc_tpu_torch.tools.ranks import start_ranks, wait_ranks

ACCUM = 2
LAMB = dict(learning_rate=1.76e-3, weight_decay=0.01)
RANK_TIMEOUT_S = 300.0


def entry(device=None):
    """Return (fn, example_args): the ALBERT-large forward on ``device``
    (the card unless the caller names another)."""
    from dedloc_tpu_torch.models.albert import (
        AlbertConfig,
        AlbertForPreTraining,
        init_weights,
    )
    from dedloc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = AlbertForPreTraining(AlbertConfig.large())
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev)
    batch, seq = 4, 128
    input_ids = torch.zeros((batch, seq), dtype=torch.int32, device=dev)
    attention_mask = torch.ones((batch, seq), dtype=torch.int32, device=dev)
    params = dict(model.named_parameters())

    @torch.no_grad()
    def forward(params, input_ids, attention_mask):
        return torch.func.functional_call(model, params, (input_ids, attention_mask))

    return forward, (params, input_ids, attention_mask)


def dryrun_config(n_devices: int, **overrides):
    """The tiny config whose dims divide the mesh's axes (the reference's
    ``dryrun_multichip`` shapes), in fp32."""
    from dedloc_tpu_torch.models.albert import AlbertConfig
    from dedloc_tpu_torch.parallel.sharding import mesh_shape_for

    (_dp, tp, sp), _axes = mesh_shape_for(n_devices)
    return AlbertConfig.tiny(
        vocab_size=128 * max(tp, 1),
        hidden_size=16 * max(tp, 1) * 2,
        intermediate_size=32 * max(tp, 1) * 2,
        num_attention_heads=2 * max(tp, 1),
        max_position_embeddings=16 * max(sp, 1) * 2,
        dtype=torch.float32,
        **overrides,
    )


def dryrun_batch(n_devices: int) -> Dict[str, np.ndarray]:
    """The dryrun's batch, [ACCUM, 2 x dp, S] (the reference's numpy
    draws, in its order)."""
    from dedloc_tpu_torch.parallel.sharding import mesh_shape_for

    (dp, _tp, _sp), _axes = mesh_shape_for(n_devices)
    cfg = dryrun_config(n_devices)
    per_step, seq = 2 * dp, cfg.max_position_embeddings
    host = np.random.default_rng(0)
    shape = (ACCUM, per_step, seq)
    return {
        "input_ids": host.integers(0, cfg.vocab_size, shape).astype(np.int32),
        "attention_mask": np.ones(shape, np.int32),
        "token_type_ids": np.zeros(shape, np.int32),
        "mlm_labels": np.where(host.random(shape) < 0.15,
                               host.integers(0, cfg.vocab_size, shape),
                               -100).astype(np.int32),
        "sop_labels": host.integers(0, 2, (ACCUM, per_step)).astype(np.int32),
    }


def dryrun_multichip(n_devices: int, device_type: Optional[str] = None,
                     weights: Optional[Dict[str, np.ndarray]] = None) -> dict:
    """One full collaborative train step, sharded dp x tp x sp over
    ``n_devices`` ranks, the ZeRO-1 apply, the pipeline, expert and
    role-MoE dryruns (with at least 4 ranks) and the two collaborative
    slices. Returns what rank 0 measured (``_dryrun_step``) and the
    slices' group sizes (``_dryrun_collaborative_slices``)."""
    out = _dryrun_step(n_devices, device_type, weights)
    if n_devices >= 4:
        out["collaborative_slices"] = _dryrun_collaborative_slices(device_type)
    return out


def _device_type(device_type: Optional[str]) -> str:
    from dedloc_tpu_torch.utils.device import resolve_device

    return resolve_device(device_type).type


def _dryrun_step(n_devices: int, device_type: Optional[str] = None,
                 weights: Optional[Dict[str, np.ndarray]] = None) -> dict:
    """The ranks of ``_rank_main`` as processes; returns rank 0's result
    (and every rank's ``counts``)."""
    dev = _device_type(device_type)
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        with open(os.path.join(work, "inputs.pkl"), "wb") as f:
            pickle.dump({"device_type": dev, "weights": weights}, f)
        wait_ranks(start_ranks(
            ["-m", "dedloc_tpu_torch.graft_entry", "--rank-worker", work],
            n_devices, work, "dryrun", dev, RANK_TIMEOUT_S))
        results = []
        for rank in range(n_devices):
            with open(os.path.join(work, f"out{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))  # written by _rank_main
    out = results[0]
    out["counts"] = [r["counts"] for r in results]
    return out


def _rank_main(work: str) -> None:
    """One rank of ``_dryrun_step``: the mesh step and the ZeRO apply, the
    pipeline and expert dryruns, then the role-MoE peer (its trainer ends
    the process group, so it comes last)."""
    from dedloc_tpu_torch.parallel.mesh import init_slice

    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)  # written by _dryrun_step
    torch.set_num_threads(1)
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    init_slice(world, inputs["device_type"])
    out = _mesh_step(world, inputs["device_type"], inputs["weights"])
    if world >= 4:
        out["pipeline_loss"] = _dryrun_pipeline(world, inputs["device_type"])
        out["moe_loss"] = _dryrun_moe(world, inputs["device_type"])
        out["role_moe"] = _dryrun_role_moe(work, world)
    with open(os.path.join(work, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _mesh_step(world: int, device_type: str,
               weights: Optional[Dict[str, np.ndarray]]) -> dict:
    """The step over the (data, model, seq) mesh and the ZeRO-1 apply."""
    from dedloc_tpu_torch.models import convert
    from dedloc_tpu_torch.models.albert import AlbertForPreTraining, init_weights
    from dedloc_tpu_torch.optim.lamb import Lamb
    from dedloc_tpu_torch.parallel import mesh as M
    from dedloc_tpu_torch.parallel.sharding import (
        mesh_shape_for,
        partition_specs,
        rules_for,
        shard_module,
    )
    from dedloc_tpu_torch.parallel.train_step import (
        TrainState,
        make_apply_step,
        make_local_train_step,
        zeros_like_grads,
    )
    from dedloc_tpu_torch.parallel.zero import opt_state_shardings, shard_opt_state
    from dedloc_tpu_torch.roles.common import build_loss_fn

    shape, axes = mesh_shape_for(world)
    mesh = M.make_mesh(world, axes, shape, device_type=device_type)
    sp = mesh.shape["seq"]
    over = dict(mesh=mesh)
    if sp > 1:
        over.update(ring_mesh=mesh, attention_impl="ring")
    cfg = dryrun_config(world, **over)
    model = AlbertForPreTraining(cfg)
    if weights is None:
        init_weights(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(convert.params_from_jax(weights))
    full_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    rules = rules_for(mesh)
    shard_module(model, mesh, rules)
    model.to(mesh.device)
    params = dict(model.named_parameters())
    pspecs = partition_specs(params, rules)
    tx = Lamb(**LAMB)
    state = TrainState.create(params, tx)
    ospecs = opt_state_shardings(state.opt_state, mesh, tp_rules=rules,
                                 full_shapes=full_shapes)
    state.opt_state = shard_opt_state(state.opt_state, mesh, shardings=ospecs,
                                      param_specs=pspecs)
    host = dryrun_batch(world)
    seq = cfg.max_position_embeddings
    micro = [M.put_batch({k: v[i] for k, v in host.items()}, mesh,
                         seq_axis="seq" if sp > 1 else None, seq_length=seq)
             for i in range(ACCUM)]
    batch = {k: torch.stack([m[k] for m in micro]) for k in micro[0]}
    train_step = make_local_train_step(build_loss_fn(model), tx,
                                       grad_accum_steps=ACCUM, mesh=mesh,
                                       opt_state_sharding=ospecs,
                                       param_sharding=pspecs)
    state, metrics = train_step(state, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss in the multichip dryrun: {loss}")
    if int(state.step) != 1:
        raise RuntimeError(f"the dryrun step left step {int(state.step)}, not 1")
    out = {"mesh": dict(mesh.shape), "loss": loss,
           "metrics": {k: float(v) for k, v in metrics.items()},
           "params": convert.params_to_jax_gathered(state.params, mesh, rules)}

    # ZeRO-1 apply on the same mesh: LAMB moments sharded over the data
    # axis, params and grads replicated (the trainer's
    # --training.zero_sharding layout). Params and moments are gathered
    # whole first, as the reference re-commits its TP-sharded state.
    whole = lambda tree: {n: t.to(mesh.device) for n, t in convert.params_from_jax(
        convert.params_to_jax_gathered(tree, mesh, rules)).items()}
    opt = state.opt_state._replace(mu=whole(state.opt_state.mu),
                                   nu=whole(state.opt_state.nu))
    zspecs = opt_state_shardings(opt, mesh, axis="data")
    zstate = TrainState(step=state.step, params=whole(state.params),
                        opt_state=shard_opt_state(opt, mesh, shardings=zspecs))
    zapply = make_apply_step(tx, mesh=mesh, opt_state_sharding=zspecs)
    zstate = zapply(zstate, zeros_like_grads(zstate.params))
    if int(zstate.step) != 2:
        raise RuntimeError(f"the ZeRO apply left step {int(zstate.step)}, not 2")
    out["zero_step"] = int(zstate.step)
    out["counts"] = (int(state.step), int(zstate.step))
    return out


def _dryrun_pipeline(world: int, device_type: str) -> float:
    """Pipeline parallelism over the same ranks: dp2 x pp(world/2), ALBERT's
    shared block applied 2 iterations per stage (the microbatch schedule of
    ``parallel/pipeline.py``), forward and backward."""
    from dedloc_tpu_torch.models.albert import AlbertConfig, AlbertLayer, init_weights
    from dedloc_tpu_torch.parallel import mesh as M
    from dedloc_tpu_torch.parallel.pipeline import (
        last_stage_grad,
        pipeline_apply,
        shared_stage_fn,
    )

    mesh = M.make_mesh(world, ("data", "pipe"), (2, world // 2),
                       device_type=device_type)
    cfg = AlbertConfig.tiny(dtype=torch.float32)
    layer = AlbertLayer(cfg)
    init_weights(layer, torch.Generator().manual_seed(0))
    layer.to(mesh.device)
    b, s = 4, 16
    rows = b // 2  # this rank's data rows of every microbatch
    hidden = torch.ones((3, rows, s, cfg.hidden_size), device=mesh.device)
    kv_bias = torch.zeros((rows, s), device=mesh.device)
    params = dict(layer.named_parameters())
    stage = shared_stage_fn(
        lambda p, x: torch.func.functional_call(layer, p, (x, kv_bias))[0], 2)
    out = pipeline_apply(stage, params, hidden, mesh, stacked_params=False,
                         micro_spec=M.P(None, "data"))
    loss = (out.float() ** 2).mean()
    grads = torch.autograd.grad(last_stage_grad(loss, mesh), list(params.values()))
    if not (np.isfinite(float(loss)) and all(torch.isfinite(g).all() for g in grads)):
        raise RuntimeError("non-finite pipelined loss or gradient")
    return float(loss)


def _dryrun_moe(world: int, device_type: str) -> float:
    """Expert parallelism over the same ranks: dp2 x ep(world/2)
    Switch-FFN, tokens split over data, experts over their own axis
    (``parallel/moe.py``); forward and backward."""
    from dedloc_tpu_torch.parallel import mesh as M
    from dedloc_tpu_torch.parallel.moe import (
        MoEConfig,
        expert_param_sharding,
        init_moe_params,
        moe_ffn,
    )

    mesh = M.make_mesh(world, ("data", "expert"), (2, world // 2),
                       device_type=device_type)
    cfg = MoEConfig(hidden_size=16, ffn_size=32, num_experts=4)
    full = init_moe_params(cfg, torch.Generator().manual_seed(0))
    specs = expert_param_sharding(mesh)
    params = {k: full[k][M.local_block(full[k].shape, specs[k], mesh)]
              .to(mesh.device).requires_grad_() for k in full}
    x = torch.ones((32 // 2, cfg.hidden_size), device=mesh.device)  # its data rows
    y, aux = moe_ffn(params, x, cfg, mesh=mesh)
    loss = (y.float() ** 2).mean() + 0.01 * aux
    grads = torch.autograd.grad(loss, list(params.values()))
    if not (np.isfinite(float(loss)) and all(torch.isfinite(g).all() for g in grads)):
        raise RuntimeError("non-finite MoE loss or gradient")
    return float(loss)


def _dryrun_role_moe(work: str, world: int) -> dict:
    """Expert parallelism through the role flags: this process group as
    one trainer slice (dp2 x ep2) of the Switch-MoE ALBERT
    (``--training.moe_experts``), experts split over the expert axis,
    taking real global steps with the aux loss in the objective."""
    from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
    from dedloc_tpu_torch.roles.trainer import run_trainer

    out_dir = os.path.join(work, "role_moe")
    state = run_trainer(parse_config(CollaborationArguments, [
        "--dht.experiment_prefix", "dryrun_moe",
        "--dht.listen_host", "127.0.0.1",
        "--training.model_size", "tiny",
        "--training.seq_length", "64",
        "--training.per_device_batch_size", "2",
        "--training.gradient_accumulation_steps", "2",
        "--optimizer.target_batch_size", "16",
        "--training.max_local_steps", "4",
        "--training.save_steps", "0",
        "--training.mesh_devices", str(world),
        "--training.mesh_expert_devices", "2",
        "--training.moe_experts", "4",
        "--training.output_dir", out_dir,
        "--averager.averaging_expiration", "2",
    ]))
    if int(state.step) < 1:
        raise RuntimeError("the MoE role peer made no global step")
    shapes = {n: tuple(p.shape) for n, p in state.params.items() if "moe_w" in n}
    # this rank's block of the 4 experts: 4 / ep2 = 2
    if not shapes or any(s[0] != 2 for s in shapes.values()):
        raise RuntimeError(f"experts not split over the expert axis: {shapes}")
    return {"step": int(state.step), "expert_blocks": shapes}


def _dryrun_collaborative_slices(device_type: Optional[str] = None,
                                 timeout: float = RANK_TIMEOUT_S) -> dict:
    """The full collaborative path: two slice peers of 2 ranks each, each
    the trainer role with its micro-batch gradient mean riding the slice's
    collectives, joined through a real DHT and averaging gradients between
    the slices over TCP. One slice is tensor-parallel (tp2), the other
    pipeline-parallel (pp2): layouts differ, the gradients are
    param-shaped either way. A real 2-slice round must form."""
    from dedloc_tpu_torch.dht import DHT

    dev = _device_type(device_type)
    root = DHT(start=True, listen_host="127.0.0.1")
    try:
        with tempfile.TemporaryDirectory(prefix="dryrun_collab_") as work:
            addr = root.get_visible_address()
            slices = []
            for idx, layout in enumerate((
                    ["--training.mesh_model_devices", "2"],
                    ["--training.mesh_pipe_devices", "2",
                     "--training.pipe_microbatches", "2"])):
                argv = [
                    "--dht.experiment_prefix", "dryrun_collab",
                    "--dht.listen_host", "127.0.0.1",
                    "--dht.initial_peers", addr,
                    "--training.model_size", "tiny",
                    "--training.seq_length", "64",
                    "--training.per_device_batch_size", "2",
                    "--training.gradient_accumulation_steps", "2",
                    "--optimizer.target_batch_size", "32",
                    "--training.max_local_steps", "24",
                    "--training.save_steps", "0",
                    "--training.mesh_devices", "2",
                    "--averager.averaging_expiration", "5",
                    "--training.output_dir", os.path.join(work, f"slice{idx}"),
                    "--training.seed", str(idx), *layout]
                slices.append(start_ranks(["-m", "dedloc_tpu_torch.roles.trainer", *argv],
                                          2, work, f"slice{idx}", dev, timeout))
            logs = wait_ranks(*slices)
            # rank 0 of each slice (2 ranks a slice) leads its averaging
            groups = {f"slice{idx}": [int(g) for g in re.findall(r"group=(\d+)", logs[2 * idx])]
                      for idx in (0, 1)}
    finally:
        root.shutdown()
    # a real cross-slice group formed (failed-round local applies also
    # advance steps and would otherwise mask a dead path between slices)
    if not any(2 in g for g in groups.values()):
        raise RuntimeError(f"no 2-slice averaging round completed: {groups}")
    return groups


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-worker":
        _rank_main(sys.argv[2])
    else:
        fn, args = entry()
        fn(*args)
        print("entry: forward OK")
        dryrun_multichip(4)
        print("dryrun_multichip(4): OK")
