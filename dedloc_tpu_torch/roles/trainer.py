"""Trainer peer: the canonical collaborative training loop, on the card.

Port of ``dedloc_tpu/roles/trainer.py``: build model + LAMB + DHT +
CollaborativeOptimizer, resume from the latest local checkpoint, pull newer
state from peers at start, then loop: accumulate per micro-batch into an
fp32 accumulator on the card; at every accumulation boundary hand control to
the collaborative optimizer (global-step averaging, NaN rollback) and
publish signed metrics.

It runs on the card unless ``DEDLOC_FORCE_CPU=1`` asks for the CPU. The
batches are the JAX trainer's for the same inputs and peer key: synthetic,
tokenized shards on disk (``--training.dataset_path``) or a streamed,
tokenized text mix (``--training.streaming_files``). The Switch-MoE
variant runs with ``--training.moe_experts`` (and
``--training.moe_capacity_factor``, ``--training.moe_aux_weight``).

    python -m dedloc_tpu_torch.roles.trainer --dht.experiment_prefix run \\
        --optimizer.target_batch_size 48 --training.per_device_batch_size 12

With ``--training.mesh_devices N`` the peer is a slice of N ranks, one per
mesh device (``parallel/mesh.py``), launched by torchrun::

    python -m torch.distributed.run --nproc_per_node N \\
        -m dedloc_tpu_torch.roles.trainer --training.mesh_devices N ...

The mesh is the JAX trainer's: ``mesh_{model,seq,pipe,expert}_devices``
carve the tensor, sequence (ring attention), pipeline and expert axes out
of it with the same refusals, the data axis takes the rest, and
``--training.zero_sharding`` shards the LAMB moments over the data axis.
The slice is one collaboration peer: rank 0 runs the DHT, the averager,
telemetry and checkpoints and leads the other ranks through each
boundary (``collaborative/slice.py``); every rank draws the slice's whole
batch (``per_device_batch_size x mesh_devices`` rows) and takes its part.
"""
from __future__ import annotations

import json
import time
from typing import Optional

import torch
import torch.distributed as dist

from dedloc_tpu_torch.collaborative.metrics import LocalMetrics, publish_metrics
from dedloc_tpu_torch.collaborative.optimizer import (
    CollaborativeOptimizer,
    _state_views,
    adopt_state,
)
from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.data.mlm import max_predictions_for
from dedloc_tpu_torch.data.streaming import peer_shuffle_seed
from dedloc_tpu_torch.ops import flash_attention, fused_ln
from dedloc_tpu_torch.collaborative.slice import Slice
from dedloc_tpu_torch.parallel.mesh import init_slice, make_mesh, put_batch
from dedloc_tpu_torch.parallel.train_step import (
    TrainState,
    make_accumulate_step,
    make_guarded_apply_step,
    zeros_like_grads,
)
from dedloc_tpu_torch.roles.common import (
    build_authorizer,
    build_dht,
    build_flat_opt_factory,
    build_loss_fn,
    build_model,
    build_optimizer,
    checkpoint_kwargs,
    configure_role_telemetry,
    drop_collator_keys,
    force_cpu_if_requested,
    loss_keys,
    synthetic_mlm_batches,
)
from dedloc_tpu_torch.telemetry import steps
from dedloc_tpu_torch.telemetry.links import endpoint_key
from dedloc_tpu_torch.telemetry.steps import (
    StepRecorder,
    albert_tflops_per_sample,
    chip_peak_tflops,
)
from dedloc_tpu_torch.utils.checkpoint import load_latest_checkpoint, save_checkpoint
from dedloc_tpu_torch.utils.logging import get_logger
from dedloc_tpu_torch.utils.perf import PerfStats

logger = get_logger(__name__)


def slice_axes(args: CollaborationArguments):
    """The slice mesh's (axis names, shape) from the flags, with the JAX
    trainer's refusals; None for a one-device peer."""
    tr = args.training
    if tr.mesh_devices > 1:
        sp = max(1, tr.mesh_seq_devices)
        tp = max(1, tr.mesh_model_devices)
        pp = max(1, tr.mesh_pipe_devices)
        ep = max(1, tr.mesh_expert_devices)
        if tr.mesh_devices % (sp * tp * pp * ep):
            raise ValueError(
                f"mesh_seq_devices ({sp}) x mesh_model_devices ({tp}) x "
                f"mesh_pipe_devices ({pp}) x mesh_expert_devices ({ep}) "
                f"must divide mesh_devices ({tr.mesh_devices})")
        if pp > 1 and (sp > 1 or tp > 1):
            raise ValueError(
                "mesh_pipe_devices composes with the data axis only; "
                "seq/model axes need collectives inside the pipeline stage")
        if ep > 1 and not tr.moe_experts:
            raise ValueError(
                "mesh_expert_devices > 1 needs --training.moe_experts > 0")
        if tr.moe_experts and tr.moe_experts % ep:
            raise ValueError(
                f"moe_experts ({tr.moe_experts}) must divide evenly over "
                f"mesh_expert_devices ({ep})")
        dp = tr.mesh_devices // (sp * tp * pp * ep)
        names, dims = ["data"], [dp]
        for name, size in (("model", tp), ("seq", sp), ("pipe", pp),
                           ("expert", ep)):
            if size > 1:
                names.append(name)
                dims.append(size)
        axes = (tuple(names), tuple(dims))
    elif (tr.mesh_seq_devices > 1 or tr.mesh_model_devices > 1
          or tr.mesh_pipe_devices > 1 or tr.mesh_expert_devices > 1):
        raise ValueError(
            "mesh_seq/model/pipe/expert_devices > 1 require mesh_devices > 1")
    else:
        axes = None
    if tr.attention_impl == "ring" and (axes is None or "seq" not in axes[0]):
        raise ValueError(
            "attention_impl='ring' needs a sequence-parallel mesh axis: set "
            "--training.mesh_seq_devices > 1 (and mesh_devices divisible by it)")
    if tr.zero_sharding and axes is None:
        raise ValueError(
            "--training.zero_sharding shards optimizer moments over a slice "
            "mesh; set --training.mesh_devices > 1")
    return axes


def run_trainer(args: CollaborationArguments) -> TrainState:
    device = force_cpu_if_requested()
    tr = args.training
    axes = slice_axes(args)
    mesh = None
    if axes is not None:
        init_slice(tr.mesh_devices, device.type, tr.mesh_device_offset)
        mesh = make_mesh(tr.mesh_devices, axes[0],
                         axes[1] if len(axes[1]) > 1 else None,
                         tr.mesh_device_offset, device.type)
        device = mesh.device
        logger.info(f"slice mesh: {dict(mesh.shape)}, rank {mesh.rank} on "
                    f"{device}, backend {mesh.backend}")
    leader = mesh is None or mesh.rank == 0
    # gated runs: token handshake BEFORE any heavy setup, so bad credentials
    # fail in milliseconds
    authorizer, authority_public_key = (build_authorizer(args) if leader
                                        else (None, None))
    on = lambda name: mesh if mesh is not None and name in mesh.shape else None
    cfg, model = build_model(tr.model_size, tr.remat_policy, tr.attention_impl,
                             tr.vocab_size, device=device, seed=tr.seed,
                             moe_experts=tr.moe_experts,
                             moe_capacity_factor=tr.moe_capacity_factor,
                             moe_aux_weight=tr.moe_aux_weight,
                             ring_mesh=on("seq"), pipe_mesh=on("pipe"),
                             pipe_microbatches=tr.pipe_microbatches,
                             moe_mesh=on("expert"), mesh=mesh)
    tx = build_optimizer(args)
    dht = tele = None
    tele_close = lambda: None
    public_key = b""
    if leader:
        dht, public_key = build_dht(
            args,
            private_key=(
                authorizer.local_private_key if authorizer is not None else None
            ),
        )
        logger.info(f"trainer DHT listening on {dht.port}")
        tele, tele_close = configure_role_telemetry(args, public_key)

    seq = min(tr.seq_length, cfg.max_position_embeddings)
    # the slice's batch: per_device_batch_size rows per mesh device, split
    # over the data axis (replicated over the others)
    slice_batch = tr.per_device_batch_size * max(1, tr.mesh_devices)
    state = TrainState.create(dict(model.named_parameters()), tx)
    param_sharding = opt_sharding = the_slice = apply_fn = None
    if mesh is not None:
        state, param_sharding, opt_sharding = _shard_state(state, mesh, tx,
                                                           tr.zero_sharding)
        the_slice = Slice(mesh, tx, param_sharding, opt_sharding)
        apply_fn = make_guarded_apply_step(tx, mesh=mesh,
                                           opt_state_sharding=opt_sharding,
                                           param_sharding=param_sharding)
        # every rank draws the slice's batches from rank 0's peer key
        box = [public_key]
        dist.broadcast_object_list(box, src=0)
        public_key = box[0]
    if not leader:
        try:
            return _follow(args, cfg, model, state, the_slice, apply_fn, mesh,
                           public_key, slice_batch, seq)
        finally:
            dist.destroy_process_group()

    # local resume: newest checkpoint* dir wins
    resumed = load_latest_checkpoint(tr.output_dir)
    resumed_local_step = 0
    if resumed is not None:
        step, named, meta = resumed
        state = (the_slice.adopt(state, named, step) if the_slice is not None
                 else adopt_state(state, named, step, tx))
        # carry the COLLABORATIVE counter too, so a collaboration restarted
        # from disk continues its round ids from the checkpoint
        resumed_local_step = int(meta.get("local_step", step))
        logger.info(f"resumed from local checkpoint at step {step}")

    opt = CollaborativeOptimizer(
        tx,
        dht,
        prefix=args.dht.experiment_prefix,
        target_batch_size=args.optimizer.target_batch_size,
        batch_size_per_step=slice_batch * tr.gradient_accumulation_steps,
        batch_size_lead=args.optimizer.batch_size_lead,
        bandwidth=args.averager.bandwidth,
        compression=args.averager.compression,
        chunk_size=args.averager.chunk_size,
        topology_plan=args.averager.topology_plan or None,
        plan_follow=(
            args.averager.plan_follow and not args.averager.topology_plan
        ),
        plan_refresh_period=args.averager.plan_refresh_period,
        error_feedback=args.optimizer.error_feedback,
        overlap_averaging=args.optimizer.overlap_averaging,
        ledger_claims=args.optimizer.ledger_claims,
        claim_period=args.optimizer.claim_period,
        ledger_receipts=args.averager.ledger_receipts,
        target_group_size=args.averager.target_group_size,
        averaging_expiration=args.averager.averaging_expiration,
        averaging_timeout=args.averager.averaging_timeout,
        metadata_expiration=args.averager.metadata_expiration,
        statistics_expiration=args.optimizer.statistics_expiration,
        contrib_clip_per_sample=args.optimizer.contrib_clip_per_sample,
        ramp_rounds=args.optimizer.ramp_rounds,
        health_gate_loss_ratio=args.optimizer.health_gate_loss_ratio,
        state_sync_retries=args.averager.state_sync_retries,
        state_sync_backoff=args.averager.state_sync_backoff,
        # device-flat boundary + flat apply (--optimizer.device_flat /
        # --optimizer.flat_apply)
        device_flat=args.optimizer.device_flat,
        flat_opt_factory=(
            build_flat_opt_factory(args)
            if args.optimizer.flat_apply else None
        ),
        **checkpoint_kwargs(args, public_key),
        min_refresh_period=args.averager.min_refresh_period,
        max_refresh_period=args.averager.max_refresh_period,
        default_refresh_period=args.averager.default_refresh_period,
        expected_drift_peers=args.averager.expected_drift_peers,
        expected_drift_rate=args.averager.expected_drift_rate,
        performance_ema_alpha=args.averager.performance_ema_alpha,
        client_mode=args.dht.client_mode,
        relay=args.dht.relay or None,
        listen_port=args.averager.listen_port,
        advertised_host=args.dht.advertised_host or None,
        allow_state_sharing=args.optimizer.allow_state_sharing,
        mesh=mesh,
        opt_state_sharding=opt_sharding,
        param_sharding=param_sharding,
        authorizer=authorizer,
        authority_public_key=authority_public_key,
        verbose=True,
    )
    # catch up with the collaboration before training; only_if_newer only
    # when a checkpoint was restored, so cold-start replicas begin identical
    opt.local_step = max(opt.local_step, resumed_local_step)
    state = opt.load_state_from_peers(
        state, only_if_newer=resumed_local_step > 0
    )
    # share a pre-training snapshot: partners that miss the first rounds
    # must find a state provider immediately
    opt.seed_state_sharing(state)
    if the_slice is not None:
        the_slice.end(False, False, opt.local_step)

    accumulate = make_accumulate_step(build_loss_fn(model))
    grad_acc = zeros_like_grads(state.params)
    n_acc = 0
    batches = _make_batches(args, cfg, public_key, slice_batch)

    # the running loss stays ON DEVICE (a lazy sum); the host reads one
    # scalar per GLOBAL step, where the value is published
    loss_sum_dev = torch.zeros([], device=device)
    mini_steps = 0
    boundary = 0
    last_saved_step = opt.local_step
    perf = PerfStats()
    recorder = StepRecorder(
        telemetry=tele,
        model_tflops_per_sample=albert_tflops_per_sample(
            cfg, seq, max_predictions_for(seq)
        ),
        peak_tflops=chip_peak_tflops() if device.type == "cuda" else 0.0,
    )
    train_log = (
        open(tr.train_log_path, "a", buffering=1)
        if tr.train_log_path
        else None
    )
    wall_start = time.perf_counter()
    try:
        while True:
            # one accumulation boundary = gradient_accumulation_steps
            # micro-batches, ONE step record (data_wait/fwd_bwd here,
            # grad_flatten/avg_wire/opt_apply/collab inside opt.step)
            boundary_start = time.perf_counter()
            data_wait = 0.0
            samples = slice_batch * tr.gradient_accumulation_steps
            with recorder.step(step=opt.local_step, samples=samples) as srec:
                for _ in range(tr.gradient_accumulation_steps):
                    t0 = time.perf_counter()
                    with steps.phase("data_wait"):
                        batch = _local_batch(next(batches), mesh, device, seq)
                    data_wait += time.perf_counter() - t0
                    with steps.phase("fwd_bwd"):
                        grad_acc, n_acc, metrics = accumulate(
                            state.params, grad_acc, n_acc, batch
                        )
                    loss_sum_dev = loss_sum_dev + metrics["loss"]
                    mini_steps += 1
                if srec is not None:
                    # recording only: wait for the kernels so fwd_bwd
                    # measures execution, not launches
                    with steps.phase("fwd_bwd", block_on=grad_acc):
                        pass
                perf.metric("data_wait").update(data_wait)
                t0 = time.perf_counter()
                state, grad_acc, n_acc, stepped = opt.step(
                    state, grad_acc, n_acc, samples
                )
                if srec is not None:
                    srec.attrs["stepped"] = stepped
                perf.metric(
                    "allreduce" if stepped else "collab_report"
                ).update(time.perf_counter() - t0)
                perf.metric("boundary").update(
                    time.perf_counter() - boundary_start
                )
            if stepped:
                loss_sum = float(loss_sum_dev)  # the one sync per global step
                loss_sum_dev = torch.zeros([], device=device)
                opt.report_loss(loss_sum / max(mini_steps, 1))
                sps = float(opt.performance_ema.samples_per_second)
                publish_metrics(
                    dht,
                    args.dht.experiment_prefix,
                    public_key,
                    LocalMetrics(
                        step=opt.local_step,
                        samples_per_second=sps,
                        samples_accumulated=samples,
                        loss=loss_sum,
                        mini_steps=mini_steps,
                        step_time_ms=perf.metric("boundary").recent_mean * 1e3,
                        data_wait_ms=perf.metric("data_wait").recent_mean * 1e3,
                        allreduce_ms=perf.metric("allreduce").recent_mean * 1e3,
                        hbm_bytes=_hbm_bytes_in_use(device),
                        telemetry=(
                            tele.maybe_snapshot(args.telemetry.snapshot_period)
                            if tele is not None
                            else None
                        ),
                        endpoint=(
                            endpoint_key(opt.averager.endpoint)
                            if tele is not None
                            and opt.averager.endpoint is not None
                            else None
                        ),
                    ),
                    expiration=args.optimizer.statistics_expiration,
                )
                logger.info(
                    f"global step {opt.local_step}: loss "
                    f"{loss_sum / max(mini_steps, 1):.4f}"
                )
                if train_log is not None:
                    train_log.write(json.dumps(_log_record(
                        opt, perf, loss_sum / max(mini_steps, 1), sps,
                        samples, time.perf_counter() - wall_start, device,
                        boundary + 1,
                    )) + "\n")
                if (
                    tr.log_perf_steps
                    and opt.local_step % tr.log_perf_steps == 0
                ):
                    logger.info("perf phases:\n" + perf.report_str())
                mini_steps = 0
                if (
                    tr.save_steps
                    and opt.local_step - last_saved_step >= tr.save_steps
                ):
                    # cadence by DISTANCE: a collaborative local_step can
                    # jump over exact multiples
                    _save(args, state, opt.local_step, tx, the_slice)
                    last_saved_step = opt.local_step

            boundary += 1
            if tr.max_local_steps and boundary >= tr.max_local_steps:
                logger.info(f"reached max_local_steps={boundary}; stopping")
                break
    finally:
        if train_log is not None:
            train_log.close()
        tele_close()
        opt.shutdown()
        dht.shutdown()
        if mesh is not None:
            dist.destroy_process_group()
    return state


def _shard_state(state: TrainState, mesh, tx, zero: bool):
    """The parameter specs of the mesh's TP/EP rules, the moment specs
    (those rules, plus ZeRO-1 over the data axis with ``zero``) and the
    state with its moments cut to this rank's blocks."""
    from dedloc_tpu_torch.parallel.sharding import partition_specs, rules_for
    from dedloc_tpu_torch.parallel.zero import opt_state_shardings, shard_opt_state

    rules = rules_for(mesh)
    param_sharding = partition_specs(state.params, rules) if rules else None
    opt_sharding = None
    if zero or param_sharding is not None:
        full = Slice(mesh, tx, param_sharding).full_like(state.params)
        opt_sharding = opt_state_shardings(
            state.opt_state, mesh, axis="data" if zero else None,
            tp_rules=rules or None,
            full_shapes={n: t.shape for n, t in full.items()})
        state.opt_state = shard_opt_state(state.opt_state, mesh,
                                          shardings=opt_sharding,
                                          param_specs=param_sharding or {})
    split = lambda specs: sorted({a for s in (specs or {}).values()
                                  for a in s if a is not None})
    logger.info(
        f"slice layout: {sum(any(s) for s in (param_sharding or {}).values())} "
        f"parameter leaves split over {split(param_sharding)}, "
        f"{sum(any(s) for s in (opt_sharding.mu if opt_sharding else {}).values())}"
        f" moment leaves over {split(opt_sharding.mu if opt_sharding else None)}")
    return state, param_sharding, opt_sharding


def _local_batch(host, mesh, device, seq: int):
    """This rank's part of the slice's host batch, on its device."""
    if mesh is None:
        return drop_collator_keys(host, device=device)
    return put_batch({k: host[k] for k in loss_keys(host)}, mesh,
                     seq_axis="seq" if "seq" in mesh.shape else None,
                     seq_length=seq)


def _follow(args, cfg, model, state: TrainState, the_slice, apply_fn, mesh,
            public_key: bytes, slice_batch: int, seq: int) -> TrainState:
    """A slice rank other than 0: the same micro-batches (its part of them)
    into its own accumulator, and each boundary as rank 0 leads it."""
    tr = args.training
    state, _acc, _n, _stepped, local_step = the_slice.follow(state, None, 0)
    accumulate = make_accumulate_step(build_loss_fn(model))
    grad_acc, n_acc = zeros_like_grads(state.params), 0
    batches = _make_batches(args, cfg, public_key, slice_batch)
    last_saved_step, boundary = local_step, 0
    while True:
        for _ in range(tr.gradient_accumulation_steps):
            batch = _local_batch(next(batches), mesh, mesh.device, seq)
            grad_acc, n_acc, _metrics = accumulate(state.params, grad_acc,
                                                   n_acc, batch)
        state, grad_acc, n_acc, stepped, local_step = the_slice.follow(
            state, grad_acc, n_acc, apply_fn)
        if (stepped and tr.save_steps
                and local_step - last_saved_step >= tr.save_steps):
            _save(args, state, local_step, None, the_slice)
            last_saved_step = local_step
        boundary += 1
        if tr.max_local_steps and boundary >= tr.max_local_steps:
            return state


def _log_record(opt, perf, loss, sps, samples, wall_s, device,
                boundaries: int) -> dict:
    """One train-log line: the JAX package's fields, plus which apply the
    step took, its group size, the boundaries run so far, each kernel
    wrapper's launches so far in this process and, on the card, the peak
    memory."""
    record = {
        "wall_s": wall_s,
        "step": opt.local_step,
        "loss": loss,
        "samples_per_second": sps,
        "samples": samples,
        "boundary_ms": perf.metric("boundary").recent_mean * 1e3,
        "data_wait_ms": perf.metric("data_wait").recent_mean * 1e3,
        "allreduce_ms": perf.metric("allreduce").recent_mean * 1e3,
        # the device↔host seam: grads copy / apply / async backup;
        # list() snapshots atomically — the backup thread may insert
        "seam_ms": {k: round(v, 2) for k, v in list(opt.seam_ms.items())},
        "apply": opt.last_apply,
        "group_size": opt.last_group_size,
        "boundaries": boundaries,
        "kernel_launches": {w.__name__: w.launches for w in
                            flash_attention.WRAPPERS + fused_ln.WRAPPERS},
    }
    if device.type == "cuda":
        record["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    return record


def _hbm_bytes_in_use(device: torch.device) -> Optional[int]:
    """Device bytes in use on the card (None on the CPU)."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.memory_allocated(device)) or None


def _save(args: CollaborationArguments, state: TrainState, step: int, tx,
          the_slice=None) -> None:
    """Write the state under the single-device names; on a slice every rank
    takes part in gathering it and rank 0 writes the full tensors."""
    views = (the_slice.state_views(state) if the_slice is not None
             else _state_views(state, tx))
    if the_slice is not None and not the_slice.leader:
        return
    named = {k: v.detach().cpu().numpy().copy() for k, v in views.items()}
    save_checkpoint(
        args.training.output_dir,
        step,
        named,
        metadata={"step": int(state.step), "local_step": step},
        save_total_limit=args.training.save_total_limit,
    )


def _make_batches(args: CollaborationArguments, cfg, public_key: bytes,
                  slice_batch: Optional[int] = None):
    """Synthetic fixture by default; a tokenized-on-disk dataset when
    ``dataset_path`` is set (tokenize_wikitext103 output layout); a streamed
    text mix when ``streaming_files`` is. Seeded per peer (independent
    shuffling); numpy batches, the JAX trainer's for the same inputs."""
    seed = peer_shuffle_seed(public_key)  # per-peer independent shuffling
    batch_size = slice_batch or args.training.per_device_batch_size
    if args.training.streaming_files:
        # sahajbert-style streaming mode (dataset_streaming.py capability):
        # weighted lazy mix + per-peer shuffle buffer + on-the-fly tokenize
        from dedloc_tpu_torch.data.mlm import SpecialTokens
        from dedloc_tpu_torch.data.streaming import (
            make_text_source,
            prefetch,
            split_sentences,
            streaming_mlm_batches,
        )
        from dedloc_tpu_torch.data.tokenizer import load_fast_tokenizer

        tok = load_fast_tokenizer(args.training.tokenizer_path)
        if tok.vocab_size > cfg.vocab_size:
            # fail fast: ids past the embedding table would index out of
            # range in the embedding lookup
            raise ValueError(
                f"tokenizer vocab ({tok.vocab_size}) exceeds the model's "
                f"vocab_size ({cfg.vocab_size}); retrain the tokenizer or "
                "use a larger model vocab"
            )
        tokens = SpecialTokens(
            cls_id=tok.cls_id, sep_id=tok.sep_id, pad_id=tok.pad_id,
            mask_id=tok.mask_id, vocab_size=tok.vocab_size,
        )
        weights = args.training.streaming_weights or (
            [1.0] * len(args.training.streaming_files)
        )
        seq = min(args.training.seq_length, cfg.max_position_embeddings)
        # http(s):// specs stream remotely with retry/resume; the bounded
        # prefetch overlaps network/tokenization with the training step
        return prefetch(streaming_mlm_batches(
            [make_text_source(p) for p in args.training.streaming_files],
            weights,
            lambda doc: [
                tok.encode_ids(s, add_special_tokens=False)
                for s in split_sentences(doc)
            ],
            tokens,
            batch_size,
            seq,
            seed,
            buffer_size=args.training.streaming_buffer_size,
            max_predictions=max_predictions_for(seq),
        ), size=8)
    if not args.training.dataset_path:
        return synthetic_mlm_batches(
            cfg, batch_size, args.training.seq_length, seed
        )
    from dedloc_tpu_torch.data.disk import tokenized_dataset_batches

    return tokenized_dataset_batches(
        args.training.dataset_path, cfg, batch_size,
        args.training.seq_length, seed,
    )


def main(argv=None) -> None:
    run_trainer(parse_config(CollaborationArguments, argv))


if __name__ == "__main__":
    main()
