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
tokenized text mix (``--training.streaming_files``). One device per peer:
``mesh_*_devices > 1``, MoE, ZeRO and ring attention come with the
parallel-axes slice and raise ``ValueError`` naming it.

    python -m dedloc_tpu_torch.roles.trainer --dht.experiment_prefix run \\
        --optimizer.target_batch_size 48 --training.per_device_batch_size 12
"""
from __future__ import annotations

import json
import time
from typing import Optional

import torch

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
from dedloc_tpu_torch.parallel.train_step import (
    TrainState,
    make_accumulate_step,
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


def _refuse_later_slices(args: CollaborationArguments) -> None:
    tr = args.training
    if (tr.mesh_devices > 1 or tr.mesh_seq_devices > 1
            or tr.mesh_model_devices > 1 or tr.mesh_pipe_devices > 1
            or tr.mesh_expert_devices > 1 or tr.zero_sharding
            or tr.moe_experts or tr.attention_impl == "ring"):
        raise ValueError(
            "the port's trainer runs on one device: mesh_*_devices, "
            "zero_sharding, moe_experts and attention_impl='ring' come with "
            "the parallel-axes slice (ROADMAP, queue A)")


def run_trainer(args: CollaborationArguments) -> TrainState:
    device = force_cpu_if_requested()
    _refuse_later_slices(args)
    # gated runs: token handshake BEFORE any heavy setup, so bad credentials
    # fail in milliseconds
    authorizer, authority_public_key = build_authorizer(args)
    tr = args.training
    cfg, model = build_model(tr.model_size, tr.remat_policy, tr.attention_impl,
                             tr.vocab_size, device=device, seed=tr.seed)
    tx = build_optimizer(args)
    dht, public_key = build_dht(
        args,
        private_key=(
            authorizer.local_private_key if authorizer is not None else None
        ),
    )
    logger.info(f"trainer DHT listening on {dht.port}")
    tele, tele_close = configure_role_telemetry(args, public_key)

    seq = min(tr.seq_length, cfg.max_position_embeddings)
    slice_batch = tr.per_device_batch_size
    state = TrainState.create(dict(model.named_parameters()), tx)

    # local resume: newest checkpoint* dir wins
    resumed = load_latest_checkpoint(tr.output_dir)
    resumed_local_step = 0
    if resumed is not None:
        step, named, meta = resumed
        state = adopt_state(state, named, step, tx)
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
                        batch = drop_collator_keys(next(batches), device=device)
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
                    _save(args, state, opt.local_step, tx)
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


def _save(args: CollaborationArguments, state: TrainState, step: int, tx) -> None:
    named = {k: v.detach().cpu().numpy().copy()
             for k, v in _state_views(state, tx).items()}
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
