"""SwAV collaborative trainer peer, on the card.

Port of ``dedloc_tpu/roles/swav.py``: build the ResNet-50 trunk and
prototypes head, LARC-SGD with a warmup-cosine schedule, the DHT and the
CollaborativeOptimizer (target batch 32,768), the multicrop pipeline, and
run the phase-loop ``Trainer`` with the default hooks. The GLOBAL
collaboration step gates the queue and the prototype freeze.

It runs on the card unless ``DEDLOC_FORCE_CPU=1`` asks for the CPU. The
batches are the JAX peer's for the same seed (synthetic or an image
folder); the checkpoint is ``(params, batch_stats)`` under the JAX names
(``_tree_to_named``), so either package resumes from the other's. One
device per peer: ``--training.mesh_devices > 1`` (and the sinkhorn's
all-reduce across devices) comes with the parallel-axes slice.

    python -m dedloc_tpu_torch.roles.swav --dht.experiment_prefix run \\
        --training.per_device_batch_size 32 --optimizer.target_batch_size 64
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping

import numpy as np
import torch

from dedloc_tpu_torch.collaborative.metrics import LocalMetrics, publish_metrics
from dedloc_tpu_torch.collaborative.optimizer import CollaborativeOptimizer
from dedloc_tpu_torch.core.config import SwAVCollaborationArguments, parse_config
from dedloc_tpu_torch.core.hooks import default_hooks
from dedloc_tpu_torch.core.trainer import Trainer
from dedloc_tpu_torch.data.multicrop import (
    MultiCropSpec,
    image_folder_multicrop_batches,
    synthetic_multicrop_batches,
)
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models.resnet import init_batch_stats, init_weights
from dedloc_tpu_torch.models.swav import (
    SwAVConfig,
    SwAVModel,
    SwAVQueue,
    crop_tensors,
    make_prototype_post_apply,
    make_swav_accumulate_step,
)
from dedloc_tpu_torch.optim.lars import Lars
from dedloc_tpu_torch.optim.schedules import linear_warmup_cosine_annealing
from dedloc_tpu_torch.parallel.train_step import TrainState, zeros_like_grads
from dedloc_tpu_torch.roles.common import (
    build_dht,
    checkpoint_kwargs,
    configure_role_telemetry,
    force_cpu_if_requested,
)
from dedloc_tpu_torch.telemetry.links import endpoint_key
from dedloc_tpu_torch.utils.checkpoint import load_latest_checkpoint, save_checkpoint
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def build_swav(args: SwAVCollaborationArguments):
    """(cfg, spec, model, tx) for the requested model size; the model's
    weights are drawn from ``--training.seed`` on the CPU."""
    t = args.training
    if t.model_size == "tiny":
        cfg = SwAVConfig.tiny(
            queue_length=t.queue_length, queue_start_step=t.queue_start_step
        )
        spec = MultiCropSpec.tiny()
    else:
        cfg = SwAVConfig(
            queue_length=t.queue_length, queue_start_step=t.queue_start_step
        )
        spec = MultiCropSpec()
    model = init_weights(SwAVModel(cfg), torch.Generator().manual_seed(t.seed))
    schedule = linear_warmup_cosine_annealing(
        t.learning_rate, t.warmup_steps, t.total_steps
    )
    tx = Lars(
        learning_rate=schedule,
        momentum=t.momentum,
        weight_decay=t.weight_decay,
        trust_coefficient=t.trust_coefficient,
    )
    return cfg, spec, model, tx


def _build_flat_lars_factory(t):
    """(spec, params) -> ``optim.flat.FlatLars`` mirroring ``build_swav``'s
    LARS hyperparameters (the fused flat apply; --optimizer.flat_apply)."""
    schedule = linear_warmup_cosine_annealing(
        t.learning_rate, t.warmup_steps, t.total_steps
    )

    def factory(spec, params):
        from dedloc_tpu_torch.optim.flat import FlatLars

        # build_swav's Lars has no exclusions: no skipped spans
        return FlatLars(
            spec, [False] * len(spec), schedule,
            momentum=t.momentum,
            weight_decay=t.weight_decay,
            trust_coefficient=t.trust_coefficient,
        )

    return factory


def checkpoint_tree(params: Mapping[str, torch.Tensor],
                    batch_stats: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``(params, batch_stats)`` as the JAX peer names its checkpoint
    (``_tree_to_named``): ``[0]`` params, ``[1]`` running statistics, host
    arrays in the JAX layout."""
    named = {}
    for prefix, tensors in (("[0]", params), ("[1]", batch_stats)):
        for name, arr in convert.params_to_jax(tensors).items():
            named[prefix + name] = arr
    return named


def restore_checkpoint(tree: Mapping[str, np.ndarray],
                       params: Mapping[str, torch.Tensor],
                       batch_stats: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copy a checkpoint's params into ``params`` (in place) and return its
    running statistics on their device. Every name and shape is checked
    first: a mismatch raises ``KeyError``/``ValueError`` and writes
    nothing."""
    expected = checkpoint_tree(params, batch_stats)
    if set(tree) != set(expected):
        diff = sorted(set(tree) ^ set(expected))
        raise KeyError(f"checkpoint names differ: {diff[:4]}")
    for name, arr in tree.items():
        if tuple(np.shape(arr)) != expected[name].shape:
            raise ValueError(f"{name}: shape {tuple(np.shape(arr))} does not "
                             f"match the local {expected[name].shape}")
    part = lambda prefix: convert.params_from_jax(
        {k[3:]: v for k, v in tree.items() if k.startswith(prefix)})
    with torch.no_grad():
        for name, t in part("[0]").items():
            params[name].copy_(t)
    return {name: t.to(batch_stats[name].device)
            for name, t in part("[1]").items()}


def run_swav(args: SwAVCollaborationArguments) -> TrainState:
    device = force_cpu_if_requested()
    t = args.training
    if t.mesh_devices > 1:
        raise ValueError(
            "the port's SwAV peer runs on one device: mesh_devices > 1 (and "
            "the sinkhorn's all-reduce across devices) comes with the "
            "parallel-axes slice (ROADMAP, queue A)")
    cfg, spec, model, tx = build_swav(args)
    model = model.to(device)
    dht, _public_key = build_dht(args)
    logger.info(f"swav peer DHT listening on {dht.port}")
    tele, tele_close = configure_role_telemetry(args, _public_key)

    slice_batch = t.per_device_batch_size
    if slice_batch < 8:
        # sinkhorn equipartitions THIS peer's local batch over the
        # prototypes: at a handful of global-crop embeddings the transport
        # is pure noise (core/config.py contrib_clip_per_sample)
        logger.warning(
            f"per-peer batch {slice_batch} is too small for a stable "
            "sinkhorn assignment; this peer's gradients will be mostly "
            "noise (clipped by optimizer.contrib_clip_per_sample). "
            "Raise --training.per_device_batch_size (>=8) or join as an "
            "aux bandwidth donor instead."
        )

    state = TrainState.create(dict(model.named_parameters()), tx)
    batch_stats = init_batch_stats(model)
    queue = (
        SwAVQueue.create(cfg, torch.Generator().manual_seed(t.seed + 1), device)
        if cfg.queue_length
        else None
    )

    opt = CollaborativeOptimizer(
        tx,
        dht,
        prefix=args.dht.experiment_prefix,
        target_batch_size=args.optimizer.target_batch_size,
        batch_size_lead=args.optimizer.batch_size_lead,
        batch_size_per_step=slice_batch * t.gradient_accumulation_steps,
        bandwidth=args.averager.bandwidth,
        compression=args.averager.compression,
        chunk_size=args.averager.chunk_size,
        error_feedback=args.optimizer.error_feedback,
        overlap_averaging=args.optimizer.overlap_averaging,
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
        # the progress tracker's cadence (the JAX role leaves these flags
        # unread; the port's trainer and this peer honour them)
        min_refresh_period=args.averager.min_refresh_period,
        max_refresh_period=args.averager.max_refresh_period,
        default_refresh_period=args.averager.default_refresh_period,
        # device-flat boundary + fused flat LARS apply (same knobs as the
        # ALBERT trainer)
        device_flat=args.optimizer.device_flat,
        flat_opt_factory=(
            _build_flat_lars_factory(t)
            if args.optimizer.flat_apply else None
        ),
        **checkpoint_kwargs(args, _public_key),
        client_mode=args.dht.client_mode,
        relay=args.dht.relay or None,
        listen_port=args.averager.listen_port,
        advertised_host=args.dht.advertised_host or None,
        post_apply=make_prototype_post_apply(),
        verbose=True,
    )
    # disk resume: the newest checkpoint restores params + batch_stats and
    # seeds the collaborative counter; a LIVE collaboration below still
    # wins. LARC momentum is not part of the checkpoint (the reference's
    # phase resume also rebuilds the optimizer).
    resumed = load_latest_checkpoint(t.output_dir)
    if resumed is not None:
        ckpt_step, tree, meta = resumed
        try:
            batch_stats = restore_checkpoint(tree, state.params, batch_stats)
            state = TrainState(step=ckpt_step, params=state.params,
                               opt_state=state.opt_state)
            opt.local_step = int(meta.get("local_step", ckpt_step))
            logger.info(f"resumed from local checkpoint at step {ckpt_step}")
        except (KeyError, ValueError) as e:
            logger.warning(f"checkpoint incompatible ({e!r}); starting fresh")
            resumed = None  # genuinely fresh: keep cold-start adoption below
    # a DEEPER live collaboration wins over the disk checkpoint; cold starts
    # keep the unconditional adopt so fresh replicas begin identical
    state = opt.load_state_from_peers(
        state, only_if_newer=resumed is not None
    )
    # share a pre-training snapshot: partners that start while this peer
    # builds must find a provider
    opt.seed_state_sharing(state)

    accumulate = make_swav_accumulate_step(model, cfg)
    if t.image_folder:
        batches = image_folder_multicrop_batches(
            t.image_folder, spec, slice_batch, seed=t.seed
        )
    else:
        batches = synthetic_multicrop_batches(spec, slice_batch, seed=t.seed)
    samples = slice_batch * t.gradient_accumulation_steps

    # mutable local (non-collaborative) state, closed over by the step fn
    local = {"batch_stats": batch_stats, "queue": queue,
             "grad_acc": zeros_like_grads(state.params), "n_acc": 0}

    def step_fn(state, micro_batches: List[List[np.ndarray]]):
        # one trainer step = one accumulation boundary
        loss = None
        for crops in micro_batches:
            use_queue = bool(
                cfg.queue_length and opt.local_step >= cfg.queue_start_step
            )
            if use_queue and not local.get("queue_engaged"):
                local["queue_engaged"] = True
                logger.info(
                    f"queue engaged at global step {opt.local_step} "
                    f"(queue_start_step={cfg.queue_start_step}, "
                    f"length={cfg.queue_length})"
                )
                if cfg.queue_start_step < 2 * t.warmup_steps:
                    logger.warning(
                        "queue engaged before the trunk is trained "
                        f"(start {cfg.queue_start_step} < 2x warmup "
                        f"{t.warmup_steps}); stale near-random embeddings "
                        "can collapse the representation — prefer a later "
                        "--training.queue_start_step"
                    )
            local["grad_acc"], local["n_acc"], local["batch_stats"], \
                local["queue"], metrics = accumulate(
                    state.params,
                    local["batch_stats"],
                    local["queue"],
                    local["grad_acc"],
                    local["n_acc"],
                    crop_tensors(crops, device),
                    opt.local_step,
                    use_queue,
                )
            loss = metrics["loss"]
        state, local["grad_acc"], local["n_acc"], stepped = opt.step(
            state, local["grad_acc"], local["n_acc"], samples
        )
        if stepped:
            # one host read per GLOBAL step: the loss for the trunk-health
            # gate and the signed metrics bus
            loss_host = float(loss)
            opt.report_loss(loss_host)
            logger.info(
                f"global step {opt.local_step}: loss {loss_host:.4f} "
                f"(apply {opt.last_apply}, group {opt.last_group_size})"
            )
            publish_metrics(
                dht,
                args.dht.experiment_prefix,
                _public_key,
                LocalMetrics(
                    step=opt.local_step,
                    samples_per_second=float(
                        opt.performance_ema.samples_per_second
                    ),
                    samples_accumulated=samples,
                    loss=loss_host,
                    mini_steps=1,
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
        return state, {"loss": loss, "global_step": opt.local_step}

    def grouped(it: Iterator, k: int) -> Iterator[list]:
        while True:
            group = []
            for _ in range(k):
                try:
                    group.append(next(it))
                except StopIteration:
                    # PEP 479: returning ends the generator, so the Trainer
                    # stops gracefully on finite data
                    return
            yield group

    def save_fn(ctx):
        save_checkpoint(
            t.output_dir,
            opt.local_step,
            checkpoint_tree(ctx.train_state.params, local["batch_stats"]),
            metadata={"local_step": opt.local_step},
            save_total_limit=t.save_total_limit,
        )

    trainer = Trainer(
        step_fn,
        hooks=default_hooks(
            log_every=t.log_every,
            save_fn=save_fn if t.save_steps else None,
            save_every=t.save_steps,
            device_stats_every=t.device_stats_every,
        ),
    )
    try:
        state, _ctx = trainer.train(
            state,
            grouped(batches, t.gradient_accumulation_steps),
            max_steps=t.max_local_steps or 10**9,
        )
    finally:
        tele_close()
        opt.shutdown()
        dht.shutdown()
    return state


def main(argv=None) -> None:
    run_swav(parse_config(SwAVCollaborationArguments, argv))


if __name__ == "__main__":
    main()
