"""The SwAV cell: one collaborative SwAV peer's local step, as a peer
alone at its step takes it (``roles/swav.py``, the solo branch of
``collaborative/optimizer.py``).

A step: the crops moved to the device through ``models/swav.py``
``crop_tensors``, ``make_swav_accumulate_step`` with the queue in use (the
steady state of a long run: past the prototype freeze, the queue engaged
from the first step); then the boundary: the accumulator mean with the
SwAV defaults' contribution clip (``_fused_mean_clip``), the flat LARS
apply (``make_flat_apply_step`` over the ``FlatLars`` of
``roles/swav.py``'s factory) with ``make_prototype_post_apply``, and a
fresh accumulator.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.counts.flops import swav_flops_per_sample
from portbench.drivers.common import OFF, changes, to_host, traffic_pool
from portbench.reference import init, optim, train
from portbench.reference import swav as ref_swav

QUEUE_STREAM = 1  # the queue's draw, apart from the weights'


def initial_state(ctx):
    """(running statistics, queue) a run starts from: mean 0 and variance 1
    for every batch norm; the queue uniform in +-1/sqrt(D/3), drawn from
    the seed on the device."""
    c = ctx.config
    stats = {}
    for name, n in ref_swav.batch_norms(c):
        stats[name + ".mean"] = torch.zeros(n, device=ctx.device)
        stats[name + ".var"] = torch.ones(n, device=ctx.device)
    d = c["proj_dims"][-1]
    stdv = 1.0 / np.sqrt(d / 3.0)
    g = init.generator(ctx.seed, ctx.device, QUEUE_STREAM)
    queue = (torch.rand((len(c["crops_for_assign"]), c["queue_length"], d),
                        generator=g, device=ctx.device) * (2 * stdv) - stdv)
    return stats, queue


class Program:
    def __init__(self, ctx):
        from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline
        from dedloc_tpu_torch.collaborative.optimizer import _fused_mean_clip
        from dedloc_tpu_torch.core.config import SwAVTrainingArguments
        from dedloc_tpu_torch.models.resnet import ResNetConfig
        from dedloc_tpu_torch.models.swav import (
            SwAVConfig, SwAVModel, SwAVQueue, crop_tensors,
            make_prototype_post_apply, make_swav_accumulate_step)
        from dedloc_tpu_torch.optim.lars import Lars
        from dedloc_tpu_torch.optim.schedules import linear_warmup_cosine_annealing
        from dedloc_tpu_torch.parallel.train_step import (
            TrainState, make_flat_apply_step, zeros_like_grads)
        from dedloc_tpu_torch.roles.swav import _build_flat_lars_factory

        c, t, o = ctx.config, ctx.traffic, ctx.config["optimizer"]
        # the trunk's convolutions as the configuration states them; a
        # witness (``check.py --program``) may ask for another dtype
        trunk_dtype = getattr(torch, ctx.cell["program"].get("trunk_dtype", "bfloat16"))
        self.device = torch.device(ctx.device)
        b = t["micro_batch"]
        self.accum = t["accumulation"]
        self.samples_per_step = b * self.accum
        self.flops_per_step = self.samples_per_step * swav_flops_per_sample(
            c["crop_sizes"], c["crop_counts"], c["stage_sizes"], c["width"],
            c["proj_dims"], sum(c["num_prototypes"]), c["queue_length"],
            len(c["crops_for_assign"]), b)
        self.kernel_shapes = {}
        cfg = SwAVConfig(
            trunk=ResNetConfig(stage_sizes=tuple(c["stage_sizes"]), width=c["width"],
                               dtype=trunk_dtype,
                               bn_momentum=c["bn_momentum"], bn_eps=c["bn_eps"]),
            proj_dims=tuple(c["proj_dims"]), num_prototypes=tuple(c["num_prototypes"]),
            temperature=c["temperature"], epsilon=c["epsilon"],
            sinkhorn_iters=c["sinkhorn_iters"], num_crops=c["num_crops"],
            crops_for_assign=tuple(c["crops_for_assign"]),
            queue_length=c["queue_length"], queue_start_step=0,
            freeze_prototypes_steps=c["freeze_prototypes_steps"])
        with torch.device("meta"):
            model = SwAVModel(cfg)
        model = model.to_empty(device=self.device)
        self.weights0 = init.draw(ref_swav.spec(c), ctx.seed, self.device)
        params = dict(model.named_parameters())
        if set(params) != set(self.weights0) or any(
                params[n].shape != w.shape for n, w in self.weights0.items()):
            raise ValueError("the program's parameters are not the reference's")
        with torch.no_grad():
            for n, w in self.weights0.items():
                params[n].copy_(w)
        stats, queue = initial_state(ctx)
        self.stats0 = {k: v.clone() for k, v in stats.items()}
        self.batch_stats = stats
        self.queue = SwAVQueue(embeddings=queue)
        args = SwAVTrainingArguments(
            learning_rate=o["learning_rate"], momentum=o["momentum"],
            weight_decay=o["weight_decay"], trust_coefficient=o["trust_coefficient"],
            warmup_steps=o["warmup_steps"], total_steps=o["total_steps"])
        tx = Lars(learning_rate=linear_warmup_cosine_annealing(
            args.learning_rate, args.warmup_steps, args.total_steps),
            momentum=args.momentum, weight_decay=args.weight_decay,
            trust_coefficient=args.trust_coefficient)
        state = TrainState.create(params, tx)
        start = o["schedule_start"]
        state.step = start
        state.opt_state = state.opt_state._replace(schedule_count=start)
        self.state = state
        self.global_step = start
        self.accumulate = make_swav_accumulate_step(model, cfg)
        self.zeros = zeros_like_grads
        self.acc = zeros_like_grads(params)
        spec = DeviceFlatPipeline.for_tree(self.acc).spec
        self.apply = make_flat_apply_step(_build_flat_lars_factory(args)(spec, params),
                                          spec, post_apply=make_prototype_post_apply(),
                                          from_tree=True)
        self.mean_clip = _fused_mean_clip
        # the contribution cap scales with the samples of a micro-batch
        self.cap = o["contrib_clip_per_sample"] * b
        self.move = crop_tensors
        self.pool = traffic_pool(ctx)
        self.cursor = 0

    def step(self, spans=OFF, probe=None):
        acc, n, losses = self.acc, 0, []
        for _ in range(self.accum):
            host = self.pool[self.cursor % len(self.pool)]
            self.cursor += 1
            with spans.data():
                crops = self.move(host, self.device)
            with spans.compute():
                acc, n, self.batch_stats, self.queue, metrics = self.accumulate(
                    self.state.params, self.batch_stats, self.queue, acc, n, crops,
                    self.global_step, True)
            losses.append(metrics["loss"])
        with spans.boundary():
            if probe is not None:
                probe["sums"] = to_host(acc)
            mean = self.mean_clip(acc, max(n, 1), self.cap)
            if probe is not None:
                probe["grads"] = to_host(mean)
            self.state, ok = self.apply(self.state, mean)
            self.acc = self.zeros(self.state.params)
        self.global_step += 1
        loss = torch.stack(losses).mean()
        return loss, ok

    def changes(self) -> Dict[str, torch.Tensor]:
        out = changes(self.state.params, self.weights0)
        out.update(changes(self.batch_stats, self.stats0))
        return out

    def close(self):
        self.__dict__.clear()


def build(ctx) -> Program:
    return Program(ctx)


def reference(ctx, steps: int, dtype=torch.float32, half: bool = False,
              flip: bool = False) -> dict:
    """The plain reference over the program's first ``steps`` steps; with
    ``half``, the second half of each step's images left out; with
    ``flip``, each update added with the wrong sign."""
    c, t, o = ctx.config, ctx.traffic, ctx.config["optimizer"]
    batches = traffic_pool(ctx)
    per_step = []
    for i in range(steps):
        micro = []
        for j in range(t["accumulation"]):
            groups = batches[(i * t["accumulation"] + j) % len(batches)]
            if half:
                groups = [_first_images(g, t["micro_batch"]) for g in groups]
            micro.append([torch.as_tensor(g).to(ctx.device) for g in groups])
        per_step.append(micro)
    del batches
    weights = init.draw(ref_swav.spec(c), ctx.seed, ctx.device)
    stats, queue = initial_state(ctx)
    model = ref_swav.Model(c, {k: v.to(dtype) for k, v in stats.items()},
                           queue.to(dtype))
    rows = t["micro_batch"] // 2 if half else t["micro_batch"]
    protos = [f"head.prototypes{h}.weight" for h in range(len(c["num_prototypes"]))]
    return train.follow(weights, model, per_step, optim.Lars(o, flip=flip),
                        o["contrib_clip_per_sample"] * rows, o["schedule_start"],
                        dtype, rows_of_prototypes=protos,
                        state_change=model.state_change)


def _first_images(group: np.ndarray, batch: int) -> np.ndarray:
    """The first half of the images of a crop-major group, every crop."""
    g = group.reshape(group.shape[0] // batch, batch, *group.shape[1:])
    return np.ascontiguousarray(g[:, :batch // 2]).reshape(-1, *group.shape[1:])
