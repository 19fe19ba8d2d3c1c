"""ALBERT cells: one collaborative trainer peer's local step, as a peer
alone at its step takes it (``roles/trainer.py``, the solo branch of
``collaborative/optimizer.py``).

A step: ``gradient_accumulation`` micro-batches, each moved to the device
as the trainer moves it (``roles/common.py`` ``drop_collator_keys``) and
through ``make_accumulate_step(build_loss_fn(model))``; then the boundary:
the accumulator mean with the contribution clip (``_fused_mean_clip``),
the fused flat LAMB apply (``make_flat_apply_step`` over the
``FlatLamb`` that ``build_flat_opt_factory`` builds, the default
``--optimizer.flat_apply``) and a fresh accumulator.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench.drivers.common import OFF, changes, to_host, traffic_pool
from portbench.reference import albert as ref_albert
from portbench.reference import init, optim, train
from portbench.traffic.mlm import max_predictions_for
from portbench.counts.flops import albert_tflops_per_sample


def model_keys(config: dict) -> dict:
    keys = ("vocab_size", "embedding_size", "hidden_size", "num_hidden_layers",
            "num_attention_heads", "intermediate_size", "max_position_embeddings",
            "type_vocab_size", "layer_norm_eps", "initializer_range")
    return {k: config[k] for k in keys}


def _on_device(host: dict, device, keys) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(host[k]).to(device) for k in keys}


LOSS_KEYS = ("input_ids", "attention_mask", "token_type_ids", "mlm_positions",
             "mlm_label_ids", "mlm_weights", "sop_labels")


class Program:
    def __init__(self, ctx):
        from dedloc_tpu_torch.collaborative.optimizer import _fused_mean_clip
        from dedloc_tpu_torch.core.config import TrainingArguments
        from dedloc_tpu_torch.models.albert import (
            AlbertConfig, AlbertForPreTraining, fused_ln_for_policy)
        from dedloc_tpu_torch.parallel.train_step import (
            TrainState, make_accumulate_step, make_flat_apply_step, zeros_like_grads)
        from dedloc_tpu_torch.roles.common import (
            build_flat_opt_factory, build_loss_fn, build_optimizer, drop_collator_keys)
        from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline

        c, t, p, o = ctx.config, ctx.traffic, ctx.cell["program"], ctx.config["optimizer"]
        self.device = torch.device(ctx.device)
        self.accum = t["accumulation"]
        self.samples_per_step = t["micro_batch"] * self.accum
        seq = t["seq_length"]
        self.flops_per_step = 1e12 * self.samples_per_step * albert_tflops_per_sample(
            c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"],
            c["embedding_size"], c["vocab_size"], seq, max_predictions_for(seq))
        heads = c["num_attention_heads"]
        self.kernel_shapes = {
            "flash": (t["micro_batch"], seq, heads, c["hidden_size"] // heads),
            "ln": (t["micro_batch"] * seq, c["hidden_size"])}
        cfg = AlbertConfig(**model_keys(c), hidden_dropout_prob=0.0,
                           attention_dropout_prob=0.0,
                           remat_policy=p["remat_policy"],
                           fused_ln=fused_ln_for_policy(p["remat_policy"]),
                           attention_impl=p["attention_impl"])
        with torch.device("meta"):
            model = AlbertForPreTraining(cfg)
        model = model.to_empty(device=self.device)
        self.weights0 = init.draw(ref_albert.spec(c), ctx.seed, self.device)
        params = dict(model.named_parameters())
        if set(params) != set(self.weights0) or any(
                params[n].shape != w.shape for n, w in self.weights0.items()):
            raise ValueError("the program's parameters are not the reference's")
        with torch.no_grad():
            for n, w in self.weights0.items():
                params[n].copy_(w)
        args = TrainingArguments(
            learning_rate=o["learning_rate"], warmup_steps=o["warmup_steps"],
            total_steps=o["total_steps"], weight_decay=o["weight_decay"],
            max_grad_norm=o["max_grad_norm"], clamp_value=o["clamp_value"])
        tx = build_optimizer(args)
        state = TrainState.create(params, tx)
        # a peer at global step ``schedule_start``: the schedule there, fresh
        # moments
        start = o["schedule_start"]
        state.step = start
        state.opt_state = state.opt_state._replace(schedule_count=start)
        self.state = state
        self.accumulate = make_accumulate_step(build_loss_fn(model))
        self.zeros = zeros_like_grads
        self.acc = zeros_like_grads(params)
        spec = DeviceFlatPipeline.for_tree(self.acc).spec
        self.apply = make_flat_apply_step(build_flat_opt_factory(args)(spec, params),
                                          spec, from_tree=True)
        self.mean_clip = _fused_mean_clip
        self.cap = o["contrib_clip_per_sample"] * t["micro_batch"]
        self.move = drop_collator_keys
        self.pool = traffic_pool(ctx)
        self.cursor = 0

    def step(self, spans=OFF, probe=None):
        """One optimizer step; returns (loss, apply ok) on the device."""
        acc, n, losses = self.acc, 0, []
        for _ in range(self.accum):
            host = self.pool[self.cursor % len(self.pool)]
            self.cursor += 1
            with spans.data():
                batch = self.move(host, device=self.device)
            with spans.compute():
                acc, n, metrics = self.accumulate(self.state.params, acc, n, batch)
            losses.append(metrics["loss"])
        with spans.boundary():
            if probe is not None:
                probe["sums"] = to_host(acc)
            mean = self.mean_clip(acc, max(n, 1), self.cap)
            if probe is not None:
                probe["grads"] = to_host(mean)
            self.state, ok = self.apply(self.state, mean)
            self.acc = self.zeros(self.state.params)
        return torch.stack(losses).mean(), ok

    def changes(self) -> Dict[str, torch.Tensor]:
        return changes(self.state.params, self.weights0)

    def close(self):
        self.__dict__.clear()


def build(ctx) -> Program:
    return Program(ctx)


def reference(ctx, steps: int, dtype=torch.float32, half: bool = False,
              flip: bool = False) -> dict:
    """The plain reference over the program's first ``steps`` steps; with
    ``half``, each step's second half of samples left out (the mean taken
    over the rest: the half-batch fault in the program's place); with
    ``flip``, each update added with the wrong sign (a wrong update in the
    program's place)."""
    c, t, o = ctx.config, ctx.traffic, ctx.config["optimizer"]
    micro = [_on_device(b, ctx.device, LOSS_KEYS) for b in traffic_pool(ctx)]
    per_step = [micro[i * t["accumulation"]:(i + 1) * t["accumulation"]]
                for i in range(steps)]
    if half:
        per_step = [_halved(s) for s in per_step]
    weights = init.draw(ref_albert.spec(c), ctx.seed, ctx.device)

    class Model:
        @staticmethod
        def loss(P, batch, _step):
            return ref_albert.loss(P, batch, c), lambda: None

    lamb = optim.Lamb(o, ref_albert.weight_decay_mask(weights), flip=flip)
    return train.follow(weights, Model, per_step, lamb,
                        o["contrib_clip_per_sample"] * t["micro_batch"],
                        o["schedule_start"], dtype)


def _halved(micro_batches: list) -> list:
    """Half of a step's samples: the first half of each micro-batch's rows,
    or, with one row a micro-batch, the first half of the micro-batches."""
    rows = micro_batches[0]["input_ids"].shape[0]
    if rows >= 2:
        return [{k: v[:rows // 2] for k, v in m.items()} for m in micro_batches]
    return micro_batches[:max(1, len(micro_batches) // 2)]
