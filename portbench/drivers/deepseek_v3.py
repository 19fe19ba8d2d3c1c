"""DeepSeek-V3 cells (Moonlight-16B-A3B): one trainer peer's local step on
one expert-parallel rank, as a peer alone at its step takes it
(``roles/trainer.py`` with ``--training.model_size moonlight-16b-a3b``).

A step: ``gradient_accumulation`` packed micro-batches, each moved to the
device as the trainer moves it (``roles/common.py`` ``drop_collator_keys``)
and through ``make_accumulate_step(build_loss_fn(model))``; then the
boundary: the accumulator mean (``_fused_mean_clip``), the fused flat LAMB
apply (``make_flat_apply_step`` over the ``FlatLamb`` that
``build_flat_opt_factory`` builds) whose ``post_apply`` moves each
router's correction bias by the step's loads, and the accumulator zeroed.

The held experts' (token, expert) pairs of the steps taken with the spans
on (a traced run's window) are counted on the device and read after the
window (``kernel_shapes["expert_loads"]``, ``[L_moe, n]``).

The port is imported inside ``build``: a checkout without the DeepSeek-V3
model fails there at once.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench.counts.moe_lm import flops_per_token
from portbench.drivers.common import OFF, to_host, traffic_pool
from portbench.reference import deepseek_v3 as ref_ds
from portbench.reference import init, optim, train

LOSS_KEYS = ("input_ids", "labels")


def model_config(c: dict) -> dict:
    """The configuration as this card runs it: the model cut to its first
    ``layers_held`` layers (the final norm, the head and the loss on the
    last of them) and its rank's share of the experts."""
    return dict(c, num_hidden_layers=c.get("layers_held") or c["num_hidden_layers"],
                experts_held=c.get("experts_held", 0), expert_rank=c.get("expert_rank", 0))


def bias_names(c: dict) -> list:
    return [ref_ds.bias_name(i) for i in ref_ds.moe_layers(c)]


class Program:
    def __init__(self, ctx):
        from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline
        from dedloc_tpu_torch.collaborative.optimizer import _fused_mean_clip
        from dedloc_tpu_torch.core.config import TrainingArguments
        from dedloc_tpu_torch.parallel.train_step import (
            TrainState, make_accumulate_step, make_flat_apply_step, zeros_like_grads)
        from dedloc_tpu_torch.roles.common import (
            build_flat_opt_factory, build_loss_fn, build_model, build_optimizer,
            drop_collator_keys)

        c, t, o = model_config(ctx.config), ctx.traffic, ctx.config["optimizer"]
        self.device = torch.device(ctx.device)
        self.accum = t["accumulation"]
        self.samples_per_step = t["micro_batch"] * self.accum
        seq = t["seq_length"]
        self.flops_per_step = self.samples_per_step * seq * flops_per_token(c, seq)
        keys = ("vocab_size", "hidden_size", "intermediate_size", "moe_intermediate_size",
                "num_hidden_layers", "first_k_dense_replace", "num_attention_heads",
                "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
                "n_routed_experts", "num_experts_per_tok", "n_shared_experts",
                "routed_scaling_factor", "rms_norm_eps", "rope_theta",
                "max_position_embeddings", "initializer_range", "bias_update_speed",
                "aux_loss_alpha")
        cfg, model = build_model("moonlight-16b-a3b", device="meta",
                                 moe_experts_held=c["experts_held"],
                                 expert_rank=c.get("expert_rank", 0),
                                 overrides={k: c[k] for k in keys})
        model = model.to_empty(device=self.device)
        weights = init.draw(ref_ds.spec(model_config(c)), ctx.seed, self.device)
        params = dict(model.named_parameters())
        if set(params) != set(weights) or any(
                params[n].shape != w.shape for n, w in weights.items()):
            raise ValueError("the program's parameters are not the reference's")
        with torch.no_grad():
            for n, w in weights.items():
                params[n].copy_(w)
            for b in model.buffers():
                b.zero_()
        # the starting weights wait on the host for ``changes``
        self.weights0 = to_host(weights)
        del weights
        self.cfg, self.model = cfg, model
        self.heads = cfg.num_attention_heads
        args = TrainingArguments(
            learning_rate=o["learning_rate"], warmup_steps=o["warmup_steps"],
            total_steps=o["total_steps"], weight_decay=o["weight_decay"],
            max_grad_norm=o["max_grad_norm"], clamp_value=o["clamp_value"])
        state = TrainState.create(params, build_optimizer(args))
        start = o["schedule_start"]
        state.step = start
        state.opt_state = state.opt_state._replace(schedule_count=start)
        self.state = state
        self.accumulate = make_accumulate_step(build_loss_fn(model))
        self.acc = zeros_like_grads(params)
        spec = DeviceFlatPipeline.for_tree(self.acc).spec
        self.apply = make_flat_apply_step(build_flat_opt_factory(args)(spec, params),
                                          spec, post_apply=self._move_biases,
                                          from_tree=True)
        self.mean_clip = _fused_mean_clip
        self.cap = o["contrib_clip_per_sample"] * t["micro_batch"]
        self.move = drop_collator_keys
        self.loads = torch.zeros(cfg.moe_layers, cfg.n_routed_experts, device=self.device)
        self.window_pairs = torch.zeros(cfg.moe_layers, cfg.held, device=self.device)
        self.seq, self.micro = seq, t["micro_batch"]
        self.pool = traffic_pool(ctx)
        self.cursor = 0

    def _move_biases(self, new_state):
        self.model.bias_update(self.loads)
        self.loads.zero_()
        return new_state

    @property
    def kernel_shapes(self) -> dict:
        """The causal flash launches' [B, S, H, D_QK, D_V] and the held
        experts' pairs of the window's steps (read here, after it)."""
        cfg = self.cfg
        return {"mla_flash": (self.micro, self.seq, self.heads, cfg.qk_head_dim,
                              cfg.v_head_dim),
                "expert_loads": self.window_pairs.cpu().tolist()}

    def step(self, spans=OFF, probe=None):
        """One optimizer step; returns (loss, apply ok) on the device."""
        acc, n, losses = self.acc, 0, []
        first, held = self.cfg.first_expert, self.cfg.held
        for _ in range(self.accum):
            host = self.pool[self.cursor % len(self.pool)]
            self.cursor += 1
            with spans.data():
                batch = self.move(host, device=self.device)
            with spans.compute():
                acc, n, metrics = self.accumulate(self.state.params, acc, n, batch)
            losses.append(metrics["loss"])
            loads = metrics["expert_loads"]
            self.loads.add_(loads)
            if spans.on:
                self.window_pairs.add_(loads[:, first:first + held])
        with spans.boundary():
            if probe is not None:  # a copy: the accumulator is zeroed in place
                probe["sums"] = {k: v.detach().to("cpu", torch.float32, copy=True)
                                 for k, v in acc.items()}
            mean = self.mean_clip(acc, max(n, 1), self.cap)
            if probe is not None:
                probe["grads"] = to_host(mean)
            self.state, ok = self.apply(self.state, mean)
            del mean
            with torch.no_grad():
                for g in acc.values():
                    g.zero_()
        return torch.stack(losses).mean(), ok

    def changes(self) -> Dict[str, torch.Tensor]:
        """Each parameter's change from the start and each correction
        bias's (which started at 0), as float32 on the host."""
        out = {n: p.detach().float().cpu() - self.weights0[n]
               for n, p in self.state.params.items()}
        names = bias_names(model_config_of(self.cfg))
        for name, bias in zip(names, self.model.correction_biases()):
            out[name] = bias.float().cpu()
        return out

    def close(self):
        self.__dict__.clear()


def model_config_of(cfg) -> dict:
    return {"first_k_dense_replace": cfg.first_k_dense_replace,
            "num_hidden_layers": cfg.num_hidden_layers}


def build(ctx) -> Program:
    return Program(ctx)


class _BiasedLamb:
    """The reference's LAMB followed by each router's bias update from the
    step's loads (``commit`` adds each micro-batch's); a ``speed`` of 0
    leaves the biases as they are."""

    def __init__(self, lamb, biases, speed):
        self.lamb, self.biases, self.speed = lamb, biases, speed
        self.loads = 0.0

    def step(self, params, grads, schedule_step):
        self.lamb.step(params, grads, schedule_step)
        if self.speed:
            ref_ds.bias_update(self.biases, self.loads, self.speed)
        self.loads = 0.0


BIAS_FAULTS = {"sound": 1.0, "off": 0.0, "flip": -1.0}


def reference(ctx, steps: int, dtype=torch.float32, half: bool = False,
              flip: bool = False, bias: str = "sound") -> dict:
    """The plain reference over the program's first ``steps`` steps, a
    sequence, a few heads and a layer at a time; with ``half`` each step's
    second half of samples left out, with ``flip`` each parameter update
    added with the wrong sign (``drivers/albert.py`` ``reference``). The
    correction biases' update is ``bias``: ``sound``, ``off`` (never
    applied) or ``flip`` (with the wrong sign)."""
    from portbench.drivers.albert import _halved

    c, t, o = model_config(ctx.config), ctx.traffic, ctx.config["optimizer"]
    micro = [{k: torch.as_tensor(b[k]).to(ctx.device) for k in LOSS_KEYS}
             for b in traffic_pool(ctx)]
    per_step = [micro[i * t["accumulation"]:(i + 1) * t["accumulation"]]
                for i in range(steps)]
    if half:
        per_step = [_halved(s) for s in per_step]
    weights = init.draw(ref_ds.spec(c), ctx.seed, ctx.device)
    biases = {i: torch.zeros(c["n_routed_experts"], device=ctx.device, dtype=dtype)
              for i in ref_ds.moe_layers(c)}
    lamb = _BiasedLamb(optim.Lamb(o, ref_ds.weight_decay_mask(weights), flip=flip),
                       biases, BIAS_FAULTS[bias] * c["bias_update_speed"])

    class Model:
        @staticmethod
        def loss(P, batch, _step):
            loss, loads = ref_ds.loss(P, biases, batch, c, blocks=True)

            def commit():
                lamb.loads = lamb.loads + loads

            return loss, commit

    names = bias_names(c)
    return train.follow(weights, Model, per_step, lamb,
                        o["contrib_clip_per_sample"] * t["micro_batch"],
                        o["schedule_start"], dtype,
                        state_change=lambda: {n: b.float() for n, b in
                                              zip(names, biases.values())})
