"""Kimi Linear cells (Kimi-Linear-48B-A3B): one trainer peer's local step on
one expert-parallel rank, as a peer alone at its step takes it
(``roles/trainer.py`` with ``--training.model_size kimi-linear-48b-a3b``).

The step is ``drivers/deepseek_v3.py``'s: ``gradient_accumulation``
packed micro-batches through ``make_accumulate_step(build_loss_fn(model))``,
then the boundary (``_fused_mean_clip``, the fused flat LAMB apply whose
``post_apply`` moves each router's correction bias by the step's loads,
the accumulator zeroed). The configuration's published key names are
mapped to the port's (``model_config``).

Handed over after the window through ``kernel_shapes``: the causal flash
launches' ``[B, S, H, D_QK, D_V]`` (``mla_flash``), the KDA chunk
kernels' ``[B, S, H, d_k, d_v, C]`` (``kda_chunk``), the held experts'
pairs of the window's steps (``expert_loads``, ``[L_moe, n]``) and each
KDA layer's largest final-state norm over them (``kda_state_norm``), both
counted on the device.

The port is imported inside ``build``: a checkout without the Kimi Linear
model fails there at once.
"""
from __future__ import annotations

import torch

from portbench.counts.kimi_linear import flops_per_token
from portbench.drivers import deepseek_v3 as ds_driver
from portbench.drivers.common import OFF, to_host, traffic_pool
from portbench.reference import optim, train
from portbench.reference import kimi_linear as ref_kl

LOSS_KEYS = ds_driver.LOSS_KEYS
PORT_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "moe_intermediate_size",
             "num_hidden_layers", "first_k_dense_replace", "num_attention_heads",
             "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
             "n_routed_experts", "num_experts_per_tok", "n_shared_experts",
             "routed_scaling_factor", "rms_norm_eps", "rope_theta",
             "max_position_embeddings", "initializer_range", "bias_update_speed",
             "aux_loss_alpha", "mla_use_nope", "kda_layers", "kda_heads", "kda_head_dim",
             "short_conv_kernel_size", "l2_norm_eps")


def model_config(c: dict) -> dict:
    """The configuration as this card runs it, under the port's key names:
    the model cut to its first ``layers_held`` layers (the final norm, the
    head and the loss on the last of them) and its rank's share of the
    experts."""
    lin = c["linear_attn_config"]
    return dict(c, n_routed_experts=c["num_experts"],
                num_experts_per_tok=c["num_experts_per_token"],
                n_shared_experts=c["num_shared_experts"],
                max_position_embeddings=c["model_max_length"],
                num_hidden_layers=c.get("layers_held") or c["num_hidden_layers"],
                experts_held=c.get("experts_held", 0), expert_rank=c.get("expert_rank", 0),
                kda_layers=tuple(lin["kda_layers"]), kda_heads=lin["num_heads"],
                kda_head_dim=lin["head_dim"],
                short_conv_kernel_size=lin["short_conv_kernel_size"])


class Program(ds_driver.Program):
    def __init__(self, ctx):
        from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline
        from dedloc_tpu_torch.collaborative.optimizer import _fused_mean_clip
        from dedloc_tpu_torch.core.config import TrainingArguments
        from dedloc_tpu_torch.ops import kda
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
        cfg, model = build_model("kimi-linear-48b-a3b", device="meta",
                                 moe_experts_held=c["experts_held"],
                                 expert_rank=c["expert_rank"],
                                 overrides={k: c[k] for k in PORT_KEYS})
        model = model.to_empty(device=self.device)
        weights = ref_kl.draw(ref_kl.spec(c), ctx.seed, self.device)
        params = dict(model.named_parameters())
        if set(params) != set(weights) or any(
                params[n].shape != w.shape for n, w in weights.items()):
            raise ValueError("the program's parameters are not the reference's")
        with torch.no_grad():
            for n, w in weights.items():
                params[n].copy_(w)
            for b in model.buffers():
                b.zero_()
        self.weights0 = to_host(weights)
        del weights
        self.cfg, self.model = cfg, model
        self.heads = cfg.num_attention_heads
        self.chunk = kda.CHUNK
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
        n_kda = sum(cfg.is_kda(i) for i in range(cfg.num_hidden_layers))
        self.window_norms = torch.zeros(n_kda, device=self.device)
        self.seq, self.micro = seq, t["micro_batch"]
        self.pool = traffic_pool(ctx)
        self.cursor = 0

    @property
    def kernel_shapes(self) -> dict:
        cfg = self.cfg
        return {"mla_flash": (self.micro, self.seq, self.heads, cfg.qk_head_dim,
                              cfg.v_head_dim),
                "kda_chunk": (self.micro, self.seq, cfg.kda_heads, cfg.kda_head_dim,
                              cfg.kda_head_dim, self.chunk),
                "expert_loads": self.window_pairs.cpu().tolist(),
                "kda_state_norm": self.window_norms.cpu().tolist()}

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
                torch.maximum(self.window_norms, metrics["kda_state_norm"],
                              out=self.window_norms)
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


def build(ctx) -> Program:
    return Program(ctx)


def reference(ctx, steps: int, dtype=torch.float32, half: bool = False,
              flip: bool = False, bias: str = "sound") -> dict:
    """The plain reference over the program's first ``steps`` steps
    (``reference/kimi_linear.py``, a sequence at a time, latent attention a
    few heads and a layer at a time, KDA a chunk at a time); ``half``,
    ``flip`` and ``bias`` as ``drivers/deepseek_v3.py`` ``reference``
    takes them."""
    from portbench.drivers.albert import _halved

    c, t, o = model_config(ctx.config), ctx.traffic, ctx.config["optimizer"]
    micro = [{k: torch.as_tensor(b[k]).to(ctx.device) for k in LOSS_KEYS}
             for b in traffic_pool(ctx)]
    per_step = [micro[i * t["accumulation"]:(i + 1) * t["accumulation"]]
                for i in range(steps)]
    if half:
        per_step = [_halved(s) for s in per_step]
    weights = ref_kl.draw(ref_kl.spec(c), ctx.seed, ctx.device)
    biases = {i: torch.zeros(c["n_routed_experts"], device=ctx.device, dtype=dtype)
              for i in ref_kl.ds.moe_layers(c)}
    lamb = ds_driver._BiasedLamb(optim.Lamb(o, ref_kl.weight_decay_mask(weights), flip=flip),
                                 biases, ds_driver.BIAS_FAULTS[bias] * c["bias_update_speed"])

    class Model:
        @staticmethod
        def loss(P, batch, _step):
            loss, loads = ref_kl.loss(P, biases, batch, c, blocks=True)

            def commit():
                lamb.loads = lamb.loads + loads

            return loss, commit

    names = ds_driver.bias_names(c)
    return train.follow(weights, Model, per_step, lamb,
                        o["contrib_clip_per_sample"] * t["micro_batch"],
                        o["schedule_start"], dtype,
                        state_change=lambda: {n: b.float() for n, b in
                                              zip(names, biases.values())})
