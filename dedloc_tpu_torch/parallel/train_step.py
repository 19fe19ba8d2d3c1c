"""Train-step builders: local accumulation vs global apply, single device.

Port of ``dedloc_tpu/parallel/train_step.py`` (mesh and sharding arguments
wait for later slices). The collaborative loop splits one step into two
phases with different cadences:

  accumulate — per micro-batch: forward/backward, fp32 gradients summed into
               a persistent accumulator, plus a micro-batch counter.
  apply      — once per global optimizer step: optimizer update + LR
               schedule by global step.

``make_local_train_step`` fuses both for the single-peer path.

A loss function here is ``loss_fn(params, batch, rng) -> (loss, metrics)``
where ``params`` maps parameter names to tensors (``roles.common.
build_loss_fn`` makes one). JAX's arrays are immutable; here the gradient
accumulator and the parameters are updated in place, which is what JAX's
buffer donation achieves, so the states passed in are the states returned.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class TrainState:
    """Model + optimizer state keyed by the global collaboration step."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    opt_state: Any

    @classmethod
    def create(cls, params: Mapping[str, torch.nn.Parameter], tx) -> "TrainState":
        params = dict(params)
        return cls(step=0, params=params, opt_state=tx.init(params))


def zeros_like_grads(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}


def _grads(loss_fn: LossFn, params, batch, rng):
    loss, metrics = loss_fn(params, batch, rng)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    metrics = {k: v.detach() for k, v in metrics.items()}
    return dict(zip(names, grads)), metrics


def make_accumulate_step(loss_fn: LossFn) -> Callable:
    """(params, grad_acc, n_acc, batch, rng) -> (grad_acc', n_acc', metrics).

    ``grad_acc`` holds the running SUM of per-micro-batch mean gradients in
    fp32 (added to in place); ``n_acc`` counts micro-batches so the caller
    can normalize before averaging/apply."""

    def step(params, grad_acc, n_acc: int, batch, rng: Optional[torch.Generator] = None):
        grads, metrics = _grads(loss_fn, params, batch, rng)
        with torch.no_grad():
            for n, g in grads.items():
                grad_acc[n].add_(g.float())
        return grad_acc, n_acc + 1, metrics

    return step


def make_apply_step(tx) -> Callable:
    """(state, mean_grads) -> state'. Runs once per global step; the
    parameters are updated in place (``p + u`` in the parameter dtype)."""

    def apply(state: TrainState, grads) -> TrainState:
        updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
        with torch.no_grad():
            for n, p in state.params.items():
                p.add_(updates[n])
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=new_opt_state)

    return apply


def make_local_train_step(loss_fn: LossFn, tx, grad_accum_steps: int = 1) -> Callable:
    """Single-peer fused step: micro-batches, then the optimizer apply.

    Batch leaves have shape [grad_accum_steps, per_step_batch, ...]; each
    micro-batch adds ``g / grad_accum_steps`` to the fp32 accumulator."""
    apply = make_apply_step(tx)

    def train_step(state: TrainState, batch, rng: Optional[torch.Generator] = None):
        grad_acc = zeros_like_grads(state.params)
        per_micro = []
        for i in range(grad_accum_steps):
            micro = {k: v[i] for k, v in batch.items()}
            grads, metrics = _grads(loss_fn, state.params, micro, rng)
            with torch.no_grad():
                for n, g in grads.items():
                    grad_acc[n].add_(g.float() / grad_accum_steps)
            per_micro.append(metrics)
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                   for k in per_micro[0]}
        return apply(state, grad_acc), metrics

    return train_step
