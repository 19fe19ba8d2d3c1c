"""The plain reference's side of the first training steps: it follows
the program's first steps from the same weights on the same micro-batches
and gives the same readings the program's set-up gives.

Readings, each leaf's tensor on the host in float32: each step's loss
(the mean over its micro-batches); the first step's accumulated sum of
micro-batch gradients (``sums``) and its gradient as the optimizer gets it
(``grads``: after the accumulator's mean and the contribution clip); and
each leaf's change after the steps followed (``changes``: the parameters
and any state the model moves, such as running statistics).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from portbench.reference.optim import mean_and_clip, normalize_rows


def follow(weights: Dict[str, torch.Tensor], model, steps: Sequence[Sequence],
           optimizer, cap: float, schedule_start: int, dtype: torch.dtype,
           rows_of_prototypes: Sequence[str] = (),
           state_change: Callable[[], Dict[str, torch.Tensor]] = None) -> dict:
    """``model.loss(P, micro, global_step) -> (loss, commit)``; ``steps``
    the micro-batches of each step, on the device."""
    P = {k: v.detach().to(dtype).clone().requires_grad_(True)
         for k, v in weights.items()}
    names = list(P)
    losses: List[float] = []
    sums: Dict[str, torch.Tensor] = {}
    grads0: Dict[str, torch.Tensor] = {}
    for t, micro_batches in enumerate(steps):
        acc = {k: torch.zeros_like(P[k]) for k in names}
        total = 0.0
        for micro in micro_batches:
            loss, commit = model.loss(P, micro, schedule_start + t)
            grads = torch.autograd.grad(loss, [P[k] for k in names])
            with torch.no_grad():
                for k, g in zip(names, grads):
                    acc[k].add_(g)
            commit()
            total += float(loss.detach())
        g = mean_and_clip(acc, len(micro_batches), cap)
        if t == 0:
            sums, grads0 = to_host(acc), to_host(g)
        with torch.no_grad():
            data = {k: v.data for k, v in P.items()}
            optimizer.step(data, g, schedule_start + t)
            for k in rows_of_prototypes:
                normalize_rows(data[k])
        losses.append(total / len(micro_batches))
        del acc, g
    change = to_host({k: P[k].detach().float() - weights[k].float() for k in names})
    if state_change is not None:
        change.update(to_host(state_change()))
    return {"losses": losses, "sums": sums, "grads": grads0, "changes": change}


def to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each tensor as float32 on the host."""
    return {k: v.detach().float().cpu() for k, v in tensors.items()}
