"""LAMB (layer-wise adaptive moments), as the JAX package's optax chain.

Port of ``dedloc_tpu/optim/lamb.py``'s ``lamb``, in this order:

1. ``clip_by_global_norm(max_grad_norm)`` over every gradient;
2. Adam moments with debias (the count starts at 0 and is incremented first);
3. ``m_hat / (sqrt(v_hat) + eps)``;
4. ``+ weight_decay * w`` where ``albert_weight_decay_mask`` says so, decided
   on the JAX leaf names;
5. the trust ratio ``min(||w||, clamp) / ||u||`` where both norms are
   positive, else 1;
6. ``* -lr(count)``, the schedule's own count starting at 0.

``Lamb`` is functional like optax's chain: ``init(params)`` gives the state
and ``update(grads, state, params)`` gives ``(updates, state')``. Params
and grads are dicts of tensors keyed by the port's parameter names. The
moments are updated in place (they are not read again by the caller), and
the counts are Python ints, so an update never waits on the device.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional, Union

import numpy as np
import torch

from dedloc_tpu_torch.models.convert import jax_keys

Params = Mapping[str, torch.Tensor]


class LambState(NamedTuple):
    count: int  # moments' step count (ScaleByLambState.count)
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    schedule_count: int  # the learning-rate schedule's count


def albert_weight_decay_mask(params: Params) -> Dict[str, bool]:
    """True where weight decay applies: everything except biases and
    LayerNorm scale/bias, judged on the JAX leaf names as the JAX mask is."""
    out = {}
    for name, p in params.items():
        keys, _ = jax_keys(name, p.ndim)
        joined = "/".join(keys).lower()
        out[name] = not (
            keys[-1] == "bias" or "layernorm" in joined or "layer_norm" in joined
        )
    return out


def _norm(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return torch.sqrt((x * x).sum())


def trust_ratio_scale(w_norm, u_norm, clamp_value: float):
    w_norm = torch.clamp(w_norm, max=clamp_value)
    ok = (w_norm > 0) & (u_norm > 0)
    return torch.where(ok, w_norm / u_norm, torch.ones_like(w_norm))


class Lamb:
    """The full chain: [clip] -> moments + decay -> trust ratio -> lr."""

    def __init__(
        self,
        learning_rate: Union[float, Callable[[int], float]],
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-6,
        weight_decay: float = 0.01,
        clamp_value: float = 10000.0,
        max_grad_norm: Optional[float] = None,
    ):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clamp_value = clamp_value
        self.max_grad_norm = max_grad_norm

    def init(self, params: Params) -> LambState:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        return LambState(count=0, mu=zeros(), nu=zeros(), schedule_count=0)

    def _lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(np.float32(lr(count) if callable(lr) else lr))

    def _clip(self, grads: Params) -> Dict[str, torch.Tensor]:
        if self.max_grad_norm is None:
            return dict(grads)
        total = None
        for g in grads.values():
            sq = (g.float() * g.float()).sum()
            total = sq if total is None else total + sq
        g_norm = torch.sqrt(total)
        keep = g_norm < self.max_grad_norm
        return {
            n: torch.where(keep, g, (g / g_norm) * self.max_grad_norm)
            for n, g in grads.items()
        }

    @torch.no_grad()
    def update(self, grads: Params, state: LambState, params: Params):
        b1, b2 = self.b1, self.b2
        grads = self._clip(grads)
        count = state.count + 1
        c = np.float32(count)
        bc1 = float(np.float32(1) - np.float32(b1) ** c)
        bc2 = float(np.float32(1) - np.float32(b2) ** c)
        decay = albert_weight_decay_mask(params)
        step_size = -self._lr(state.schedule_count)
        updates = {}
        for n, g in grads.items():
            mu = state.mu[n].mul_(b1).add_((1 - b1) * g)
            nu = state.nu[n].mul_(b2).add_((1 - b2) * g * g)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            w = params[n]
            if self.weight_decay > 0.0 and decay[n]:
                u = u + self.weight_decay * w
            u = u * trust_ratio_scale(_norm(w), _norm(u), self.clamp_value)
            updates[n] = step_size * u
        return updates, LambState(count=count, mu=state.mu, nu=state.nu,
                                  schedule_count=state.schedule_count + 1)
