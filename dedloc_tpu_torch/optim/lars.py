"""LARS / LARC for SwAV: per-layer trust-ratio-clipped SGD with momentum.

Port of ``dedloc_tpu/optim/lars.py``'s ``lars``, in this order per leaf:

1. ``g + weight_decay * w``;
2. the norms ``||w||`` and ``||g||`` in fp32;
3. the local rate ``trust * ||w|| / (||g|| + eps)``, with ``clip``
   ``min(local / max(lr, 1e-12), 1) * lr`` (apex LARC's clip mode), else
   ``local * lr``; the rate is ``lr`` where either norm is 0;
4. the new momentum ``momentum * m + (-local_lr * g)``, which is also the
   update *added* to the params.

``Lars`` is functional like ``optim.lamb.Lamb``: ``init(params)`` gives the
state and ``update(grads, state, params)`` gives ``(updates, state')``.
The schedule count is a Python int on the local path and a 0-d int32
tensor on the card in the collaborative applies; the learning rate is then
computed there, and every division by a host number goes through
``utils/device.py`` ``divide``.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Union

import numpy as np
import torch

from dedloc_tpu_torch.models.convert import lars_state_from_jax, lars_state_views
from dedloc_tpu_torch.utils.device import divide

Params = Mapping[str, torch.Tensor]


class LarsState(NamedTuple):
    momentum: Dict[str, torch.Tensor]
    schedule_count: int  # the learning-rate schedule's count


def _norm(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return torch.sqrt((x * x).sum())


def local_rate(w_norm, g_norm, lr, trust_coefficient: float, eps: float,
               clip: bool):
    """The LARC rate of one layer (or, elementwise, of many): ``lr`` a host
    float or a 0-d tensor."""
    local_lr = trust_coefficient * w_norm / (g_norm + eps)
    if clip:
        if isinstance(lr, torch.Tensor):
            local_lr = local_lr / torch.clamp_min(lr, 1e-12)
        else:
            local_lr = divide(local_lr, float(np.maximum(np.float32(lr),
                                                         np.float32(1e-12))))
        local_lr = torch.clamp_max(local_lr, 1.0) * lr
    else:
        local_lr = local_lr * lr
    return torch.where((w_norm > 0) & (g_norm > 0), local_lr, lr)


class Lars:
    """LARC-style SGD (``lars`` without an exclude mask: the SwAV recipe
    passes none, so every leaf takes the trust ratio)."""

    def __init__(
        self,
        learning_rate: Union[float, Callable],
        momentum: float = 0.9,
        weight_decay: float = 1e-6,
        trust_coefficient: float = 0.001,
        eps: float = 1e-8,
        clip: bool = True,
    ):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.trust_coefficient = trust_coefficient
        self.eps = eps
        self.clip = clip

    def init(self, params: Params) -> LarsState:
        return LarsState(momentum={n: torch.zeros_like(p) for n, p in params.items()},
                         schedule_count=0)

    def _lr(self, count):
        lr = self.learning_rate
        if isinstance(count, torch.Tensor):
            return lr(count) if callable(lr) else float(np.float32(lr))
        return float(np.float32(lr(count) if callable(lr) else lr))

    @torch.no_grad()
    def update(self, grads: Params, state: LarsState, params: Params):
        lr = self._lr(state.schedule_count)
        new_mom = {}
        for n, g in grads.items():
            w = params[n]
            g = g + self.weight_decay * w
            rate = local_rate(_norm(w), _norm(g), lr, self.trust_coefficient,
                              self.eps, self.clip)
            new_mom[n] = self.momentum * state.momentum[n] + (-rate * g)
        return new_mom, LarsState(momentum=new_mom,
                                  schedule_count=state.schedule_count + 1)

    def state_views(self, params: Params, state: LarsState) -> Dict[str, torch.Tensor]:
        """``(params, state)`` under the JAX SwAV peer's shared-state names,
        as views in the JAX element order (``models.convert``)."""
        return lars_state_views(params, state)

    def state_from_named(self, named):
        """The shared state under JAX names -> ``(params, LarsState)`` on the
        CPU; raises ``KeyError``/``ValueError`` on a foreign state."""
        return lars_state_from_jax(named)
