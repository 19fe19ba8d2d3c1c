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
and ``update(grads, state, params)`` gives ``(updates, state')`` and leaves
``state``'s tensors as they were (a guarded apply selects between the two).
Params and grads are dicts of tensors keyed by the port's parameter names.
The counts are Python ints on the local path, so an update never waits on
the device; the collaborative path's guarded applies keep them as 0-d int32
tensors on the card (a rolled-back step must not advance them), and then the
bias corrections and the learning rate are computed there too.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional, Union

import numpy as np
import torch

from dedloc_tpu_torch.models.convert import jax_keys, state_from_jax, state_views
from dedloc_tpu_torch.utils.device import divide

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


def _sq(x: torch.Tensor, name: str, reduce=None) -> torch.Tensor:
    """``sum(x * x)`` in fp32; with ``reduce`` (a sharded leaf), summed
    over the ranks that hold the rest of the leaf."""
    x = x.float()
    sq = (x * x).sum()
    return sq if reduce is None else reduce(name, sq)


def _norm(x: torch.Tensor, name: str = "", reduce=None) -> torch.Tensor:
    return torch.sqrt(_sq(x, name, reduce))


def bias_corrections(b1: float, b2: float, count):
    """(1 - b1^count, 1 - b2^count) in float32: host floats for an int
    count, 0-d tensors beside a tensor count."""
    if isinstance(count, torch.Tensor):
        c = count.to(torch.float32)
        p1, p2 = (torch.full_like(c, b) for b in (b1, b2))
        return 1.0 - torch.pow(p1, c), 1.0 - torch.pow(p2, c)
    c = np.float32(count)
    return (float(np.float32(1) - np.float32(b1) ** c),
            float(np.float32(1) - np.float32(b2) ** c))


def debiased(mu: torch.Tensor, nu: torch.Tensor, bc1, bc2):
    """The bias-corrected moments ``(mu / bc1, nu / bc2)`` as divisions, as
    optax's debias: host-float corrections (an int count) divide through
    ``divide``, which keeps them IEEE on CUDA."""
    if isinstance(bc1, torch.Tensor):
        return mu / bc1, nu / bc2
    return divide(mu, bc1), divide(nu, bc2)


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

    @property
    def has_schedule(self) -> bool:
        """Whether the JAX chain holds a schedule count (a callable rate)."""
        return callable(self.learning_rate)

    def _lr(self, count):
        lr = self.learning_rate
        if isinstance(count, torch.Tensor):
            return lr(count) if callable(lr) else float(np.float32(lr))
        return float(np.float32(lr(count) if callable(lr) else lr))

    def _clip(self, grads: Params, reduce=None) -> Dict[str, torch.Tensor]:
        if self.max_grad_norm is None:
            return dict(grads)
        total = None
        for n, g in grads.items():
            sq = _sq(g, n, reduce)
            total = sq if total is None else total + sq
        g_norm = torch.sqrt(total)
        keep = g_norm < self.max_grad_norm
        return {
            n: torch.where(keep, g, (g / g_norm) * self.max_grad_norm)
            for n, g in grads.items()
        }

    @torch.no_grad()
    def update(self, grads: Params, state: LambState, params: Params,
               reduce=None):
        """``reduce(name, partial_sq)``: for shards of a leaf (ZeRO, tensor
        or expert parallel), the sum of the ranks' partial squared norms,
        so the clip and the trust ratio see the whole leaf's norms."""
        b1, b2 = self.b1, self.b2
        grads = self._clip(grads, reduce)
        count = state.count + 1
        bc1, bc2 = bias_corrections(b1, b2, count)
        decay = albert_weight_decay_mask(params)
        step_size = -self._lr(state.schedule_count)
        updates, new_mu, new_nu = {}, {}, {}
        for n, g in grads.items():
            mu = new_mu[n] = state.mu[n] * b1 + (1 - b1) * g
            nu = new_nu[n] = state.nu[n] * b2 + (1 - b2) * g * g
            mu_hat, nu_hat = debiased(mu, nu, bc1, bc2)
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            w = params[n]
            if self.weight_decay > 0.0 and decay[n]:
                u = u + self.weight_decay * w
            u = u * trust_ratio_scale(_norm(w, n, reduce), _norm(u, n, reduce),
                                      self.clamp_value)
            updates[n] = step_size * u
        return updates, LambState(count=count, mu=new_mu, nu=new_nu,
                                  schedule_count=state.schedule_count + 1)

    def state_views(self, params: Params, state: LambState) -> Dict[str, torch.Tensor]:
        """``(params, state)`` under the JAX trainer's shared-state names,
        as views in the JAX element order (``models.convert.state_views``)."""
        return state_views(params, state, clip=self.max_grad_norm is not None,
                           schedule=self.has_schedule)

    def state_from_named(self, named):
        """The shared state under JAX names -> ``(params, LambState)`` on the
        CPU; raises ``KeyError``/``ValueError`` on a foreign state."""
        return state_from_jax(named)
