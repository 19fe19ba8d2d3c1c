"""The plain optimizer side of one collaborative step: the accumulator
mean with the contribution clip, LAMB, LARS (LARC clip mode), their
learning-rate schedules and the SwAV prototypes' renormalisation, written
from their published descriptions, leaf by leaf, in the dtype of the
tensors they are given.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

Tensors = Dict[str, torch.Tensor]


def linear_warmup_linear_decay(peak: float, warmup: int, total: int, step: int) -> float:
    if step < warmup:
        return peak * step / max(1.0, warmup)
    return peak * max(0.0, (total - step) / max(1.0, total - warmup))


def linear_warmup_cosine(peak: float, warmup: int, total: int, step: int) -> float:
    if step < warmup:
        return peak * step / max(1.0, warmup)
    progress = min(max((step - warmup) / max(1.0, total - warmup), 0.0), 1.0)
    return peak * 0.5 * (1.0 + math.cos(math.pi * progress))


def schedule(opt: dict, step: int) -> float:
    rule = {"linear": linear_warmup_linear_decay,
            "cosine": linear_warmup_cosine}[opt["schedule"]]
    return rule(opt["learning_rate"], opt["warmup_steps"], opt["total_steps"], step)


def global_norm(tensors: Tensors) -> torch.Tensor:
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in tensors.values()))


def mean_and_clip(acc: Tensors, n: int, cap: float) -> Tensors:
    """The contributed gradient: the accumulator's mean over ``n``
    micro-batches, scaled down to global norm ``cap`` when it is larger
    (``cap`` 0: no clip)."""
    mean = {k: g / n for k, g in acc.items()}
    if cap <= 0:
        return mean
    scale = torch.clamp_max(cap / (global_norm(mean) + 1e-12), 1.0)
    return {k: g * scale.to(g.dtype) for k, g in mean.items()}


class Lamb:
    """LAMB (You et al., arXiv 1904.00962) as the ALBERT recipe runs it:
    clip by global norm, Adam moments with bias correction, decoupled
    weight decay on the masked leaves, the per-leaf trust ratio
    min(||w||, clamp) / ||u||, then -lr. ``flip`` adds the update with
    the wrong sign: a planted fault for the benchmark's own checks."""

    def __init__(self, opt: dict, decay: Dict[str, bool], flip: bool = False):
        self.opt, self.decay = opt, decay
        self.sign = -1.0 if flip else 1.0
        self.mu: Tensors = {}
        self.nu: Tensors = {}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, schedule_step: int) -> None:
        o = self.opt
        b1, b2, eps = o["b1"], o["b2"], o["eps"]
        if o.get("max_grad_norm"):
            norm = global_norm(grads)
            if not norm < o["max_grad_norm"]:
                grads = {k: g / norm.to(g.dtype) * o["max_grad_norm"]
                         for k, g in grads.items()}
        self.count += 1
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        lr = schedule(o, schedule_step)
        for n, g in grads.items():
            w = params[n]
            mu = self.mu.get(n, torch.zeros_like(w)) * b1 + (1 - b1) * g
            nu = self.nu.get(n, torch.zeros_like(w)) * b2 + (1 - b2) * g * g
            self.mu[n], self.nu[n] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            if self.decay[n]:
                u = u + o["weight_decay"] * w
            w_norm = torch.clamp_max(torch.linalg.vector_norm(w), o["clamp_value"])
            u_norm = torch.linalg.vector_norm(u)
            ratio = w_norm / u_norm if (w_norm > 0 and u_norm > 0) else 1.0
            w.add_(-self.sign * lr * ratio * u)


class Lars:
    """LARS with apex LARC's clip mode (You et al., arXiv 1708.03888): per
    leaf g + wd w, the local rate trust ||w|| / ||g|| capped at the global
    rate, momentum, the update added to the weights (subtracted with
    ``flip``: a planted fault for the benchmark's own checks)."""

    def __init__(self, opt: dict, flip: bool = False):
        self.opt = opt
        self.sign = -1.0 if flip else 1.0
        self.momentum: Tensors = {}

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, schedule_step: int) -> None:
        o = self.opt
        lr = schedule(o, schedule_step)
        for n, g in grads.items():
            w = params[n]
            g = g + o["weight_decay"] * w
            w_norm, g_norm = torch.linalg.vector_norm(w), torch.linalg.vector_norm(g)
            rate = lr
            if w_norm > 0 and g_norm > 0:
                local = o["trust_coefficient"] * w_norm / (g_norm + o["eps"])
                rate = torch.clamp_max(local / max(lr, 1e-12), 1.0) * lr
            m = self.momentum.get(n, torch.zeros_like(w)) * o["momentum"] - rate * g
            self.momentum[n] = m
            w.add_(self.sign * m)


@torch.no_grad()
def normalize_rows(w: torch.Tensor, eps: Optional[float] = 1e-12) -> None:
    """Each row of ``w`` scaled to unit L2 norm (the SwAV prototypes)."""
    w.div_(torch.clamp_min(torch.linalg.vector_norm(w, dim=1, keepdim=True), eps))
