"""Switch-style mixture-of-experts FFN (top-1 routing), in PyTorch.

Port of ``dedloc_tpu/parallel/moe.py`` for one device (``mesh=None``); the
expert-parallel axis comes with the parallel-axes slice. The numerics follow
the JAX layer:

- router logits ``x.float() @ router`` in fp32 (TF32 off: routing is
  discrete, and a TF32 product would send tokens to other experts), softmax
  gate, top-1 expert per token (ties to the first index);
- capacity ``C = max(1, ceil(T / E * capacity_factor))`` per call: a token's
  position in its expert's queue is the ``cumsum`` of the one-hot assignment
  in token order, and tokens at position ``>= C`` fall through with
  ``y = 0`` (the caller adds the residual);
- the expert FFN is ``gelu_tanh(x @ wi[e]) @ wo[e]`` in ``cfg.dtype``, the
  combine weight is the gate rounded to ``cfg.dtype``, ``y`` comes back in
  ``x.dtype``;
- the Switch aux loss ``E * sum(mean(one_hot) * mean(gates))``, with
  gradients through the gates only.

``moe_ffn`` dispatches by index: each token within capacity is copied into
its ``(expert, position)`` slot of an ``[E, C, H]`` buffer and its output is
gathered back, weighted by the gate. The JAX layer builds ``[T, E, C]``
one-hot masks and contracts them with einsums; every such sum has one
nonzero term, so the values are the same and the masks' products are not
done. ``moe_ffn_dense`` is that einsum formulation, the plain version the
tests hold the index dispatch to (bitwise in fp32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    hidden_size: int
    ffn_size: int
    num_experts: int
    capacity_factor: float = 1.25
    dtype: Any = torch.float32


def init_moe_params(cfg: MoEConfig, generator: torch.Generator) -> Params:
    """Router ``[H, E]`` fp32 and the expert stacks ``wi [E, H, F]``, ``wo
    [E, F, H]`` in ``cfg.dtype``, drawn on the given CPU generator (the JAX
    initialiser's scales; the draws are torch's)."""
    scale_in = 1.0 / math.sqrt(cfg.hidden_size)
    scale_out = 1.0 / math.sqrt(cfg.ffn_size)
    h, f, e = cfg.hidden_size, cfg.ffn_size, cfg.num_experts
    normal = lambda *shape: torch.randn(shape, generator=generator)
    return {
        "router": normal(h, e) * scale_in,
        "wi": (normal(e, h, f) * scale_in).to(cfg.dtype),
        "wo": (normal(e, f, h) * scale_out).to(cfg.dtype),
    }


def capacity_for(tokens: int, cfg: MoEConfig) -> int:
    return max(1, math.ceil(tokens / cfg.num_experts * cfg.capacity_factor))


def check_ieee_fp32(device: torch.device) -> None:
    """Routing is discrete, and a TF32 router product sends tokens to other
    experts, so on the card the product refuses to run with TF32 on. The
    setting is process-wide (switching it here would reach products on the
    role's other threads): a role that routes keeps it off for its whole
    life, as PyTorch's default has it."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the MoE router's fp32 product needs TF32 off "
            "(torch.backends.cuda.matmul.allow_tf32 = False)")


class Routing(NamedTuple):
    """One call's top-1 routing: the softmax ``gates [T, E]`` (fp32), the
    chosen ``expert [T]``, its ``gate [T]``, the token's ``position [T]`` in
    that expert's queue, ``keep [T]`` (position < capacity), the aux loss
    and the capacity."""

    gates: torch.Tensor
    expert: torch.Tensor
    gate: torch.Tensor
    position: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor
    capacity: int


def route(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig) -> Routing:
    """Top-1 routing of the tokens ``x [T, H]`` in their order."""
    t = x.shape[0]
    e = cfg.num_experts
    capacity = capacity_for(t, cfg)
    check_ieee_fp32(x.device)
    logits = x.float() @ router.float()
    gates = torch.softmax(logits, dim=-1)
    expert = torch.argmax(gates, dim=-1)
    gate = gates.gather(-1, expert[:, None])[:, 0]
    # the one-hot assignment expert-major, [E, T]: the running count of each
    # expert's tokens is then a scan along the inner dim (on an H100 the
    # outer-dim scan of [T, E] took ~1 ms at T = 6144, E = 8). The counts are
    # fp32 as the reference's, and exact in any order below 2^24 tokens
    assign = F.one_hot(expert, e).t().contiguous().float()
    position = torch.cumsum(assign, dim=1).gather(0, expert[None])[0] - 1.0
    keep = position < capacity
    aux = e * torch.sum(assign.mean(1) * gates.mean(0))
    return Routing(gates, expert, gate, position.long(), keep, aux, capacity)


def _check_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "moe_ffn with a mesh (experts sharded over an expert axis) comes "
            "with the parallel-axes slice of the port (ROADMAP A6)")


def experts(params: Params, expert_in: torch.Tensor, dtype) -> torch.Tensor:
    """``[E, C, H] -> [E, C, H]``: each expert's FFN on its slots."""
    h = torch.bmm(expert_in, params["wi"].to(dtype))
    return torch.bmm(F.gelu(h, approximate="tanh"), params["wo"].to(dtype))


def slots(r: Routing) -> torch.Tensor:
    """Each token's row of the flattened ``[E * C]`` expert buffer, and for a
    dropped token the spare row ``E * C`` past its end."""
    spare = r.gates.shape[1] * r.capacity
    return torch.where(r.keep, r.expert * r.capacity + r.position,
                       torch.full_like(r.position, spare))


def dispatch(x: torch.Tensor, r: Routing, cfg: MoEConfig) -> torch.Tensor:
    """``[T, H] -> [E, C, H]``: each kept token copied into its slot, the
    slots no token took zero. The dropped tokens all land in the spare row,
    which is cut off (so which of them lands last does not matter)."""
    e, c, h = cfg.num_experts, r.capacity, x.shape[1]
    buf = x.new_zeros((e * c + 1, h), dtype=cfg.dtype)
    buf = buf.index_copy(0, slots(r), x.to(cfg.dtype))
    return buf[:-1].view(e, c, h)


def combine(expert_out: torch.Tensor, r: Routing, cfg: MoEConfig) -> torch.Tensor:
    """``[E, C, H] -> [T, H]``: each kept token's expert output times its
    gate rounded to ``cfg.dtype``; a dropped token reads the zero spare row."""
    flat = expert_out.reshape(-1, expert_out.shape[-1])
    flat = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
    weight = (r.gate * r.keep).to(cfg.dtype)
    return flat.index_select(0, slots(r)) * weight[:, None]


def moe_ffn(params: Params, x: torch.Tensor, cfg: MoEConfig,
            mesh: Optional[object] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y [T, H], aux_loss)`` for the tokens ``x [T, H]`` (flatten batch x
    seq first, batch-major). Over-capacity tokens give zeros."""
    _check_mesh(mesh)
    r = route(params["router"], x, cfg)
    y = combine(experts(params, dispatch(x, r, cfg), cfg.dtype), r, cfg)
    return y.to(x.dtype), r.aux


def moe_ffn_dense(params: Params, x: torch.Tensor, cfg: MoEConfig,
                  mesh: Optional[object] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the reference's ``[T, E, C]`` dispatch and combine
    masks and its three einsums, term for term."""
    _check_mesh(mesh)
    r = route(params["router"], x, cfg)
    assign = F.one_hot(r.expert, cfg.num_experts).float()
    in_capacity = r.keep[:, None] & (assign > 0)
    pos = r.position.clamp(0, r.capacity - 1)
    dispatch_mask = (in_capacity.float()[:, :, None]
                     * F.one_hot(pos, r.capacity).float()[:, None, :])
    combine_mask = dispatch_mask * r.gate[:, None, None]
    expert_in = torch.einsum("tec,th->ech", dispatch_mask.to(cfg.dtype),
                             x.to(cfg.dtype))
    expert_out = experts(params, expert_in, cfg.dtype)
    y = torch.einsum("tec,ech->th", combine_mask.to(cfg.dtype), expert_out)
    return y.to(x.dtype), r.aux
