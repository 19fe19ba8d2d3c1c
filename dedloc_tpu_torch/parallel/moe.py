"""Switch-style mixture-of-experts FFN (top-1 routing), in PyTorch.

Port of ``dedloc_tpu/parallel/moe.py``. The numerics follow the JAX layer:

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

On a slice mesh (``mesh``, ``parallel/mesh.py``) the layer computes what
the JAX layer computes on the slice's whole ``[T_slice, H]`` under GSPMD:

- the capacity is ``ceil(T_slice / E * capacity_factor)`` and a token's
  position is its running count in the slice's batch-major order, across
  the data and seq shards: an exclusive prefix of the per-expert counts of
  the ranks' rows and sequence chunks (``route``'s ``rows``);
- the aux loss takes the slice's means (sums over the data and seq axes);
- with an ``expert`` axis each rank holds E/ep experts, fills only its
  experts' slots and combines only its experts' outputs; the combine is
  summed over the axis, and the gradients of x and of the gate are summed
  over it in the backward (``copy_to``). The router stays replicated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dedloc_tpu_torch.parallel.mesh import (
    PartitionSpec as P,
    all_gather,
    all_reduce,
    copy_to,
    psum,
)
from dedloc_tpu_torch.utils.device import divide

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


#: The axes that hold the slice's other tokens.
TOKEN_AXES = ("data", "seq")


def _token_shards(mesh) -> int:
    return 1 if mesh is None else mesh.axis_size(TOKEN_AXES)


def _slice_offsets(counts: torch.Tensor, mesh) -> torch.Tensor:
    """``counts [E, R]`` (this rank's tokens per expert in each of its R
    rows) -> the count of each expert's tokens before each row's chunk in
    the slice's batch-major order: rows by data shard, then row, then the
    row's sequence chunks by seq shard."""
    e, r = counts.shape
    dp = mesh.axis_size("data") if "data" in mesh.shape else 1
    sp = mesh.axis_size("seq") if "seq" in mesh.shape else 1
    every = all_gather(counts[None], mesh, TOKEN_AXES, dim=0)  # [dp*sp, E, R]
    every = every.view(dp, sp, e, r).permute(0, 3, 1, 2).reshape(-1, e)
    before = torch.cumsum(every, dim=0) - every  # exclusive, slice order
    before = before.view(dp, r, sp, e)
    mine = before[mesh.axis_index("data"), :, mesh.axis_index("seq")]
    return mine.t()  # [E, R]


def route(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig,
          mesh=None, rows: int = 1) -> Routing:
    """Top-1 routing of the tokens ``x [T, H]`` in their order. On a
    ``mesh`` with data or seq shards, ``x`` is this rank's part of the
    slice's tokens, ``rows`` batch rows of ``T / rows`` positions each, and
    capacity, positions and aux are the slice's."""
    t = x.shape[0]
    e = cfg.num_experts
    shards = _token_shards(mesh)
    capacity = capacity_for(t * shards, cfg)
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
    if shards == 1:
        position = torch.cumsum(assign, dim=1).gather(0, expert[None])[0] - 1.0
        aux = e * torch.sum(assign.mean(1) * gates.mean(0))
    else:
        chunks = assign.view(e, rows, t // rows)
        offsets = _slice_offsets(chunks.sum(2), mesh)
        running = torch.cumsum(chunks, dim=2) + offsets[..., None]
        position = running.view(e, t).gather(0, expert[None])[0] - 1.0
        n = t * shards
        density = divide(all_reduce(assign.sum(1), mesh, TOKEN_AXES), n)
        proxy = divide(psum(gates.sum(0), mesh, TOKEN_AXES), n)
        aux = e * torch.sum(density * proxy)
    keep = position < capacity
    return Routing(gates, expert, gate, position.long(), keep, aux, capacity)


def experts(params: Params, expert_in: torch.Tensor, dtype) -> torch.Tensor:
    """``[E, C, H] -> [E, C, H]``: each expert's FFN on its slots."""
    h = torch.bmm(expert_in, params["wi"].to(dtype))
    return torch.bmm(F.gelu(h, approximate="tanh"), params["wo"].to(dtype))


def _local(r: Routing, first: int, n: int) -> torch.Tensor:
    """Kept tokens routed to experts ``[first, first + n)``."""
    if first == 0 and n == r.gates.shape[1]:
        return r.keep
    return r.keep & (r.expert >= first) & (r.expert < first + n)


def slots(r: Routing, first: int = 0, n: Optional[int] = None) -> torch.Tensor:
    """Each token's row of the flattened ``[n * C]`` buffer of experts
    ``[first, first + n)`` (all by default), and for a token not kept there
    the spare row ``n * C`` past its end."""
    n = r.gates.shape[1] if n is None else n
    return torch.where(_local(r, first, n),
                       (r.expert - first) * r.capacity + r.position,
                       torch.full_like(r.position, n * r.capacity))


def dispatch(x: torch.Tensor, r: Routing, cfg: MoEConfig, first: int = 0,
             n: Optional[int] = None) -> torch.Tensor:
    """``[T, H] -> [n, C, H]``: each kept token of experts ``[first, first +
    n)`` copied into its slot, the slots no token took zero. The other
    tokens all land in the spare row, which is cut off (so which of them
    lands last does not matter)."""
    n = cfg.num_experts if n is None else n
    c, h = r.capacity, x.shape[1]
    buf = x.new_zeros((n * c + 1, h), dtype=cfg.dtype)
    buf = buf.index_copy(0, slots(r, first, n), x.to(cfg.dtype))
    return buf[:-1].view(n, c, h)


def combine(expert_out: torch.Tensor, r: Routing, cfg: MoEConfig,
            first: int = 0, gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[n, C, H] -> [T, H]``: each kept token's expert output times its
    gate rounded to ``cfg.dtype``; a token of no expert here reads the zero
    spare row."""
    n = expert_out.shape[0]
    flat = expert_out.reshape(-1, expert_out.shape[-1])
    flat = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
    gate = r.gate if gate is None else gate
    weight = (gate * _local(r, first, n)).to(cfg.dtype)
    return flat.index_select(0, slots(r, first, n)) * weight[:, None]


def expert_param_sharding(mesh=None, axis: str = "expert") -> Dict[str, P]:
    """Specs of ``init_moe_params``' output: experts split over ``axis``,
    the router replicated."""
    return {"router": P(), "wi": P(axis), "wo": P(axis)}


def moe_ffn(params: Params, x: torch.Tensor, cfg: MoEConfig,
            mesh: Optional[object] = None, axis: str = "expert",
            rows: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y [T, H], aux_loss)`` for the tokens ``x [T, H]`` (flatten batch x
    seq first, batch-major). Over-capacity tokens give zeros. On a ``mesh``
    (the module docstring): ``x`` is this rank's ``rows`` rows of the
    slice's tokens, and with an ``axis`` of more than one rank ``params``
    holds this rank's block of experts."""
    r = route(params["router"], x, cfg, mesh, rows)
    ep = mesh.shape.get(axis, 1) if mesh is not None else 1
    if ep == 1:
        y = combine(experts(params, dispatch(x, r, cfg), cfg.dtype), r, cfg)
        return y.to(x.dtype), r.aux
    n = cfg.num_experts // ep
    first = mesh.axis_index(axis) * n
    xe = copy_to(x, mesh, axis)
    gate = copy_to(r.gate, mesh, axis)
    out = experts(params, dispatch(xe, r, cfg, first, n), cfg.dtype)
    y = psum(combine(out, r, cfg, first, gate), mesh, axis)
    return y.to(x.dtype), r.aux


def moe_ffn_dense(params: Params, x: torch.Tensor, cfg: MoEConfig,
                  mesh: Optional[object] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version on one device: the reference's ``[T, E, C]``
    dispatch and combine masks and its three einsums, term for term."""
    if mesh is not None:
        raise ValueError("moe_ffn_dense is the one-device plain version")
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
