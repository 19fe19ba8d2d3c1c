"""ALBERT for MLM + sentence-order-prediction pretraining, in PyTorch.

Port of ``dedloc_tpu/models/albert.py``. The modules carry the JAX model's
parameter names (``models/convert.py`` maps them both ways), and the numerics
follow it:

- matmuls take bf16 inputs (``cfg.dtype``) with fp32 params cast at use;
  embedding, LayerNorm and softmax statistics are fp32;
- the residual add before each LayerNorm is fp32 (``AddLayerNorm``), through
  the fused add+LayerNorm kernel when ``cfg.fused_ln``;
- ``attention_impl="flash"`` runs the flash-attention kernel; ``"dense"``
  materialises the fp32 scores; ``"blockwise"`` is the online softmax over
  KV blocks of ``attention_block_size`` (``parallel/ring_attention.py``);
- the encoder applies ONE shared block ``num_hidden_layers`` times, each
  application rematerialised under ``cfg.remat`` with the JAX package's
  policy of the same name (``remat_policy_object``);
- the mask is an additive ``-1e9`` key bias; the tied MLM decoder, the
  SOP head and the fine-tune heads return fp32 logits;
- dropout in training mode (``deterministic=False``) sits where flax's
  ``nn.Dropout`` sits (embeddings, dense attention probabilities, attention
  and FFN outputs, the fine-tune heads' input) and draws from an explicit
  CPU ``torch.Generator``, the dropout key: each site's mask comes from a
  generator on the tensor's device seeded by one draw of it, so a
  rematerialised block redraws the masks its forward drew.

- with ``moe_experts > 0`` the block's FFN is the Switch-routed expert FFN
  of ``parallel/moe.py`` (one expert set shared by the applications, as the
  block is). The encoder writes the aux loss summed over the applications
  into the ``losses`` dict its caller passes down (flax's ``"losses"``
  collection); each application returns its own beside ``hidden``, the one
  way out of its checkpoint.

On a slice mesh (``parallel/mesh.py``: one rank per mesh device, each
holding its blocks of the parameters, ``parallel/sharding.py``) the model
runs this rank's part and inserts the collectives GSPMD inserts for JAX:

- a ``model`` axis in ``mesh`` (tensor parallelism, Megatron): q/k/v and the FFN
  up-projection are column-parallel (the local heads go through the flash
  kernel), the attention output and the FFN down-projection row-parallel
  (a ``psum`` before the bias), the word embedding vocab-parallel (ids
  outside the local rows masked, then a ``psum``) and the tied decoder's
  vocab shards all-gathered into the logits;
- ``attention_impl="ring"`` with ``ring_mesh`` (the ``seq`` axis): each
  rank holds S/sp positions, its position ids and key bias start at
  rank x S/sp, and attention is ``parallel/ring_attention.py``'s ring;
- ``pipe_mesh`` (the ``pipe`` axis): the shared block staged over the
  ranks, num_hidden_layers/stages applications each, under the GPipe
  schedule of ``parallel/pipeline.py``;
- ``moe_mesh`` (the ``expert`` axis): each rank runs its experts
  (``parallel/moe.py``); ``mesh`` (the slice) makes the MoE capacity and
  positions the slice's, over its data and seq shards.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from dedloc_tpu_torch.ops import flash_attention as _flash
from dedloc_tpu_torch.ops import fused_ln as _fused_ln
from dedloc_tpu_torch.ops.flash_attention import flash_attention
from dedloc_tpu_torch.ops.fused_ln import ln_residual, ln_residual_reference
from dedloc_tpu_torch.parallel import moe as _moe
from dedloc_tpu_torch.parallel.mesh import copy_to, gather, psum
from dedloc_tpu_torch.parallel.ring_attention import (
    blockwise_attention,
    ring_attention,
)
from dedloc_tpu_torch.telemetry.steps import in_region, region
from dedloc_tpu_torch.utils.device import divide


@dataclasses.dataclass(frozen=True)
class AlbertConfig:
    """ALBERT-large defaults (the reference's canonical workload config)."""

    vocab_size: int = 30000
    embedding_size: int = 128
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.0
    attention_dropout_prob: float = 0.0
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    pad_token_id: int = 0
    dtype: Any = torch.bfloat16  # compute dtype; params stay fp32
    # rematerialise each application of the shared block under the named
    # policy (``remat_policy_object``): "nothing" keeps only the block's
    # inputs; the fused_ln* names also turn the fused add+LN kernel on
    # (``fused_ln_for_policy``), as the JAX builders do
    remat: bool = True
    remat_policy: str = "nothing"
    fused_ln: bool = False
    attention_impl: str = "dense"  # dense | blockwise | flash | ring
    # the KV block of blockwise attention (JAX also tiles its flash kernel
    # by it; the CUDA kernels tile by 64 at any length)
    attention_block_size: int = 512
    # sequence parallelism for attention_impl="ring": the mesh whose
    # ring_axis the sequence is split over
    ring_mesh: Any = None
    ring_axis: str = "seq"
    # pipeline parallelism: the mesh whose pipe_axis the block's
    # applications are staged over; pipe_microbatches 0 = 2 x stages
    pipe_mesh: Any = None
    pipe_axis: str = "pipe"
    pipe_microbatches: int = 0
    # Switch-MoE FFN variant (--training.moe_experts, parallel/moe.py): the
    # dense gelu FFN becomes a top-1-routed expert FFN; the load-balancing
    # aux loss is added at moe_aux_weight. moe_mesh: experts split over
    # its moe_axis
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_mesh: Any = None
    moe_axis: str = "expert"
    # the slice mesh: its data and seq axes hold the slice's other tokens
    # (the MoE capacity and positions, and the loss, are the slice's); a
    # "model" axis is tensor parallelism (the port's explicit form of the
    # JAX package's TP layout: the Megatron rules split over it)
    mesh: Any = None

    @staticmethod
    def named(model_size: str):
        ctors = {"tiny": AlbertConfig.tiny, "large": AlbertConfig.large}
        if model_size not in ctors:
            raise ValueError(
                f"unknown model_size {model_size!r} "
                f"(expected one of {sorted(ctors)})"
            )
        return ctors[model_size]

    @staticmethod
    def large(**overrides) -> "AlbertConfig":
        return AlbertConfig(**overrides)

    @staticmethod
    def tiny(**overrides) -> "AlbertConfig":
        """Test-sized config."""
        base = dict(
            vocab_size=512,
            embedding_size=16,
            hidden_size=32,
            num_hidden_layers=2,
            num_attention_heads=2,
            intermediate_size=64,
            max_position_embeddings=64,
        )
        base.update(overrides)
        return AlbertConfig(**base)


#: The policy names that engage the fused add+LN kernel.
FUSED_LN_POLICIES = frozenset({"fused_ln", "fused_ln_gelu"})


def fused_ln_for_policy(remat_policy: str) -> bool:
    return remat_policy in FUSED_LN_POLICIES


# ------------------------------------------------------------------- remat

_SCOPE = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """``jax.ad_checkpoint.checkpoint_name`` without the copy: the ops run
    inside the scope are named ``name`` for the ``save_only_these_names``
    policies, which read the innermost name as each op runs. Wrap only the
    op that produces the named tensor (and its views)."""
    outer = getattr(_SCOPE, "name", None)
    _SCOPE.name = name
    try:
        yield
    finally:
        _SCOPE.name = outer


_aten = torch.ops.aten
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable: the Dense
# projections (F.linear -> mm / addmm), not the attention einsums (bmm)
_NO_BATCH_DOTS = frozenset({_aten.mm.default, _aten.addmm.default})
# checkpoint_dots: every matmul
_DOTS = _NO_BATCH_DOTS | {_aten.bmm.default, _aten.baddbmm.default}
# _pallas_outputs_saveable: the outputs of the port's kernel operators,
# flash (out, lse) and the fused add+LN (y, x̂, rstd)
_KERNEL_OPS = frozenset({_flash.FORWARD_OP, _fused_ln.FORWARD_OP})


def _saves(ops=frozenset(), names=()) -> Callable:
    return lambda op: op in ops or getattr(_SCOPE, "name", None) in names


def remat_policy_object(name: str) -> Callable:
    """Resolve a remat-policy NAME to a selective-checkpoint policy function
    (``torch.utils.checkpoint.create_selective_checkpoint_contexts``) that
    saves what the JAX policy of the same name saves. Raises on unknown
    names."""
    table = {
        "nothing": _saves(),
        "dots": _saves(_DOTS),
        "dots_no_batch": _saves(_NO_BATCH_DOTS),
        "dots_no_batch_attn": _saves(_NO_BATCH_DOTS | _KERNEL_OPS),
        "fused_ln": _saves(_KERNEL_OPS, ("flash_qkv", "ffn_up")),
        "fused_ln_gelu": _saves(_KERNEL_OPS, ("flash_qkv", "ffn_up", "ffn_gelu")),
    }
    if name not in table:
        raise ValueError(
            f"unknown remat_policy {name!r}; expected one of {sorted(table)}"
        )
    save = table[name]

    def policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
        return (CheckpointPolicy.MUST_SAVE if save(op)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def _check_supported(cfg: AlbertConfig) -> None:
    if cfg.attention_impl not in ("dense", "blockwise", "flash", "ring"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    if cfg.attention_impl == "ring" and cfg.ring_mesh is None:
        raise ValueError(
            "attention_impl='ring' needs ring_mesh (a Mesh with a "
            f"{cfg.ring_axis!r} axis); the trainer sets it when "
            "--training.mesh_seq_devices > 1")
    if cfg.pipe_mesh is not None:
        n_stages = cfg.pipe_mesh.shape[cfg.pipe_axis]
        if cfg.num_hidden_layers % n_stages:
            raise ValueError(
                f"num_hidden_layers ({cfg.num_hidden_layers}) must divide "
                f"evenly into {n_stages} pipeline stages")
        if cfg.moe_experts > 0:
            raise ValueError(
                "pipe_mesh + moe_experts unsupported: the expert all-to-all "
                "would need its own axis inside the pipeline's stages")
        if cfg.attention_impl == "ring":
            raise ValueError(
                "pipe_mesh + attention_impl='ring' unsupported: ring "
                "attention runs its own collectives over the seq axis")
        if _tp(cfg)[0] is not None:
            raise ValueError(
                "pipe_mesh + tensor parallelism unsupported: the pipeline "
                "composes with the data axis only")
    if cfg.remat:
        remat_policy_object(cfg.remat_policy)  # unknown names raise here


def _tp(cfg: AlbertConfig):
    """(mesh, axis) of tensor parallelism, or (None, None)."""
    mesh = cfg.mesh
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        return mesh, "model"
    return None, None


def seq_offset(cfg: AlbertConfig, s_local: int) -> int:
    """The first global position of this rank's sequence shard."""
    if cfg.attention_impl != "ring" or cfg.ring_mesh is None:
        return 0
    return cfg.ring_mesh.axis_index(cfg.ring_axis) * s_local


def local_positions(cfg: AlbertConfig, positions: torch.Tensor, s_local: int):
    """Gathered MLM positions (global) -> (index into this rank's sequence
    shard, clamped; whether the position is in the shard)."""
    local = positions.long() - seq_offset(cfg, s_local)
    inside = (local >= 0) & (local < s_local)
    return local.clamp(0, s_local - 1), inside


def _column_parallel(dense: "Dense", x: torch.Tensor, name: Optional[str] = None):
    """A column-parallel ``Dense`` on the fp32 copy of a bf16 input that
    ``copy_to`` made: this rank's output columns, the product of the
    bf16-rounded operands accumulated in fp32 and rounded once, as the
    one-device product. In fp32 the input's gradient is this rank's partial
    sum, and ``copy_to`` adds the ranks' partials before one rounding
    (rounding each first would round twice)."""
    dt = dense.compute_dtype
    with checkpoint_name(name) if name else contextlib.nullcontext():
        y = F.linear(x, dense.weight.to(dt).float(), dense.bias.to(dt).float())
        return y.to(dt)


def _row_parallel(dense: "Dense", x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """A row-parallel ``Dense``: this rank's input slice times its rows of
    the weight in fp32 (the bf16-rounded operands), summed over ``axis``,
    plus the (replicated) bias, rounded once to the compute dtype, as the
    one-device product is."""
    dt = dense.compute_dtype
    y = psum(F.linear(x.to(dt).float(), dense.weight.to(dt).float()), mesh, axis)
    return (y + dense.bias.to(dt).float()).to(dt)


# ----------------------------------------------------------------- dropout


def _draw_seed(key: Optional[torch.Generator]) -> Optional[int]:
    """One draw of the CPU dropout key (no device sync): the seed of one
    dropout site or block application (JAX's key split)."""
    if key is None:
        return None
    return int(torch.randint(0, 2 ** 62, (), generator=key))


def _site_generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _dropout_key(rate: float, deterministic: bool,
                 generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
    """The dropout key a forward draws from: None when nothing drops
    (deterministic, or every rate 0); raises in training mode without one,
    as flax does without a "dropout" rng."""
    if deterministic or rate == 0.0:
        return None
    if generator is None:
        raise ValueError("dropout in training mode (deterministic=False) "
                         "needs a generator, the CPU dropout key")
    return generator


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    divide what is kept by that probability in x's dtype; the identity
    without a generator (deterministic) or at rate 0. ``generator`` lives on
    x's device."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, divide(x, keep), torch.zeros_like(x))


class Dense(nn.Linear):
    """``nn.Dense(dtype=cfg.dtype)``: input, weight and bias cast to the
    compute dtype (the weight is stored fp32, ``[out, in]``)."""

    def __init__(self, in_features: int, out_features: int, dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, name: Optional[str] = None) -> torch.Tensor:
        """``name``: the remat name of the output (``checkpoint_name``)."""
        dt = self.compute_dtype
        args = (x.to(dt), self.weight.to(dt), self.bias.to(dt))
        if name is None:
            return F.linear(*args)
        with checkpoint_name(name):
            return F.linear(*args)


class LayerNorm(nn.Module):
    """``nn.LayerNorm(dtype=float32)`` as flax computes it: fp32, with the
    variance taken as ``E[x^2] - E[x]^2`` (flax's fast variance)."""

    def __init__(self, size: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))

    @in_region("norm")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class AddLayerNorm(nn.Module):
    """``LayerNorm(x + residual)`` with the residual add in fp32; one fused
    kernel pass each way with ``cfg.fused_ln``."""

    def __init__(self, cfg: AlbertConfig):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.ones(cfg.hidden_size))
        self.bias = nn.Parameter(torch.zeros(cfg.hidden_size))

    @in_region("norm")
    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.fused_ln:
            y = ln_residual(x, residual, self.weight, self.bias,
                            eps=cfg.layer_norm_eps)
        else:
            y = ln_residual_reference(x.float(), residual.float(), self.weight,
                                      self.bias, eps=cfg.layer_norm_eps)
        return y.to(cfg.dtype)


class AlbertSelfAttention(nn.Module):
    def __init__(self, cfg: AlbertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = Dense(h, h, cfg.dtype)
        self.key = Dense(h, h, cfg.dtype)
        self.value = Dense(h, h, cfg.dtype)
        self.dense = Dense(h, h, cfg.dtype)
        self.layernorm = AddLayerNorm(cfg)

    @in_region("attention")
    def forward(self, hidden, kv_bias,
                generator: Optional[torch.Generator] = None):
        """``generator``: this block application's dropout generator on
        hidden's device (None: no dropout)."""
        cfg = self.cfg
        b, s, h = hidden.shape
        hd = h // cfg.num_attention_heads
        # this rank's heads: all of them, or its column block under TP
        nh = self.query.weight.shape[0] // hd
        hl = nh * hd
        mesh, axis = _tp(cfg)
        # q, k and v are the flash kernel's inputs, named for the fused_ln*
        # policies as the JAX package names them (in the flash call only)
        name = "flash_qkv" if cfg.attention_impl == "flash" else None
        if mesh is None:
            proj = lambda dense: dense(hidden, name)
        else:  # column-parallel: this rank's heads
            x = copy_to(hidden.float(), mesh, axis)
            proj = lambda dense: _column_parallel(dense, x, name)
        q = proj(self.query).reshape(b, s, nh, hd)
        k = proj(self.key).reshape(b, s, nh, hd)
        v = proj(self.value).reshape(b, s, nh, hd)
        if cfg.attention_impl == "flash":
            ctx = flash_attention(q, k, v, kv_bias).reshape(b, s, hl)
        elif cfg.attention_impl == "ring":
            # sequence parallel: KV shards travel the ring of the seq axis
            ctx = ring_attention(q, k, v, kv_bias, mesh=cfg.ring_mesh,
                                 axis=cfg.ring_axis).reshape(b, s, hl)
        elif cfg.attention_impl == "blockwise":
            # the long-context path without the kernel: exact online softmax
            # over KV blocks, never the S x S scores at once
            ctx = blockwise_attention(
                q, k, v, kv_bias, block_size=cfg.attention_block_size
            ).reshape(b, s, hl)
        else:
            # fp32 logits + softmax; bf16 probabilities and context
            scale = 1.0 / math.sqrt(hd)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            logits = logits * scale + kv_bias[:, None, None, :]
            probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
            probs = dropout(probs, cfg.attention_dropout_prob, generator)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, hl)
        out = (self.dense(ctx) if mesh is None
               else _row_parallel(self.dense, ctx, mesh, axis))
        out = dropout(out, cfg.hidden_dropout_prob, generator)
        return self.layernorm(out, hidden)


class AlbertLayer(nn.Module):
    """One shared transformer block (attention + tanh-GELU FFN, post-LN).

    Returns ``(hidden, aux)``: ``aux`` is the Switch load-balancing loss
    when ``cfg.moe_experts`` routes the FFN through experts, else None."""

    def __init__(self, cfg: AlbertConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = AlbertSelfAttention(cfg)
        h, f, e = cfg.hidden_size, cfg.intermediate_size, cfg.moe_experts
        if e > 0:
            # the JAX layer's leaves (fp32 masters; the experts are cast to
            # cfg.dtype at use, the router stays fp32) in place of ffn and
            # ffn_output
            self.moe_router = nn.Parameter(torch.zeros(h, e))
            self.moe_wi = nn.Parameter(torch.zeros(e, h, f))
            self.moe_wo = nn.Parameter(torch.zeros(e, f, h))
        else:
            self.ffn = Dense(h, f, cfg.dtype)
            self.ffn_output = Dense(f, h, cfg.dtype)
        self.layernorm = AddLayerNorm(cfg)

    def forward(self, hidden, kv_bias, seed: Optional[int] = None):
        """``seed``: this application's dropout seed (None: no dropout). The
        generator is made here from it, so a remat recompute of the block
        redraws the masks of its forward."""
        generator = _site_generator(seed, hidden.device)
        hidden = self.attention(hidden, kv_bias, generator)
        return self._ffn(hidden, generator)

    @in_region("ffn")
    def _ffn(self, hidden, generator):
        """The FFN (dense, or the experts) and its add+LN: (hidden, aux)."""
        aux = None
        if self.cfg.moe_experts > 0:
            # no named outputs: the fused_ln* policies recompute the branch
            # in the backward, as under JAX
            ffn, aux = self._moe_ffn(hidden)
        else:
            # named for the fused_ln* policies: the up-projection (gelu's
            # input) and the gelu output (saved by fused_ln_gelu only);
            # under TP the up-projection is column-, the down row-parallel
            mesh, axis = _tp(self.cfg)
            ffn = (self.ffn(hidden, "ffn_up") if mesh is None else _column_parallel(
                self.ffn, copy_to(hidden.float(), mesh, axis), "ffn_up"))
            with checkpoint_name("ffn_gelu"):
                ffn = F.gelu(ffn, approximate="tanh")
            ffn = (self.ffn_output(ffn) if mesh is None
                   else _row_parallel(self.ffn_output, ffn, mesh, axis))
        ffn = dropout(ffn, self.cfg.hidden_dropout_prob, generator)
        return self.layernorm(ffn, hidden), aux

    def moe_config(self) -> _moe.MoEConfig:
        cfg = self.cfg
        return _moe.MoEConfig(
            hidden_size=cfg.hidden_size, ffn_size=cfg.intermediate_size,
            num_experts=cfg.moe_experts,
            capacity_factor=cfg.moe_capacity_factor, dtype=cfg.dtype,
        )

    def _moe_ffn(self, hidden):
        """The Switch-routed FFN over the block's tokens in batch-major
        order (``parallel/moe.py``): bf16 experts like the dense FFN, the
        router's product in fp32."""
        cfg = self.cfg
        b, s, h = hidden.shape
        params = {"router": self.moe_router,
                  "wi": self.moe_wi.to(cfg.dtype),
                  "wo": self.moe_wo.to(cfg.dtype)}
        y, aux = _moe.moe_ffn(params, hidden.reshape(b * s, h), self.moe_config(),
                              mesh=cfg.moe_mesh or cfg.mesh, axis=cfg.moe_axis,
                              rows=b)
        return y.reshape(b, s, h).to(cfg.dtype), aux


@contextlib.contextmanager
def recorded_routing(model: nn.Module):
    """Within the scope, each application of the MoE block of ``model``
    appends its routing (``parallel/moe.py``'s ``Routing``, detached) to the
    list this yields: a forward hook on the block's attention, whose output
    is the expert FFN's input, routes those tokens again. Run the model
    without a gradient: a rematerialised backward would record again."""
    block = next(m for m in model.modules() if isinstance(m, AlbertLayer))
    if block.cfg.moe_experts <= 0:
        raise ValueError("recorded_routing needs a model with moe_experts > 0")
    mcfg, seen = block.moe_config(), []

    def hook(_module, _args, hidden):
        with torch.no_grad():
            seen.append(_moe.route(block.moe_router,
                                   hidden.reshape(-1, hidden.shape[-1]), mcfg))

    handle = block.attention.register_forward_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


class _SharedLayer(nn.Module):
    """Holds the one block under the JAX path ``encoder/layer/block``."""

    def __init__(self, cfg: AlbertConfig):
        super().__init__()
        self.block = AlbertLayer(cfg)


class AlbertEncoder(nn.Module):
    """ALBERT's cross-layer sharing: one block applied num_hidden_layers
    times (the JAX package's ``nn.scan`` with broadcast params). Under
    ``cfg.remat`` each application is a selective checkpoint (the JAX
    package's ``nn.remat`` of the scanned layer): the backward recomputes
    what the policy does not save."""

    def __init__(self, cfg: AlbertConfig):
        super().__init__()
        self.cfg = cfg
        self.layer = _SharedLayer(cfg)

    def forward(self, hidden, kv_bias, key: Optional[torch.Generator] = None,
                losses: Optional[dict] = None):
        """``key``: the CPU dropout key (None: no dropout); each application
        draws its own seed from it. With experts, ``losses["moe_aux"]``
        receives the aux loss summed over the applications. With
        ``pipe_mesh`` the applications run staged (``_pipelined``)."""
        if self.cfg.pipe_mesh is not None:
            return self._pipelined(hidden, kv_bias, key)
        apply = self._application(key)
        auxes = []
        for _ in range(self.cfg.num_hidden_layers):
            hidden, aux = apply(hidden, kv_bias)
            if aux is not None:
                auxes.append(aux)
        if auxes and losses is not None:
            losses["moe_aux"] = torch.stack(auxes).sum()
        return hidden

    def _application(self, key):
        """One application of the shared block, ``(hidden, kv_bias) ->
        (hidden, aux)``: a selective checkpoint under ``cfg.remat`` (the
        JAX package's ``nn.remat`` of the scanned layer; the backward
        recomputes what the policy does not save)."""
        block = self.layer.block
        if self.cfg.remat and torch.is_grad_enabled():
            contexts = functools.partial(
                create_selective_checkpoint_contexts,
                remat_policy_object(self.cfg.remat_policy))
            return lambda h, b: checkpoint(block, h, b, _draw_seed(key),
                                           use_reentrant=False,
                                           context_fn=contexts)
        return lambda h, b: block(h, b, _draw_seed(key))

    def _pipelined(self, hidden, kv_bias, key):
        """Pipeline-parallel forward: num_hidden_layers/stages applications
        of the ONE shared block per stage, microbatches hopping stage to
        stage (``parallel/pipeline.py``); the parameters are the scanned
        path's, so checkpoints and gradient schemas are the same. Each
        rank holds its data rows; the pipe axis splits no batch dim."""
        from dedloc_tpu_torch.parallel.pipeline import pipeline_apply, shared_stage_fn

        cfg = self.cfg
        if key is not None:
            raise ValueError(
                "the pipeline path threads no dropout through its stages; "
                "use dropout 0 (the reference recipe)")
        n_stages = cfg.pipe_mesh.shape[cfg.pipe_axis]
        b = hidden.shape[0]
        m = cfg.pipe_microbatches or 2 * n_stages
        if b % m:
            raise ValueError(f"batch ({b}) must divide into "
                             f"pipe_microbatches ({m})")
        apply = self._application(None)

        def block_fn(_params, xb):
            h, bias = xb
            return apply(h, bias)[0], bias

        stage = shared_stage_fn(block_fn, cfg.num_hidden_layers // n_stages)
        micro = (hidden.reshape((m, b // m) + hidden.shape[1:]),
                 kv_bias.reshape((m, b // m) + kv_bias.shape[1:]))
        # the block's parameters as this forward holds them (functional_call
        # swaps them in): the pipeline's node routes their gradients
        params = dict(self.layer.block.named_parameters())
        out, _ = pipeline_apply(stage, params, micro, cfg.pipe_mesh,
                                axis=cfg.pipe_axis, stacked_params=False)
        return out.reshape(hidden.shape)


class AlbertModel(nn.Module):
    def __init__(self, cfg: AlbertConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        e = cfg.embedding_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, e)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, e)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, e)
        self.embeddings_layernorm = LayerNorm(e, cfg.layer_norm_eps)
        self.embedding_projection = Dense(e, cfg.hidden_size, cfg.dtype)
        self.encoder = AlbertEncoder(cfg)
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size, cfg.dtype)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                losses: Optional[dict] = None):
        """``generator``: the CPU dropout key, required in training mode
        (``deterministic=False``) when a dropout rate is nonzero. With
        experts, the aux loss is written to ``losses["moe_aux"]`` when a
        dict is given (flax's ``"losses"`` collection)."""
        cfg = self.cfg
        b, s = input_ids.shape
        if (cfg.attention_impl in ("flash", "blockwise")
                and cfg.attention_dropout_prob > 0.0 and not deterministic):
            raise ValueError(
                f"attention_impl={cfg.attention_impl!r} does not support "
                "attention dropout in training (the reference recipe uses "
                "0.0); use attention_impl='dense' or attention_dropout_prob=0"
            )
        key = _dropout_key(cfg.hidden_dropout_prob + cfg.attention_dropout_prob,
                           deterministic, generator)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        # under sequence parallelism this rank holds positions from
        # rank x S/sp on
        with region("embed"):
            positions = torch.arange(s, device=input_ids.device) + seq_offset(cfg, s)
            emb = (self._word_embedding(input_ids)
                   + self.position_embeddings(positions)[None]
                   + self.token_type_embeddings(token_type_ids))
            emb = self.embeddings_layernorm(emb)
            emb = dropout(emb, cfg.hidden_dropout_prob,
                          _site_generator(_draw_seed(key), emb.device))
            hidden = self.embedding_projection(emb)  # factorized: E -> hidden
        kv_bias = torch.where(attention_mask > 0, 0.0, -1e9).to(torch.float32)
        hidden = self.encoder(hidden, kv_bias, key, losses)
        with region("head"):
            pooled = torch.tanh(self.pooler(hidden[:, 0]))
        return hidden, pooled

    def _word_embedding(self, ids: torch.Tensor) -> torch.Tensor:
        """The lookup; under TP vocab-parallel: this rank's rows of the
        table, ids outside them masked, summed over the model axis."""
        mesh, axis = _tp(self.cfg)
        if mesh is None:
            return self.word_embeddings(ids)
        rows = self.word_embeddings.weight.shape[0]
        local = ids.long() - mesh.axis_index(axis) * rows
        inside = (local >= 0) & (local < rows)
        emb = F.embedding(local.clamp(0, rows - 1), self.word_embeddings.weight)
        return psum(emb * inside[..., None], mesh, axis)


class AlbertForPreTraining(nn.Module):
    """ALBERT with MLM + sentence-order-prediction heads; the MLM decoder is
    tied to the word-embedding table."""

    def __init__(self, cfg: AlbertConfig):
        super().__init__()
        self.cfg = cfg
        self.albert = AlbertModel(cfg)
        self.mlm_dense = Dense(cfg.hidden_size, cfg.embedding_size, cfg.dtype)
        self.mlm_layernorm = LayerNorm(cfg.embedding_size, cfg.layer_norm_eps)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        self.sop_classifier = Dense(cfg.hidden_size, 2, cfg.dtype)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True,
                mlm_positions: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                losses: Optional[dict] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``mlm_positions`` [B, P]: the MLM head runs only on those gathered
        positions (logits [B, P, vocab]); None covers every position.
        ``losses``: a dict that receives ``moe_aux`` with experts."""
        hidden, pooled = self.albert(input_ids, attention_mask, token_type_ids,
                                     deterministic, generator, losses)
        return self._heads(hidden, pooled, mlm_positions)

    @in_region("head")
    def _heads(self, hidden, pooled, mlm_positions):
        """The tied MLM decoder and the SOP classifier: fp32 logits."""
        cfg = self.cfg
        if mlm_positions is not None:
            # under sequence parallelism the positions outside this rank's
            # shard read a clamped row (the loss masks them)
            pos, _inside = local_positions(cfg, mlm_positions, hidden.shape[1])
            idx = pos[..., None].expand(-1, -1, hidden.shape[-1])
            hidden = torch.gather(hidden, 1, idx)
        x = F.gelu(self.mlm_dense(hidden), approximate="tanh")
        x = self.mlm_layernorm(x).to(cfg.dtype)
        table = self.albert.word_embeddings.weight.to(cfg.dtype)
        # bf16 operands, fp32 accumulation (preferred_element_type=f32);
        # under TP each rank's vocab block, all-gathered into the logits
        mesh, axis = _tp(cfg)
        # (the fp32 input's gradient: the ranks' partials summed unrounded)
        mlm_logits = copy_to(x.float(), mesh, axis) @ table.float().t() + self.mlm_bias
        mlm_logits = gather(mlm_logits, mesh, axis, dim=-1)
        sop_logits = self.sop_classifier(pooled).float()
        return mlm_logits, sop_logits


class _ClassificationHead(nn.Module):
    """Backbone -> dropout(classifier_dropout) -> ``Dense(num_labels)``, fp32
    logits: the JAX package's fine-tune heads, under the names ``albert``
    and ``classifier`` (``models/convert.py`` maps them as they are)."""

    pooled = False  # classify the pooled [CLS] output, else every position

    def __init__(self, cfg: AlbertConfig, num_labels: int,
                 classifier_dropout: float = 0.1):
        super().__init__()
        self.cfg = cfg
        self.num_labels = num_labels
        self.classifier_dropout = classifier_dropout
        self.albert = AlbertModel(cfg)
        self.classifier = Dense(cfg.hidden_size, num_labels, cfg.dtype)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: the CPU dropout key, required in training mode."""
        hidden, pooled = self.albert(input_ids, attention_mask, token_type_ids,
                                     deterministic, generator)
        x = pooled if self.pooled else hidden
        key = _dropout_key(self.classifier_dropout, deterministic, generator)
        x = dropout(x, self.classifier_dropout,
                    _site_generator(_draw_seed(key), x.device))
        return self.classifier(x).float()


class AlbertForTokenClassification(_ClassificationHead):
    """A per-token classifier over the hidden states: logits [B, S, L]
    (the NER head)."""


class AlbertForSequenceClassification(_ClassificationHead):
    """A classifier over the pooled [CLS] output: logits [B, L] (the news
    category head)."""

    pooled = True


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX initialisers: normal(initializer_range) for dense kernels,
    embeddings and the MoE router and expert stacks, zeros for biases,
    ones/zeros for LayerNorm. Draws on the given CPU generator, so a seed
    gives the same weights on any device."""
    std = model.cfg.initializer_range
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Embedding)):
            w = torch.empty(module.weight.shape).normal_(0.0, std,
                                                         generator=generator)
            module.weight.copy_(w)
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
        elif isinstance(module, (LayerNorm, AddLayerNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, AlbertLayer) and module.cfg.moe_experts > 0:
            for p in (module.moe_router, module.moe_wi, module.moe_wo):
                p.copy_(torch.empty(p.shape).normal_(0.0, std,
                                                     generator=generator))
    if isinstance(model, AlbertForPreTraining):
        model.mlm_bias.zero_()
    return model


# ------------------------------------------------------------------- losses


def _masked_cross_entropy(logits, labels, mask):
    """Masked-mean CE + accuracy over positions where ``mask`` is 1."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    hits = (logits.argmax(-1) == labels.long()).float()
    acc = (hits * mask).sum() / denom
    return loss, acc, denom


def _sop_loss(sop_logits, sop_labels):
    logp = torch.log_softmax(sop_logits.float(), dim=-1)
    return -logp.gather(-1, sop_labels.long()[:, None])[:, 0].mean()


def classification_loss(logits, labels, ignore_index: int = -100):
    """Cross-entropy over any leading shape, masked-mean over labels !=
    ``ignore_index``: token classification ([B, S, L] logits) and sequence
    classification ([B, L], all labelled)."""
    mask = (labels != ignore_index).float()
    safe = torch.where(labels == ignore_index, torch.zeros_like(labels), labels)
    loss, acc, _ = _masked_cross_entropy(logits, safe, mask)
    return loss, {"loss": loss, "accuracy": acc, "n_labels": mask.sum()}


@in_region("loss")
def albert_pretraining_loss(mlm_logits, sop_logits, mlm_labels, sop_labels,
                            ignore_index: int = -100):
    """MLM + SOP cross-entropy, masked-mean over labelled positions."""
    mask = (mlm_labels != ignore_index).float()
    safe = torch.where(mlm_labels == ignore_index,
                       torch.zeros_like(mlm_labels), mlm_labels)
    mlm_loss, mlm_acc, _ = _masked_cross_entropy(mlm_logits, safe, mask)
    sop_loss = _sop_loss(sop_logits, sop_labels)
    loss = mlm_loss + sop_loss
    return loss, {"loss": loss, "mlm_loss": mlm_loss, "sop_loss": sop_loss,
                  "mlm_acc": mlm_acc}


@in_region("loss")
def albert_pretraining_loss_gathered(mlm_logits, sop_logits, mlm_label_ids,
                                     mlm_weights, sop_labels):
    """Masked-position variant: logits at the gathered positions, weights
    1.0 for a real prediction and 0.0 for padding."""
    w = mlm_weights.float()
    mlm_loss, mlm_acc, _ = _masked_cross_entropy(mlm_logits, mlm_label_ids, w)
    sop_loss = _sop_loss(sop_logits, sop_labels)
    loss = mlm_loss + sop_loss
    return loss, {"loss": loss, "mlm_loss": mlm_loss, "sop_loss": sop_loss,
                  "mlm_acc": mlm_acc}
