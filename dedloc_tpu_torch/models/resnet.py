"""ResNet-50 trunk in PyTorch: NHWC input, bf16 convolutions, fp32
batch-norm statistics.

Port of ``dedloc_tpu/models/resnet.py``. The modules carry the flax names
(``stem_conv``, ``stem_bn``, ``stage{s}_block{b}.{reduce,conv3x3,expand,
proj}.{conv,bn}``; ``models/convert.py`` maps a ``Conv2d`` weight OIHW to
the JAX kernel HWIO), and the numerics follow flax:

- the input is the pipeline's NHWC float32 array, taken as an NCHW view of
  channels-last memory (no copy): cuDNN's fast layout;
- each convolution casts its input and its fp32 weight to ``cfg.dtype``
  (bf16) with explicit casts; batch norm runs in fp32 on the convolution's
  output, and ReLU, the residual add and the pooled features are fp32;
- batch norm is flax's: the batch variance is ``E[x^2] - E[x]^2`` clipped
  at 0, the running statistics move as ``0.9 * ra + 0.1 * stat`` with the
  *biased* variance (``F.batch_norm`` would store the unbiased one), and
  eval mode normalises with the running statistics;
- padding is explicit as in flax: the stem is 7x7 stride 2 pad 3, max pool
  3/2 pad 1 with -inf padding, and a block's stride sits on its 3x3 conv
  and its 1x1 ``proj``.

Each batch norm is one fused call (``ops/batch_norm.py``: Triton kernels on
the card, their plain versions on the CPU) that takes the ReLU after it and
a block's residual add as its epilogue, and writes its output in the dtype
its consumer takes: ``cfg.dtype`` for ``reduce`` and ``conv3x3``, whose one
consumer is a convolution that casts to it (the same rounding, made once);
fp32 for the stem (max pool feeds two convolutions), ``proj``, ``expand``
(the residual stream) and the head.

The running statistics (``mean``, ``var`` per BatchNorm, keyed
``<module path>.mean``/``.var``) are not module buffers: they are a plain
dict that a forward takes and returns, as the JAX step carries
``batch_stats``. Every mean over a Python-number count divides through
``utils/device.py`` ``divide`` (IEEE on CUDA too).

On a slice mesh (``parallel/mesh.py``) each rank holds its rows of the
batch and a batch norm's statistics are the slice's, as GSPMD makes them
for the JAX module under a sharded batch: one all-reduce per layer of the
per-channel sums, sums of squares and row count over the ``data`` axis
(flax's one ``pmean`` of ``[mean, mean2]``); the backward all-reduces the
per-channel sums its statistics' cotangent needs, so every rank's ``x``
gradient takes the other ranks' terms. Every rank then holds bitwise-equal
running statistics.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dedloc_tpu_torch.ops.batch_norm import batch_norm
from dedloc_tpu_torch.telemetry.steps import in_region
from dedloc_tpu_torch.utils.device import divide

Stats = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """ResNet-50 defaults (the reference's only trunk config)."""

    stage_sizes: Sequence[int] = (3, 4, 6, 3)
    width: int = 64
    dtype: Any = torch.bfloat16
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5

    @staticmethod
    def resnet50(**overrides) -> "ResNetConfig":
        return ResNetConfig(**overrides)

    @staticmethod
    def tiny(**overrides) -> "ResNetConfig":
        """Test-sized trunk."""
        base = dict(stage_sizes=(1, 1, 1, 1), width=8)
        base.update(overrides)
        return ResNetConfig(**base)

    @property
    def out_features(self) -> int:
        return self.width * 8 * 4  # final stage channels x bottleneck expansion


def _mean(x: torch.Tensor, dims) -> torch.Tensor:
    """``jnp.mean`` over ``dims``: a sum, then a division by the count."""
    count = math.prod(x.shape[d] for d in dims)
    return divide(x.sum(dims), count)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over every axis but the channels (axis 1),
    with fp32 statistics, and the epilogue that follows it. ``stats_name``
    is the module path its running statistics are keyed by (set by the
    root model). With a ``mesh`` the statistics are the slice's (module
    docstring)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5,
                 mesh=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))
        self.momentum = momentum
        self.eps = eps
        self.stats_name = ""
        self.mesh = mesh

    @in_region("norm")
    def forward(self, x: torch.Tensor, stats: Stats, train: bool, relu: bool = False,
                residual: Optional[torch.Tensor] = None,
                out_dtype=torch.float32) -> torch.Tensor:
        """``[ReLU]([residual +] normalised x)`` in ``out_dtype`` for ``x``
        [N, C] or channels-last [N, C, H, W]; in training mode, replace this
        layer's running statistics in ``stats``."""
        key = self.stats_name
        mesh = self.mesh
        if mesh is not None and mesh.group("data") is None:
            mesh = None  # no slice: the statistics are this rank's
        y, mean, var = batch_norm(
            x, self.weight, self.bias, stats[key + ".mean"], stats[key + ".var"],
            train=train, momentum=self.momentum, eps=self.eps, relu=relu,
            residual=residual, out_dtype=out_dtype, mesh=mesh)
        if train:
            stats[key + ".mean"], stats[key + ".var"] = mean, var
        return y


def conv(x: torch.Tensor, weight: torch.Tensor, dtype, stride: int,
         padding: int) -> torch.Tensor:
    """A bias-free convolution in ``dtype``: input and fp32 weight cast
    explicitly, both in channels-last memory (cuDNN's fast layout on the
    card).

    On the CPU a bf16 convolution runs as the fp32 convolution of the
    bf16-rounded operands, rounded to bf16: the same products (exact in
    fp32) with fp32 accumulation. PyTorch's own CPU bf16 convolution returns
    garbage weight gradients (~1e35) for a 3x3 stride-2 convolution of a
    1x1 map whose input also takes a gradient, which the tiny trunk's last
    stage is (ROADMAP, section C)."""
    x = x.to(dtype=dtype, memory_format=torch.channels_last)
    w = weight.to(dtype=dtype, memory_format=torch.channels_last)
    if x.device.type == "cpu" and dtype != torch.float32:
        return F.conv2d(x.float(), w.float(), stride=stride,
                        padding=padding).to(dtype)
    return F.conv2d(x, w, stride=stride, padding=padding)


class ConvBN(nn.Module):
    """A convolution and its batch norm, ReLU last where ``use_relu`` (after
    the residual add where one is given)."""

    def __init__(self, cfg: ResNetConfig, in_features: int, features: int,
                 kernel: int = 3, stride: int = 1, use_relu: bool = True,
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        self.stride, self.padding, self.use_relu = stride, kernel // 2, use_relu
        self.conv = nn.Conv2d(in_features, features, kernel, bias=False)
        self.bn = BatchNorm(features, cfg.bn_momentum, cfg.bn_eps, mesh)

    def forward(self, x, stats: Stats, train: bool, residual=None,
                out_dtype=torch.float32):
        y = conv(x, self.conv.weight, self.cfg.dtype, self.stride, self.padding)
        return self.bn(y, stats, train, relu=self.use_relu, residual=residual,
                       out_dtype=out_dtype)


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 -> 1x1 expand (x4), residual add, ReLU; a 1x1
    ``proj`` where the residual's shape changes."""

    def __init__(self, cfg: ResNetConfig, in_features: int, features: int,
                 stride: int = 1, mesh=None):
        super().__init__()
        self.reduce = ConvBN(cfg, in_features, features, 1, mesh=mesh)
        self.conv3x3 = ConvBN(cfg, features, features, 3, stride, mesh=mesh)
        self.expand = ConvBN(cfg, features, features * 4, 1, mesh=mesh)
        self.proj = (
            ConvBN(cfg, in_features, features * 4, 1, stride, use_relu=False,
                   mesh=mesh)
            if in_features != features * 4 or stride != 1 else None
        )

    def forward(self, x, stats: Stats, train: bool):
        # reduce and conv3x3 feed a convolution alone: written in its dtype
        dtype = self.reduce.cfg.dtype
        y = self.reduce(x, stats, train, out_dtype=dtype)
        y = self.conv3x3(y, stats, train, out_dtype=dtype)
        residual = x if self.proj is None else self.proj(x, stats, train)
        return self.expand(y, stats, train, residual=residual)  # ReLU(residual + y)


def name_batch_norms(root: nn.Module) -> None:
    """Key each BatchNorm's running statistics by its path under ``root``."""
    for name, module in root.named_modules():
        if isinstance(module, BatchNorm):
            module.stats_name = name


def init_batch_stats(root: nn.Module) -> Stats:
    """flax's initial running statistics: mean 0, var 1 per BatchNorm, on
    the device of its parameters."""
    stats = {}
    for module in root.modules():
        if isinstance(module, BatchNorm):
            w = module.weight
            stats[module.stats_name + ".mean"] = torch.zeros_like(w, dtype=torch.float32)
            stats[module.stats_name + ".var"] = torch.ones_like(w, dtype=torch.float32)
    return stats


class ResNet(nn.Module):
    """Globally pooled ``[N, out_features]`` fp32 trunk features of NHWC
    images; with a slice ``mesh``, of this rank's images, with the slice's
    batch statistics."""

    def __init__(self, cfg: ResNetConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.stem_conv = nn.Conv2d(3, cfg.width, 7, bias=False)
        self.stem_bn = BatchNorm(cfg.width, cfg.bn_momentum, cfg.bn_eps, mesh)
        in_features = cfg.width
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            for block in range(n_blocks):
                features = cfg.width * 2 ** stage
                stride = 2 if stage > 0 and block == 0 else 1
                self.add_module(f"stage{stage}_block{block}",
                                Bottleneck(cfg, in_features, features, stride, mesh))
                in_features = features * 4
        name_batch_norms(self)

    def features(self, images: torch.Tensor, stats: Stats, train: bool) -> torch.Tensor:
        """The trunk on NHWC ``images``, updating ``stats`` in place in
        training mode (a model that holds the trunk calls it once per crop
        group, each call reading the statistics the last one wrote, as
        flax's mutable ``batch_stats`` do)."""
        x = images.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        x = conv(x, self.stem_conv.weight, self.cfg.dtype, 2, 3)
        x = self.stem_bn(x, stats, train, relu=True)
        x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.children():
            if isinstance(block, Bottleneck):
                x = block(x, stats, train)
        return _mean(x, (2, 3)).float()  # global average pool

    def forward(self, images: torch.Tensor, batch_stats: Stats, train: bool = True):
        """(features, new batch_stats); ``batch_stats`` is left as it was."""
        stats = dict(batch_stats)
        return self.features(images, stats, train), stats


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init: a normal of variance 1 / fan_in truncated
    at two standard deviations (drawn on the CPU ``generator``)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    cpu = torch.empty(w.shape)
    nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std, generator=generator)
    w.copy_(cpu)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initialisers: lecun-normal conv and dense kernels, zero
    biases, BatchNorm scale 1 and bias 0. Draws on the given CPU generator,
    so a seed gives the same weights on any device."""
    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            o, i, kh, kw = module.weight.shape
            lecun_normal_(module.weight, i * kh * kw, generator)
        elif isinstance(module, nn.Linear):
            lecun_normal_(module.weight, module.weight.shape[1], generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, BatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model
