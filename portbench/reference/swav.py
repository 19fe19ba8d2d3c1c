"""SwAV on a ResNet-50 trunk, plain PyTorch.

Written from SwAV (Caron et al., arXiv 2006.09882; the
``swav_1node_resnet_submit.yaml`` recipe) and ResNet-50 (He et al., arXiv
1512.03385, bottleneck v1 with the stride on the 3x3): the trunk runs once
per crop resolution with batch statistics over that group (biased
variance E[x^2] - E[x]^2, running statistics moved as 0.9 old + 0.1
new), a 2048 -> 2048 -> 128 projection with batch norm and ReLU between
its layers, L2-normalised embeddings, bias-free prototypes; the
assignments by three Sinkhorn-Knopp iterations over the batch's and the
queue's scores, the swapped-prediction loss over every other crop. Every
operation runs in the dtype of the parameters (float32 for the reference,
TF32 off). Each bottleneck block is recomputed in the backward
(``torch.utils.checkpoint``) so that 128 images of eight crops fit in
float32; the running statistics come from the first pass only.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def blocks(c: dict) -> List[Tuple[str, int, int, int, bool]]:
    """(name, in channels, width, stride, projection) of each bottleneck."""
    out, cin = [], c["width"]
    for stage, n in enumerate(c["stage_sizes"]):
        for b in range(n):
            f = c["width"] * 2 ** stage
            stride = 2 if stage > 0 and b == 0 else 1
            out.append((f"trunk.stage{stage}_block{b}", cin, f, stride,
                        cin != 4 * f or stride != 1))
            cin = 4 * f
    return out


def batch_norms(c: dict) -> List[Tuple[str, int]]:
    """(name, channels) of every batch norm, in forward order."""
    out = [("trunk.stem_bn", c["width"])]
    for name, _cin, f, _s, proj in blocks(c):
        out += [(f"{name}.reduce.bn", f), (f"{name}.conv3x3.bn", f),
                (f"{name}.expand.bn", 4 * f)]
        if proj:
            out.append((f"{name}.proj.bn", 4 * f))
    return out + [("head.proj_bn0", c["proj_dims"][1])]


def spec(c: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init kind, scale) of every parameter: lecun-normal
    kernels (a normal of variance 1 / fan-in truncated at two standard
    deviations), zero biases, batch-norm scale 1 and bias 0."""
    lecun = lambda fan_in: math.sqrt(1.0 / fan_in) / 0.87962566103423978
    out = []

    def conv(name, cin, cout, k):
        out.append((name + ".weight", (cout, cin, k, k), "trunc", lecun(cin * k * k)))

    def bn(name, n):
        out.extend([(name + ".weight", (n,), "ones", 0.0),
                    (name + ".bias", (n,), "zeros", 0.0)])

    conv("trunk.stem_conv", 3, c["width"], 7)
    bn("trunk.stem_bn", c["width"])
    for name, cin, f, _s, proj in blocks(c):
        for part, a, b, k in (("reduce", cin, f, 1), ("conv3x3", f, f, 3),
                              ("expand", f, 4 * f, 1)) + (
                                  (("proj", cin, 4 * f, 1),) if proj else ()):
            conv(f"{name}.{part}.conv", a, b, k)
            bn(f"{name}.{part}.bn", b)
    d = c["proj_dims"]
    for i, (a, b) in enumerate(zip(d[:-1], d[1:])):
        out += [(f"head.proj{i}.weight", (b, a), "trunc", lecun(a)),
                (f"head.proj{i}.bias", (b,), "zeros", 0.0)]
        if i < len(d) - 2:
            bn(f"head.proj_bn{i}", b)
    for h, k in enumerate(c["num_prototypes"]):
        out.append((f"head.prototypes{h}.weight", (k, d[-1]), "trunc", lecun(d[-1])))
    return out


def _bn(P, name, x, c):
    """Training-mode batch norm over every axis but the channels (1):
    the output and the (mean, biased variance) it used."""
    dims = [d for d in range(x.dim()) if d != 1]
    mean, mean2 = x.mean(dims), (x * x).mean(dims)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + c["bn_eps"])
         * P[name + ".weight"].view(shape) + P[name + ".bias"].view(shape))
    return y, (mean.detach(), var.detach())


def _conv_bn(P, name, x, stride, c, relu=True):
    w = P[name + ".conv.weight"]
    y, st = _bn(P, name + ".bn", F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2), c)
    return (F.relu(y) if relu else y), st


def _bottleneck(P, name, cin, f, stride, proj, c, x):
    y, s1 = _conv_bn(P, name + ".reduce", x, 1, c)
    y, s2 = _conv_bn(P, name + ".conv3x3", y, stride, c)
    y, s3 = _conv_bn(P, name + ".expand", y, 1, c, relu=False)
    stats = [s1, s2, s3]
    if proj:
        x, s4 = _conv_bn(P, name + ".proj", x, stride, c, relu=False)
        stats.append(s4)
    return (F.relu(x + y),) + tuple(t for st in stats for t in st)


def trunk(P, images, c):
    """Pooled features of NHWC ``images`` and the batch statistics of
    every trunk batch norm, in forward order."""
    x = images.permute(0, 3, 1, 2).contiguous().to(P["trunk.stem_conv.weight"].dtype)
    y, st = _bn(P, "trunk.stem_bn",
                F.conv2d(x, P["trunk.stem_conv.weight"], stride=2, padding=3), c)
    x = F.max_pool2d(F.relu(y), 3, 2, padding=1)
    stats = [st]
    for name, cin, f, stride, proj in blocks(c):
        out = checkpoint(_bottleneck, P, name, cin, f, stride, proj, c, x,
                         use_reentrant=False)
        x = out[0]
        stats += [(out[i], out[i + 1]) for i in range(1, len(out), 2)]
    return x.mean((2, 3)), stats


@torch.no_grad()
def sinkhorn(scores, iters: int, eps: float):
    """Sinkhorn-Knopp: rows (samples) of exp(scores / eps) balanced so the
    prototypes share the mass equally and each sample sums to 1."""
    q = torch.exp(scores / eps - (scores / eps).max()).t()
    k, n = q.shape
    q = q / q.sum()
    for _ in range(iters):
        q = q / (k * torch.clamp_min(q.sum(dim=1, keepdim=True), 1e-12))
        q = q / (n * torch.clamp_min(q.sum(dim=0, keepdim=True), 1e-12))
    q = q / torch.clamp_min(q.sum(dim=0, keepdim=True), 1e-12)
    return q.t()


class Model:
    """The SwAV step's model side with its running statistics and queue,
    which move with every micro-batch."""

    def __init__(self, c: dict, stats: Dict[str, torch.Tensor],
                 queue: torch.Tensor):
        self.c = c
        self.stats = dict(stats)
        self.stats0 = {k: v.clone() for k, v in stats.items()}
        self.queue = queue

    def loss(self, P, crops: List[torch.Tensor], global_step: int):
        c = self.c
        m = c["bn_momentum"]
        new = dict(self.stats)
        trunk_bns = [name for name, _n in batch_norms(c)][:-1]
        feats = []
        for group in crops:
            f, stats = trunk(P, group, c)
            feats.append(f)
            for name, (mean, var) in zip(trunk_bns, stats):
                new[name + ".mean"] = m * new[name + ".mean"] + (1 - m) * mean
                new[name + ".var"] = m * new[name + ".var"] + (1 - m) * var
        x = torch.cat(feats, 0)
        d = c["proj_dims"]
        for i in range(len(d) - 1):
            x = F.linear(x, P[f"head.proj{i}.weight"], P[f"head.proj{i}.bias"])
            if i == len(d) - 2:
                break
            x, (mean, var) = _bn(P, f"head.proj_bn{i}", x, c)
            name = f"head.proj_bn{i}"
            new[name + ".mean"] = m * new[name + ".mean"] + (1 - m) * mean
            new[name + ".var"] = m * new[name + ".var"] + (1 - m) * var
            x = F.relu(x)
        emb = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)
        n_crops, assign = c["num_crops"], c["crops_for_assign"]
        bs = emb.shape[0] // n_crops
        total = 0.0
        heads = len(c["num_prototypes"])
        for h in range(heads):
            protos = P[f"head.prototypes{h}.weight"]
            scores = emb @ protos.t()
            with torch.no_grad():
                queued = self.queue.to(protos.dtype) @ protos.t()  # [crops, Q, K]
            head = 0.0
            for i, crop in enumerate(assign):
                own = scores[bs * crop:bs * (crop + 1)]
                q = sinkhorn(torch.cat([own.detach(), queued[i]], 0),
                             c["sinkhorn_iters"], c["epsilon"])[:bs]
                others = [p for p in range(n_crops) if p != crop]
                crop_loss = 0.0
                for p in others:
                    logp = torch.log_softmax(scores[bs * p:bs * (p + 1)] / c["temperature"], 1)
                    crop_loss = crop_loss - (q * logp).sum(1).mean()
                head = head + crop_loss / len(others)
            total = total + head / len(assign)
        loss = total / heads
        if global_step < c["freeze_prototypes_steps"]:
            raise ValueError("the benchmark runs past the prototype freeze")
        fresh = torch.stack([emb[bs * a:bs * (a + 1)] for a in assign]).detach()

        def commit():
            self.stats = new
            self.queue = torch.cat([fresh.to(self.queue.dtype), self.queue],
                                   1)[:, :self.queue.shape[1]]

        return loss, commit

    def state_change(self) -> Dict[str, torch.Tensor]:
        return {k: self.stats[k].float() - self.stats0[k].float() for k in self.stats}
