"""SwAV in PyTorch: the prototypes head, the sinkhorn assignment, the
swapped-prediction loss, the embedding queue, the prototype hooks and the
step builders.

Port of ``dedloc_tpu/models/swav.py``. Parameters and running statistics
are dicts keyed by the port's module paths (``trunk.stem_conv.weight``,
``head.prototypes0.weight``, ``trunk.stem_bn.mean``); ``models/convert.py``
maps them to the JAX names. A prototype layer is a bias-free ``Linear``
``[K, D]``, so each prototype is a ROW here (a column of the JAX kernel
``[D, K]``).

The sinkhorn runs on one device over the peer's batch (and its queue); its
``torch.distributed`` all-reduce across devices comes with the
parallel-axes slice. Every division by a Python number (``/ epsilon``,
``/ temperature``, the averages over crops and heads) goes through
``utils/device.py`` ``divide``, which keeps it an IEEE division on CUDA.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from dedloc_tpu_torch.models.resnet import (
    BatchNorm,
    ResNet,
    ResNetConfig,
    Stats,
    name_batch_norms,
)
from dedloc_tpu_torch.parallel.train_step import TrainState
from dedloc_tpu_torch.utils.device import divide


@dataclasses.dataclass(frozen=True)
class SwAVConfig:
    """swav_1node_resnet_submit.yaml defaults."""

    trunk: ResNetConfig = ResNetConfig.resnet50()
    proj_dims: Sequence[int] = (2048, 2048, 128)
    num_prototypes: Sequence[int] = (3000,)
    temperature: float = 0.1
    epsilon: float = 0.05
    sinkhorn_iters: int = 3
    num_crops: int = 8  # 2x224 + 6x96
    crops_for_assign: Sequence[int] = (0, 1)
    queue_length: int = 0  # per-peer feature queue (0 = disabled)
    queue_start_step: int = 0
    freeze_prototypes_steps: int = 313
    use_bn_in_head: bool = True

    @staticmethod
    def tiny(**overrides) -> "SwAVConfig":
        base = dict(
            trunk=ResNetConfig.tiny(),
            proj_dims=(256, 64, 16),
            num_prototypes=(32,),
            num_crops=4,
            freeze_prototypes_steps=0,
        )
        base.update(overrides)
        return SwAVConfig(**base)


class SwAVPrototypesHead(nn.Module):
    """Projection MLP (BN + ReLU between layers, none after the last) ->
    L2 normalize -> one bias-free Linear per prototype head, in fp32."""

    def __init__(self, cfg: SwAVConfig):
        super().__init__()
        self.cfg = cfg
        dims = list(cfg.proj_dims)
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"proj{i}", nn.Linear(d_in, d_out))
            if cfg.use_bn_in_head and i < len(dims) - 2:
                self.add_module(f"proj_bn{i}", BatchNorm(d_out, 0.9, 1e-5))
        for i, k in enumerate(cfg.num_prototypes):
            self.add_module(f"prototypes{i}", nn.Linear(dims[-1], k, bias=False))

    def forward(self, features: torch.Tensor, stats: Stats, train: bool):
        cfg = self.cfg
        x = features.float()
        n_layers = len(cfg.proj_dims) - 1
        for i in range(n_layers):
            proj = getattr(self, f"proj{i}")
            x = F.linear(x, proj.weight, proj.bias)
            if i == n_layers - 1:
                break  # skip_last_bn
            if cfg.use_bn_in_head:
                x = getattr(self, f"proj_bn{i}")(x, stats, train)
            x = F.relu(x)
        # L2 normalize the embeddings before clustering
        norm = torch.sqrt((x * x).sum(-1, keepdim=True))
        x = x / torch.clamp_min(norm, 1e-12)
        scores = [F.linear(x, getattr(self, f"prototypes{i}").weight)
                  for i in range(len(cfg.num_prototypes))]
        return x, scores


class SwAVModel(nn.Module):
    """Trunk + head over a multicrop batch: ``crops`` is a list of NHWC
    ``[count * B, H_i, W_i, C]`` tensors, one per crop-resolution group;
    the trunk runs once per group (each call reading the running statistics
    the previous one wrote) and the features are concatenated in crop
    order. ``forward`` returns (embeddings ``[B * num_crops, D]``, scores
    per head ``[B * num_crops, K]``, new batch_stats)."""

    def __init__(self, cfg: SwAVConfig):
        super().__init__()
        self.cfg = cfg
        self.trunk = ResNet(cfg.trunk)
        self.head = SwAVPrototypesHead(cfg)
        name_batch_norms(self)

    def forward(self, crops: Sequence[torch.Tensor], batch_stats: Stats,
                train: bool = True):
        stats = dict(batch_stats)
        feats = torch.cat([self.trunk.features(c, stats, train) for c in crops], 0)
        emb, scores = self.head(feats, stats, train)
        return emb, scores, stats


# ----------------------------------------------------------------- sinkhorn


@torch.no_grad()
def sinkhorn_knopp(scores: torch.Tensor, num_iters: int = 3,
                   epsilon: float = 0.05, hard: bool = False) -> torch.Tensor:
    """Sinkhorn-knopp assignment of ``scores`` ``[N, K]`` (rows: samples,
    the peer's batch and its queue) to ``[N, K]`` probabilities whose rows
    sum to 1; no gradient."""
    scores = scores.float()
    n, k = scores.shape
    scaled = divide(scores, epsilon)
    q = torch.exp(scaled - scaled.max())  # stabilise by the global max
    q = q.t()  # [K, N], the paper's Q
    q = q / torch.clamp_min(q.sum(), 1e-12)
    for _ in range(num_iters):
        u = torch.clamp_min(q.sum(dim=1, keepdim=True), 1e-12)
        q = q / (k * u)  # prototypes to 1/K
        v = torch.clamp_min(q.sum(dim=0, keepdim=True), 1e-12)
        q = q / (n * v)  # samples to 1/N
    q = q / torch.clamp_min(q.sum(dim=0, keepdim=True), 1e-12)
    assignments = q.t()
    if hard:
        assignments = F.one_hot(assignments.argmax(dim=1), k).float()
    return assignments


# --------------------------------------------------------------------- loss


def swav_loss(scores: Sequence[torch.Tensor], cfg: SwAVConfig,
              queue_scores: Optional[torch.Tensor] = None,
              use_queue: bool = False,
              hard_assignment: bool = False) -> torch.Tensor:
    """Swapped-prediction loss over every prototype head: ``scores[h]``
    ``[num_crops * B, K_h]`` (crops stacked in crop order), ``queue_scores``
    ``[num_heads, len(crops_for_assign), Q, K]`` (against the current
    prototypes). Queued rows only join the assignment; the loss is over the
    live batch, averaged over predicted crops, assignment crops and heads."""
    total = None
    for h, s in enumerate(scores):
        bs = s.shape[0] // cfg.num_crops
        head_loss = None
        for i, crop_id in enumerate(cfg.crops_for_assign):
            crop_scores = s[bs * crop_id:bs * (crop_id + 1)]
            assign_in = crop_scores
            if use_queue and queue_scores is not None:
                assign_in = torch.cat([crop_scores, queue_scores[h, i]], 0)
            assignments = sinkhorn_knopp(assign_in, cfg.sinkhorn_iters,
                                         cfg.epsilon, hard=hard_assignment)[:bs]
            pred_crops = [p for p in range(cfg.num_crops) if p != crop_id]
            crop_loss = None
            for p in pred_crops:
                logp = torch.log_softmax(
                    divide(s[bs * p:bs * (p + 1)], cfg.temperature), dim=1)
                term = divide((assignments * logp).sum(dim=1).sum(), bs)
                crop_loss = -term if crop_loss is None else crop_loss - term
            crop_loss = divide(crop_loss, len(pred_crops))
            head_loss = crop_loss if head_loss is None else head_loss + crop_loss
        head_loss = divide(head_loss, len(cfg.crops_for_assign))
        total = head_loss if total is None else total + head_loss
    return divide(total, len(scores))


# -------------------------------------------------------------------- queue


@dataclasses.dataclass
class SwAVQueue:
    """Embedding queue per assignment crop, newest first:
    ``embeddings`` ``[len(crops_for_assign), Q, D]``. Functional: ``update``
    returns a new queue."""

    embeddings: torch.Tensor

    @classmethod
    def create(cls, cfg: SwAVConfig, generator: torch.Generator,
               device=None) -> "SwAVQueue":
        """Uniform in +-1/sqrt(D/3), drawn on the CPU ``generator``."""
        d = cfg.proj_dims[-1]
        stdv = float(np.float32(1.0) / np.sqrt(np.float32(d / 3.0)))
        shape = (len(cfg.crops_for_assign), cfg.queue_length, d)
        emb = torch.rand(shape, generator=generator) * (2 * stdv) - stdv
        return cls(embeddings=emb.to(device) if device is not None else emb)

    def update(self, embeddings: torch.Tensor, cfg: SwAVConfig) -> "SwAVQueue":
        """Shift in this step's assignment-crop embeddings
        (``queue[bs:] = queue[:-bs]; queue[:bs] = new``)."""
        bs = embeddings.shape[0] // cfg.num_crops
        q = self.embeddings.shape[1]
        fresh = torch.stack([embeddings[bs * c:bs * (c + 1)]
                             for c in cfg.crops_for_assign]).detach()
        return SwAVQueue(torch.cat([fresh, self.embeddings], 1)[:, :q].contiguous())

    @torch.no_grad()
    def scores(self, params: Dict[str, torch.Tensor], cfg: SwAVConfig) -> torch.Tensor:
        """Queue scores against the CURRENT prototypes:
        ``[num_heads, len(crops_for_assign), Q, K]``."""
        return torch.stack([
            torch.einsum("cqd,kd->cqk", self.embeddings,
                         params[f"head.prototypes{h}.weight"])
            for h in range(len(cfg.num_prototypes))])


# -------------------------------------------------------------------- hooks


def _is_prototype(name: str) -> bool:
    return any(part.startswith("prototypes") for part in name.split("."))


def normalize_prototypes(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """L2-normalise each prototype (a row of the ``[K, D]`` weight): a new
    dict, the other tensors as they were."""
    out = dict(params)
    for name, w in params.items():
        if _is_prototype(name) and name.endswith(".weight"):
            norm = torch.sqrt((w * w).sum(dim=1, keepdim=True))
            out[name] = w / torch.clamp_min(norm, 1e-12)
    return out


def freeze_prototypes_grads(grads: Dict[str, torch.Tensor], step: int,
                            freeze_steps: int) -> Dict[str, torch.Tensor]:
    """Zero the prototype gradients for the first ``freeze_steps`` GLOBAL
    steps (the collaboration's step, a host int)."""
    if step >= freeze_steps:
        return dict(grads)
    return {n: torch.zeros_like(g) if _is_prototype(n) else g
            for n, g in grads.items()}


# --------------------------------------------------------------- train step


@dataclasses.dataclass
class SwAVTrainState:
    """The local fused step's state, keyed by the GLOBAL step."""

    step: Any
    params: Dict[str, torch.nn.Parameter]
    batch_stats: Stats
    opt_state: Any
    queue: Optional[SwAVQueue] = None


def _loss_and_grads(model: SwAVModel, cfg: SwAVConfig, params, batch_stats,
                    queue: Optional[SwAVQueue], crops, use_queue: bool):
    queue_scores = (queue.scores(params, cfg)
                    if use_queue and queue is not None else None)
    emb, scores, new_bs = functional_call(model, params, (crops, batch_stats, True))
    loss = swav_loss(scores, cfg, queue_scores, use_queue=use_queue)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    return loss.detach(), dict(zip(names, grads)), new_bs, emb.detach()


def make_swav_accumulate_step(model: SwAVModel, cfg: SwAVConfig):
    """The collaborative step, per micro-batch: (params, batch_stats, queue,
    grad_acc, n_acc, crops, global_step, use_queue) -> (grad_acc, n_acc + 1,
    batch_stats', queue', metrics).

    The gradients (prototypes frozen by the GLOBAL step) are SUMMED into the
    fp32 ``grad_acc`` in place; the running statistics and the queue are
    the peer's own and move every micro-batch. ``crops`` are NHWC tensors
    on the params' device."""

    def step(params, batch_stats, queue, grad_acc, n_acc, crops, global_step,
             use_queue: bool):
        loss, grads, new_bs, emb = _loss_and_grads(
            model, cfg, params, batch_stats, queue, crops, use_queue)
        grads = freeze_prototypes_grads(grads, global_step,
                                        cfg.freeze_prototypes_steps)
        with torch.no_grad():
            for n, g in grads.items():
                grad_acc[n].add_(g.float())
        new_queue = queue.update(emb, cfg) if queue is not None else None
        return grad_acc, n_acc + 1, new_bs, new_queue, {"loss": loss}

    return step


def make_swav_train_step(model: SwAVModel, cfg: SwAVConfig, tx):
    """The local fused step: (state, crops, use_queue) -> (state',
    metrics). Forward with the running statistics updated, the loss (with
    the queue), the prototype freeze, the optimizer update (params updated
    in place), the prototype re-normalisation and the queue shift-in."""

    def train_step(state: SwAVTrainState, crops, use_queue: bool):
        loss, grads, new_bs, emb = _loss_and_grads(
            model, cfg, state.params, state.batch_stats, state.queue, crops,
            use_queue)
        grads = freeze_prototypes_grads(grads, state.step,
                                        cfg.freeze_prototypes_steps)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        with torch.no_grad():
            for n, p in state.params.items():
                p.add_(updates[n])
            for n, w in normalize_prototypes(state.params).items():
                if w is not state.params[n]:
                    state.params[n].copy_(w)
        new_queue = state.queue.update(emb, cfg) if state.queue is not None else None
        return SwAVTrainState(step=state.step + 1, params=state.params,
                              batch_stats=new_bs, opt_state=new_opt,
                              queue=new_queue), {"loss": loss}

    return train_step


def make_prototype_post_apply():
    """``TrainState -> TrainState`` re-normalising the prototypes after
    every global update (``post_apply`` of the collaborative applies, which
    run it on the new params before their all-finite check)."""

    def post(state: TrainState) -> TrainState:
        return TrainState(step=state.step, params=normalize_prototypes(state.params),
                          opt_state=state.opt_state)

    return post


def init_swav(cfg: SwAVConfig, seed: int, device) -> tuple:
    """(model, params, batch_stats) with flax's initialisers drawn from
    ``seed`` on the CPU, moved to ``device``."""
    from dedloc_tpu_torch.models.resnet import init_batch_stats, init_weights

    model = SwAVModel(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device)
    return model, dict(model.named_parameters()), init_batch_stats(model)


def crop_tensors(crops: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """The pipeline's NHWC float32 crop groups as tensors on ``device``."""
    return [torch.as_tensor(c).to(device) for c in crops]
