"""SwAV in PyTorch: the prototypes head, the sinkhorn assignment, the
swapped-prediction loss, the embedding queue, the prototype hooks and the
step builders.

Port of ``dedloc_tpu/models/swav.py``. Parameters and running statistics
are dicts keyed by the port's module paths (``trunk.stem_conv.weight``,
``head.prototypes0.weight``, ``trunk.stem_bn.mean``); ``models/convert.py``
maps them to the JAX names. A prototype layer is a bias-free ``Linear``
``[K, D]``, so each prototype is a ROW here (a column of the JAX kernel
``[D, K]``).

Every division by a Python number (``/ epsilon``, ``/ temperature``, the
averages over crops and heads) goes through ``utils/device.py``
``divide``, which keeps it an IEEE division on CUDA.

**The slice.** With a ``mesh`` (``parallel/mesh.py``; the JAX step's
``mesh=``, crops sharded over ``data``) the peer is N ranks and each holds
B/N of the slice's B images with all their crops (``local_crops``): the
same rows as JAX's ``P("data")`` cut of each crop-major group, in another
partition, which keeps every swapped-prediction pair on one rank. The
global function stays the one-device one, so the ranks insert what GSPMD
inserts for JAX:

- every batch norm's statistics over the slice (``models/resnet.py``);
- the sinkhorn's global max, total and prototype (row) sums and its global
  row count as all-reduces; the column sums are per sample and stay
  local; the queue's rows are split among the ranks, each counted once;
- the loss as a ``psum`` of this rank's sums over a ``psum`` of its row
  counts, so a rank's backward gives the part of each gradient that comes
  from its own images (``Slice.full_grads`` sums the parts);
- the queue shifts in the slice's assignment-crop embeddings in global row
  order (an all-gather), so it stays bitwise equal on every rank.
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
from dedloc_tpu_torch.parallel.mesh import all_gather, all_reduce, pmax, psum
from dedloc_tpu_torch.parallel.train_step import TrainState, reduce_grads
from dedloc_tpu_torch.telemetry.steps import in_region, region
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

    def __init__(self, cfg: SwAVConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        dims = list(cfg.proj_dims)
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"proj{i}", nn.Linear(d_in, d_out))
            if cfg.use_bn_in_head and i < len(dims) - 2:
                self.add_module(f"proj_bn{i}", BatchNorm(d_out, 0.9, 1e-5, mesh))
        for i, k in enumerate(cfg.num_prototypes):
            self.add_module(f"prototypes{i}", nn.Linear(dims[-1], k, bias=False))

    @in_region("head")
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
                x = getattr(self, f"proj_bn{i}")(x, stats, train, relu=True)
            else:
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
    per head ``[B * num_crops, K]``, new batch_stats). With a slice
    ``mesh`` the crops are this rank's (``local_crops``) and the batch
    norms' statistics the slice's."""

    def __init__(self, cfg: SwAVConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.trunk = ResNet(cfg.trunk, mesh)
        self.head = SwAVPrototypesHead(cfg, mesh)
        name_batch_norms(self)

    def forward(self, crops: Sequence[torch.Tensor], batch_stats: Stats,
                train: bool = True):
        stats = dict(batch_stats)
        feats = torch.cat([self.trunk.features(c, stats, train) for c in crops], 0)
        emb, scores = self.head(feats, stats, train)
        return emb, scores, stats


# ----------------------------------------------------------------- sinkhorn


def _sliced(mesh) -> bool:
    return mesh is not None and mesh.group("data") is not None


@in_region("sinkhorn")
@torch.no_grad()
def sinkhorn_knopp(scores: torch.Tensor, num_iters: int = 3,
                   epsilon: float = 0.05, hard: bool = False,
                   mesh=None) -> torch.Tensor:
    """Sinkhorn-knopp assignment of ``scores`` ``[N, K]`` (rows: samples,
    the peer's batch and its queue) to ``[N, K]`` probabilities whose rows
    sum to 1; no gradient. With a slice ``mesh``, ``scores`` are this
    rank's rows of the slice's matrix: the max, the total, the prototype
    sums and the row count ``n`` are the slice's (all-reduced over
    ``data``), the sample sums this rank's own."""
    scores = scores.float()
    n, k = scores.shape
    scaled = divide(scores, epsilon)
    q = torch.exp(scaled - pmax(scaled.max(), mesh, "data"))  # global max
    q = q.t()  # [K, N], the paper's Q
    if _sliced(mesh):
        total_n = all_reduce(torch.stack([q.sum(), q.new_tensor(float(n))]),
                             mesh, "data")
        total, n = total_n[0], total_n[1]
    else:
        total = q.sum()
    q = q / torch.clamp_min(total, 1e-12)
    for _ in range(num_iters):
        u = q.sum(dim=1, keepdim=True)
        if _sliced(mesh):
            u = all_reduce(u, mesh, "data")
        u = torch.clamp_min(u, 1e-12)
        q = q / (k * u)  # prototypes to 1/K
        v = torch.clamp_min(q.sum(dim=0, keepdim=True), 1e-12)
        q = q / (n * v)  # samples to 1/N
    q = q / torch.clamp_min(q.sum(dim=0, keepdim=True), 1e-12)
    assignments = q.t()
    if hard:
        assignments = F.one_hot(assignments.argmax(dim=1), k).float()
    return assignments


# --------------------------------------------------------------------- loss


def queue_rows(q: int, mesh) -> slice:
    """The rows of a ``q``-row queue this rank brings to the slice's
    sinkhorn (all of them without a slice): a contiguous 1/N share, so
    each queued row is counted once."""
    if not _sliced(mesh):
        return slice(0, q)
    n, r = mesh.axis_size("data"), mesh.axis_index("data")
    return slice(r * q // n, (r + 1) * q // n)


@in_region("loss")
def swav_loss(scores: Sequence[torch.Tensor], cfg: SwAVConfig,
              queue_scores: Optional[torch.Tensor] = None,
              use_queue: bool = False,
              hard_assignment: bool = False, mesh=None) -> torch.Tensor:
    """Swapped-prediction loss over every prototype head: ``scores[h]``
    ``[num_crops * B, K_h]`` (crops stacked in crop order), ``queue_scores``
    ``[num_heads, len(crops_for_assign), Q, K]`` (against the current
    prototypes). Queued rows only join the assignment; the loss is over the
    live batch, averaged over predicted crops, assignment crops and heads.

    With a slice ``mesh`` the scores are this rank's images' (B/N per
    crop) and the queue is whole on every rank: the sinkhorn takes this
    rank's ``queue_rows``, and the loss is the slice's, this rank's sums
    over every term ``psum``-ed over the slice's row count."""
    sliced = _sliced(mesh)
    total = None
    for h, s in enumerate(scores):
        bs = s.shape[0] // cfg.num_crops
        head_loss = None
        for i, crop_id in enumerate(cfg.crops_for_assign):
            crop_scores = s[bs * crop_id:bs * (crop_id + 1)]
            assign_in = crop_scores
            if use_queue and queue_scores is not None:
                queued = queue_scores[h, i]
                assign_in = torch.cat(
                    [crop_scores, queued[queue_rows(queued.shape[0], mesh)]], 0)
            assignments = sinkhorn_knopp(assign_in, cfg.sinkhorn_iters,
                                         cfg.epsilon, hard=hard_assignment,
                                         mesh=mesh)[:bs]
            pred_crops = [p for p in range(cfg.num_crops) if p != crop_id]
            crop_loss = None
            for p in pred_crops:
                logp = torch.log_softmax(
                    divide(s[bs * p:bs * (p + 1)], cfg.temperature), dim=1)
                term = (assignments * logp).sum(dim=1).sum()
                if not sliced:
                    term = divide(term, bs)
                crop_loss = -term if crop_loss is None else crop_loss - term
            crop_loss = divide(crop_loss, len(pred_crops))
            head_loss = crop_loss if head_loss is None else head_loss + crop_loss
        head_loss = divide(head_loss, len(cfg.crops_for_assign))
        total = head_loss if total is None else total + head_loss
    total = divide(total, len(scores))
    if not sliced:
        return total
    rows = scores[0].shape[0] // cfg.num_crops
    sums = psum(torch.stack([total, total.new_tensor(float(rows))]), mesh, "data")
    return sums[0] / sums[1].detach()


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

    @in_region("queue")
    def update(self, embeddings: torch.Tensor, cfg: SwAVConfig,
               mesh=None) -> "SwAVQueue":
        """Shift in this step's assignment-crop embeddings
        (``queue[bs:] = queue[:-bs]; queue[:bs] = new``); with a slice
        ``mesh``, the slice's, gathered from the ranks in global row
        order."""
        bs = embeddings.shape[0] // cfg.num_crops
        q = self.embeddings.shape[1]
        fresh = torch.stack([embeddings[bs * c:bs * (c + 1)]
                             for c in cfg.crops_for_assign]).detach()
        if _sliced(mesh):
            fresh = all_gather(fresh, mesh, "data", dim=1)
        return SwAVQueue(torch.cat([fresh, self.embeddings], 1)[:, :q].contiguous())

    @in_region("queue")
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


def _check_mesh(model: SwAVModel, mesh) -> None:
    if mesh is not getattr(model, "mesh", None):
        raise ValueError("the step's mesh must be the one the model was built "
                         "with (SwAVModel(cfg, mesh))")


def _loss_and_grads(model: SwAVModel, cfg: SwAVConfig, params, batch_stats,
                    queue: Optional[SwAVQueue], crops, use_queue: bool,
                    mesh=None):
    with region("fwd"):
        queue_scores = (queue.scores(params, cfg)
                        if use_queue and queue is not None else None)
        emb, scores, new_bs = functional_call(model, params,
                                              (crops, batch_stats, True))
        loss = swav_loss(scores, cfg, queue_scores, use_queue=use_queue, mesh=mesh)
    names = list(params)
    with region("bwd"):
        grads = torch.autograd.grad(loss, [params[n] for n in names])
    return loss.detach(), dict(zip(names, grads)), new_bs, emb.detach()


def make_swav_accumulate_step(model: SwAVModel, cfg: SwAVConfig, mesh=None):
    """The collaborative step, per micro-batch: (params, batch_stats, queue,
    grad_acc, n_acc, crops, global_step, use_queue) -> (grad_acc, n_acc + 1,
    batch_stats', queue', metrics).

    The gradients (prototypes frozen by the GLOBAL step) are SUMMED into the
    fp32 ``grad_acc`` in place; the running statistics and the queue are
    the peer's own and move every micro-batch. ``crops`` are NHWC tensors
    on the params' device.

    With a slice ``mesh`` (the model's) the crops are this rank's
    (``local_crops``), the loss is the slice's, and ``grad_acc`` sums this
    rank's part of each gradient: ``Slice.full_grads`` (or
    ``train_step.reduce_grads``) sums the parts over the ranks. The
    running statistics and the queue are the slice's, the same on every
    rank."""
    _check_mesh(model, mesh)

    def step(params, batch_stats, queue, grad_acc, n_acc, crops, global_step,
             use_queue: bool):
        loss, grads, new_bs, emb = _loss_and_grads(
            model, cfg, params, batch_stats, queue, crops, use_queue, mesh)
        with torch.no_grad(), region("accumulate"):
            grads = freeze_prototypes_grads(grads, global_step,
                                            cfg.freeze_prototypes_steps)
            for n, g in grads.items():
                grad_acc[n].add_(g.float())
        new_queue = queue.update(emb, cfg, mesh) if queue is not None else None
        return grad_acc, n_acc + 1, new_bs, new_queue, {"loss": loss}

    return step


def make_swav_train_step(model: SwAVModel, cfg: SwAVConfig, tx, mesh=None):
    """The local fused step: (state, crops, use_queue) -> (state',
    metrics). Forward with the running statistics updated, the loss (with
    the queue), the prototype freeze, the optimizer update (params updated
    in place), the prototype re-normalisation and the queue shift-in. With
    a slice ``mesh`` (the model's) the ranks' parts of the gradients are
    summed before the update, which every rank then computes alike on its
    replicated state."""
    _check_mesh(model, mesh)

    def train_step(state: SwAVTrainState, crops, use_queue: bool):
        loss, grads, new_bs, emb = _loss_and_grads(
            model, cfg, state.params, state.batch_stats, state.queue, crops,
            use_queue, mesh)
        if _sliced(mesh):
            grads = reduce_grads(grads, mesh)
        grads = freeze_prototypes_grads(grads, state.step,
                                        cfg.freeze_prototypes_steps)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        with torch.no_grad():
            for n, p in state.params.items():
                p.add_(updates[n])
            for n, w in normalize_prototypes(state.params).items():
                if w is not state.params[n]:
                    state.params[n].copy_(w)
        new_queue = (state.queue.update(emb, cfg, mesh)
                     if state.queue is not None else None)
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


def init_swav(cfg: SwAVConfig, seed: int, device, mesh=None) -> tuple:
    """(model, params, batch_stats) with flax's initialisers drawn from
    ``seed`` on the CPU, moved to ``device`` (every rank of a slice draws
    the same weights)."""
    from dedloc_tpu_torch.models.resnet import init_batch_stats, init_weights

    model = SwAVModel(cfg, mesh)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device)
    return model, dict(model.named_parameters()), init_batch_stats(model)


def local_crops(crops: Sequence[np.ndarray], batch: int, mesh) -> List[np.ndarray]:
    """This rank's part of the slice's crop groups: each group is
    ``[count * batch, H, W, C]``, crop-major, and a rank keeps images
    ``[r * batch / N, (r + 1) * batch / N)`` of every crop (``r`` its
    ``data`` index), still crop-major. Without a slice, the crops."""
    if not _sliced(mesh):
        return list(crops)
    n, r = mesh.axis_size("data"), mesh.axis_index("data")
    if batch % n:
        raise ValueError(f"a slice batch of {batch} images does not split "
                         f"over {n} data ranks")
    lo, hi = r * batch // n, (r + 1) * batch // n
    out = []
    for c in crops:
        c = np.asarray(c)
        groups = c.reshape(c.shape[0] // batch, batch, *c.shape[1:])
        out.append(np.ascontiguousarray(groups[:, lo:hi]).reshape(-1, *c.shape[1:]))
    return out


@in_region("h2d")
def crop_tensors(crops: Sequence[np.ndarray], device, batch: Optional[int] = None,
                 mesh=None) -> List[torch.Tensor]:
    """The pipeline's NHWC float32 crop groups as tensors on ``device``;
    with a slice ``mesh``, this rank's part of the slice's ``batch``
    images (``local_crops``)."""
    if _sliced(mesh):
        crops = local_crops(crops, batch, mesh)
    return [torch.as_tensor(c).to(device) for c in crops]
