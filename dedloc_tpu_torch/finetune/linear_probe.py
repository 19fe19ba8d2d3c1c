"""Linear evaluation of a self-supervised trunk (the SwAV quality anchor).

Port of ``dedloc_tpu/finetune/linear_probe.py``: extract features from the
frozen ResNet trunk in eval mode (vissl ``extract_main`` capability) and
train a linear classifier on them, scoring top-1/top-5 accuracy. The trunk
comes from a SwAV checkpoint: only the ``trunk`` params and running
statistics are consumed, the head is discarded.

The probe is the JAX package's softmax regression on cached features: zero
init, then per step ``g + weight_decay * w`` and SGD with momentum (optax's
``add_decayed_weights`` then ``sgd``), over the same numpy permutation of
the training set. It runs on the features' device (the card unless
``device`` names another).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from dedloc_tpu_torch.utils.device import DeviceLike, divide, resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class LinearProbeArguments:
    learning_rate: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-6
    num_epochs: int = 10
    batch_size: int = 64
    seed: int = 0


class TopKMeter:
    """Streaming top-k accuracy meter (vissl AccuracyListMeter capability)."""

    def __init__(self, ks: Tuple[int, ...] = (1, 5)):
        self.ks = ks
        self.correct = {k: 0 for k in ks}
        self.total = 0

    def update(self, logits: np.ndarray, labels: np.ndarray) -> None:
        order = np.argsort(-logits, axis=-1)
        for k in self.ks:
            topk = order[:, :k]
            self.correct[k] += int((topk == labels[:, None]).any(axis=1).sum())
        self.total += len(labels)

    def value(self) -> Dict[str, float]:
        return {
            f"top_{k}": self.correct[k] / max(1, self.total) for k in self.ks
        }


@torch.no_grad()
def extract_features(trunk_apply, images: np.ndarray, batch_size: int = 64,
                     device: DeviceLike = None) -> np.ndarray:
    """Frozen-trunk features of NHWC ``images`` over batches of
    ``batch_size`` (the last one padded with image 0 and cut after, as the
    JAX version pads to its compiled shape). ``trunk_apply(images) ->
    [B, D]`` is the eval-mode trunk (``swav_trunk_apply``)."""
    dev = resolve_device(device)
    n = len(images)
    feats = []
    for i in range(0, n, batch_size):
        idx = np.arange(i, min(i + batch_size, n))
        real = len(idx)
        if real < batch_size:
            idx = np.concatenate([idx, np.zeros(batch_size - real, np.int64)])
        out = trunk_apply(torch.as_tensor(images[idx]).to(dev))
        feats.append(out.float().cpu().numpy()[:real])
    return np.concatenate(feats, axis=0)


def swav_trunk_apply(model, params: Mapping[str, torch.Tensor],
                     batch_stats: Mapping[str, torch.Tensor]):
    """The frozen eval-mode trunk forward of a SwAV state: only the
    ``trunk`` params and running statistics are consumed."""
    trunk_params = {k[len("trunk."):]: v for k, v in params.items()
                    if k.startswith("trunk.")}
    trunk_stats = {k: v for k, v in batch_stats.items() if k.startswith("trunk.")}

    def apply(images):
        feats, _ = functional_call(model.trunk, trunk_params,
                                   (images, trunk_stats, False))
        return feats

    return apply


def run_linear_probe(
    train_features: np.ndarray,  # [N, D]
    train_labels: np.ndarray,  # [N]
    eval_features: np.ndarray,
    eval_labels: np.ndarray,
    num_classes: int,
    args: Optional[LinearProbeArguments] = None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Train the linear classifier on frozen features; return top-1/top-5.
    Weight decay then SGD with momentum on softmax regression, zero init."""
    args = args or LinearProbeArguments()
    dev = resolve_device(device)
    rng = np.random.default_rng(args.seed)
    d = train_features.shape[1]
    w = torch.zeros((d, num_classes), device=dev, requires_grad=True)
    b = torch.zeros((num_classes,), device=dev, requires_grad=True)
    trace = {"w": torch.zeros_like(w), "b": torch.zeros_like(b)}
    feats_all = torch.as_tensor(train_features, dtype=torch.float32).to(dev)
    labels_all = torch.as_tensor(train_labels).long().to(dev)

    n = len(train_features)
    bs = min(args.batch_size, n)
    for epoch in range(args.num_epochs):
        order = rng.permutation(n)
        losses = []
        for i in range(0, n - bs + 1, bs):
            idx = torch.as_tensor(order[i:i + bs]).to(dev)
            feats, labels = feats_all[idx], labels_all[idx]
            logp = torch.log_softmax(feats @ w + b, dim=-1)
            loss = -divide(logp.gather(1, labels[:, None]).sum(), bs)
            gw, gb = torch.autograd.grad(loss, (w, b))
            with torch.no_grad():
                for name, p, g in (("w", w, gw), ("b", b, gb)):
                    g = g + args.weight_decay * p  # add_decayed_weights
                    trace[name] = g + args.momentum * trace[name]  # sgd trace
                    p.add_(-args.learning_rate * trace[name])
            losses.append(loss.detach())
        logger.info(
            "linear probe epoch %d: loss %.4f", epoch,
            float(torch.stack(losses).mean()) if losses else float("nan"),
        )

    meter = TopKMeter(ks=(1, min(5, num_classes)))
    with torch.no_grad():
        eval_feats = torch.as_tensor(eval_features, dtype=torch.float32).to(dev)
        logits = (eval_feats @ w + b).cpu().numpy()
    meter.update(logits, eval_labels)
    result = meter.value()
    logger.info("linear probe eval: %s", result)
    return result
