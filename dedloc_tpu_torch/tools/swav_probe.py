"""SwAV sustained-run harness over the port: texture dataset generation +
linear probe (the counterpart of ``tools/swav_probe.py``).

Two subcommands around ``python -m dedloc_tpu_torch.roles.swav``:

``generate``
    Render a class-structured JPEG dataset (oriented sinusoidal gratings:
    class = (orientation, frequency); per-image random phase, colour mix,
    contrast and pixel noise). A random trunk's pooled features do not
    trivially separate these classes, so the linear-probe delta between a
    trained and a random trunk measures what SwAV pretraining learned.
    Layout: ``<out>/class_<k>/*.jpg`` (the class-subdir layout
    ``image_folder_multicrop_batches`` accepts). ``texture_image``,
    ``class_params``, ``generate`` and ``_labeled_split`` are verbatim
    copies of the reference tool's, so both packages train and probe on
    the same images.

``probe``
    Load the newest SwAV checkpoint from ``--checkpoint_dir``, extract
    frozen eval-mode trunk features for a held-out deterministic split of
    the same texture distribution, train the linear classifier
    (``finetune/linear_probe.py``, the vissl extract+linear protocol), and
    print one JSON line with trained vs random-trunk top-1. It runs on the
    card unless ``DEDLOC_FORCE_CPU=1`` asks for the CPU.

The round-4 sustained run (BASELINE.md), on the card:

    python -m dedloc_tpu_torch.tools.swav_probe generate --out IMAGES
    python -m dedloc_tpu_torch.roles.swav \
        --dht.experiment_prefix swav_r4 \
        --training.image_folder IMAGES \
        --training.per_device_batch_size 16 \
        --optimizer.target_batch_size 16 \
        --training.learning_rate 0.15 --training.warmup_steps 200 \
        --training.total_steps 2500 --training.max_local_steps 700 \
        --training.queue_length 3840 --training.queue_start_step 400 \
        --training.save_steps 250 \
        --training.output_dir OUT
    python -m dedloc_tpu_torch.tools.swav_probe probe --checkpoint_dir OUT
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np


def texture_image(
    rng: np.random.Generator,
    orientation: float,
    frequency: float,
    size: int,
) -> np.ndarray:
    """One grating image [size, size, 3] in [0, 255] for a (orientation,
    frequency) class, with per-image nuisance randomness."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    phase = rng.uniform(0, 2 * np.pi)
    angle = orientation + rng.normal(0, 0.05)
    carrier = np.sin(
        2 * np.pi * frequency * (np.cos(angle) * xx + np.sin(angle) * yy)
        + phase
    )
    contrast = rng.uniform(0.6, 1.0)
    base = rng.uniform(0.25, 0.75, size=3)  # random colour mix per image
    tint = rng.uniform(-0.25, 0.25, size=3)
    img = base[None, None, :] + contrast * 0.5 * carrier[..., None] * (
        0.6 + tint[None, None, :]
    )
    img += rng.normal(0, 0.04, img.shape)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def class_params(num_classes: int):
    """(orientation, frequency) grid: num_classes/2 orientations x 2 freqs."""
    n_orient = max(1, num_classes // 2)
    out = []
    for k in range(num_classes):
        orient = (k % n_orient) * np.pi / n_orient
        freq = 6.0 if k < n_orient else 14.0
        out.append((orient, freq))
    return out


def generate(args) -> None:
    from PIL import Image

    params = class_params(args.classes)
    rng = np.random.default_rng(args.seed)
    for k, (orient, freq) in enumerate(params):
        d = os.path.join(args.out, f"class_{k:02d}")
        os.makedirs(d, exist_ok=True)
        for i in range(args.per_class):
            arr = texture_image(rng, orient, freq, args.size)
            Image.fromarray(arr).save(
                os.path.join(d, f"img_{i:04d}.jpg"), quality=90
            )
    print(json.dumps({
        "generated": args.classes * args.per_class,
        "classes": args.classes, "size": args.size, "out": args.out,
    }))


def _labeled_split(num_classes: int, per_class: int, size: int, seed: int):
    """Deterministic held-out labelled images (NOT from the training files —
    fresh draws of the same distribution, the probe's train/eval data)."""
    params = class_params(num_classes)
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for k, (orient, freq) in enumerate(params):
        for _ in range(per_class):
            images.append(
                texture_image(rng, orient, freq, size).astype(np.float32)
                / 255.0
            )
            labels.append(k)
    order = rng.permutation(len(images))
    return (
        np.stack(images)[order],
        np.asarray(labels, np.int32)[order],
    )


def probe_checkpoint(checkpoint_dir: str, images: np.ndarray, labels: np.ndarray,
                     num_classes: int, cfg=None, seed: int = 0,
                     batch_size: int = 64, device=None, probe_args=None,
                     random_trunk: bool = True, train_share: float = 0.8) -> dict:
    """The linear probe of the newest checkpoint under ``checkpoint_dir``
    (and, with ``random_trunk``, of a trunk drawn from ``seed``): frozen
    eval-mode trunk features of ``images`` [N, H, W, 3] in [0, 1], the
    classifier trained on the first ``train_share`` of them and evaluated
    on the rest. Returns each trunk's top-k (``<tag>_top_<k>``), the
    checkpoint's step, the feature shape and the seconds of extraction."""
    from dedloc_tpu_torch.finetune.linear_probe import (
        extract_features,
        run_linear_probe,
        swav_trunk_apply,
    )
    from dedloc_tpu_torch.models.swav import SwAVConfig, init_swav
    from dedloc_tpu_torch.roles.swav import restore_checkpoint
    from dedloc_tpu_torch.utils.checkpoint import load_latest_checkpoint
    from dedloc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = cfg or SwAVConfig(queue_length=0)
    n_train = int(train_share * len(images))
    out = {"checkpoint_dir": checkpoint_dir}

    def probe_for(model, params, batch_stats, tag):
        t0 = time.perf_counter()
        feats = extract_features(swav_trunk_apply(model, params, batch_stats),
                                 images, batch_size=batch_size, device=dev)
        out[f"{tag}_extract_s"] = time.perf_counter() - t0
        out[f"{tag}_features"] = list(feats.shape)
        out[f"{tag}_finite"] = bool(np.isfinite(feats).all())
        result = run_linear_probe(feats[:n_train], labels[:n_train],
                                  feats[n_train:], labels[n_train:],
                                  num_classes, probe_args, device=dev)
        out.update({f"{tag}_{k}": v for k, v in result.items()})
        return feats

    if random_trunk:
        # what the probe can do with an untrained trunk
        model, params, stats = init_swav(cfg, seed, dev)
        probe_for(model, params, stats, "random_trunk")
    loaded = load_latest_checkpoint(checkpoint_dir)
    if loaded is None:
        raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
    step, tree, _meta = loaded
    out["checkpoint_step"] = step
    model, params, stats = init_swav(cfg, seed, dev)
    stats = restore_checkpoint(tree, params, stats)
    out["features"] = probe_for(model, params, stats, "trained_trunk")
    return out


def probe(args) -> None:
    from dedloc_tpu_torch.roles.common import force_cpu_if_requested

    images, labels = _labeled_split(
        args.classes, args.probe_per_class, args.probe_size, args.seed + 777
    )
    from dedloc_tpu_torch.models.swav import SwAVConfig

    cfg = (SwAVConfig.tiny(queue_length=0) if args.model_size == "tiny"
           else SwAVConfig(queue_length=0))
    out = probe_checkpoint(args.checkpoint_dir, images, labels, args.classes,
                           cfg=cfg, seed=args.seed, batch_size=args.batch_size,
                           device=force_cpu_if_requested())
    out.pop("features")
    print(json.dumps(out))


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate")
    g.add_argument("--out", required=True)
    g.add_argument("--classes", type=int, default=24)
    g.add_argument("--per_class", type=int, default=120)
    g.add_argument("--size", type=int, default=224)
    g.add_argument("--seed", type=int, default=0)
    q = sub.add_parser("probe")
    q.add_argument("--checkpoint_dir", required=True)
    q.add_argument("--classes", type=int, default=24)
    q.add_argument("--probe_per_class", type=int, default=40)
    q.add_argument("--probe_size", type=int, default=128)
    q.add_argument("--batch_size", type=int, default=64)
    q.add_argument("--seed", type=int, default=0)
    # the trunk's size: the reference's ResNet-50 (full) or the test config
    q.add_argument("--model_size", choices=("full", "tiny"), default="full")
    args = p.parse_args(argv)
    if args.cmd == "generate":
        generate(args)
    else:
        probe(args)


if __name__ == "__main__":
    main()
