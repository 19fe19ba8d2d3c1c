"""Synthetic multicrop batches from a seed.

A frozen copy of the port's ``data/multicrop.py``
``synthetic_multicrop_batches``: each image is a class-free mean plus
noise and its crops share the mean, as augmented views of one image
agree. One NHWC float32 array ``[count * B, size, size, 3]`` per
resolution group, crop-major, in crop order. Numpy on the host.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


def synthetic_multicrop_batches(sizes: Sequence[int], counts: Sequence[int],
                                batch_size: int, seed: int, channels: int = 3
                                ) -> Iterator[List[np.ndarray]]:
    rng = np.random.default_rng(seed)
    while True:
        means = rng.standard_normal((batch_size, 1, 1, channels)) * 0.5
        groups: List[np.ndarray] = []
        for size, count in zip(sizes, counts):
            views = []
            for _ in range(count):
                noise = rng.standard_normal(
                    (batch_size, size, size, channels)).astype(np.float32) * 0.1
                views.append((means + noise).astype(np.float32))
            groups.append(np.concatenate(views, axis=0))
        yield groups


def pool(traffic: dict, config: dict, seed: int) -> list:
    """``traffic["pool"]`` batches of ``micro_batch`` images at the
    configuration's crop sizes and counts."""
    gen = synthetic_multicrop_batches(config["crop_sizes"], config["crop_counts"],
                                      traffic["micro_batch"], seed % 2 ** 63)
    return [next(gen) for _ in range(traffic["pool"])]
