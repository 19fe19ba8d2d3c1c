"""Analytic model FLOPs of one training sample, from shapes alone.

``albert_tflops_per_sample`` is a frozen copy of the port's
``telemetry/steps.py`` formula (matmuls only, the remat recompute not
counted). ``swav_flops_per_sample`` counts the ResNet-50 trunk's
convolutions over every crop, the projection head and the prototypes, and
adds the queue's scores against the prototypes once per step.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple


def albert_tflops_per_sample(hidden: int, intermediate: int, layers: int,
                             embedding: int, vocab: int, seq: int,
                             max_pred: int) -> float:
    """Model TFLOPs of one ALBERT forward+backward sample (3 x forward)."""
    h, i, s, e, v = hidden, intermediate, seq, embedding, vocab
    per_token_layer = 8 * h * h + 4 * h * s + 4 * h * i
    fwd = layers * per_token_layer * s
    fwd += 2 * e * h * s
    fwd += max_pred * 2 * (h * e + e * v)
    fwd += 2 * h * 2
    return 3.0 * fwd / 1e12


def resnet_convs(size: int, stage_sizes: Sequence[int], width: int
                 ) -> Iterator[Tuple[int, int, int, int]]:
    """(in channels, out channels, kernel, output side) of every
    convolution of the bottleneck ResNet on a ``size`` x ``size`` image:
    the 7x7/2 stem (padding 3), the 3x3/2 max pool, then each block's
    1x1 reduce, 3x3 (the block's stride), 1x1 expand and, where the shape
    changes, the 1x1 projection."""
    side = (size + 2 * 3 - 7) // 2 + 1
    yield 3, width, 7, side
    side = (side + 2 * 1 - 3) // 2 + 1
    cin = width
    for stage, blocks in enumerate(stage_sizes):
        for block in range(blocks):
            f = width * 2 ** stage
            stride = 2 if stage > 0 and block == 0 else 1
            out_side = (side + 2 * 1 - 3) // stride + 1
            yield cin, f, 1, side
            yield f, f, 3, out_side
            yield f, 4 * f, 1, out_side
            if cin != 4 * f or stride != 1:
                yield cin, 4 * f, 1, out_side
            cin, side = 4 * f, out_side


def conv_flops(size: int, stage_sizes: Sequence[int], width: int) -> float:
    """Forward FLOPs (2 per multiply-add) of the trunk's convolutions on
    one image."""
    return sum(2.0 * cin * cout * k * k * side * side
               for cin, cout, k, side in resnet_convs(size, stage_sizes, width))


def swav_flops_per_sample(sizes: Sequence[int], counts: Sequence[int],
                          stage_sizes: Sequence[int], width: int,
                          proj_dims: Sequence[int], prototypes: int,
                          queue_length: int, assign_crops: int,
                          batch: int) -> float:
    """Model FLOPs of one SwAV image: 3 x the forward of the trunk over its
    crops, the projection head and the prototypes per crop, plus its share
    of the queue's scores (a forward only, no gradient)."""
    crops = sum(counts)
    fwd = sum(c * conv_flops(s, stage_sizes, width) for s, c in zip(sizes, counts))
    head = sum(2.0 * a * b for a, b in zip(proj_dims[:-1], proj_dims[1:]))
    head += 2.0 * proj_dims[-1] * prototypes
    fwd += crops * head
    queue = 2.0 * assign_crops * queue_length * proj_dims[-1] * prototypes
    return 3.0 * fwd + queue / batch
