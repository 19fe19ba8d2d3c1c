"""Flat-segment LAMB / LARS: the optimizer math over ONE flat buffer.

Port of ``dedloc_tpu/optim/flat.py``. The averaging path lives on a flat
fp32 vector in the sorted-name ``TreeLayout`` order of the JAX wire names;
``FlatLamb`` runs the whole LAMB update (moments, debias, weight decay,
per-layer trust ratios) on that vector and ``FlatLars`` the whole LARC
update (weight decay, per-layer local rates, momentum), with the per-layer
norms as SEGMENT reductions over the layout's contiguous spans.

Determinism: every replica must apply the identical averaged bytes to
identical state and get identical bits, so the segment reductions are one
``torch.dot`` per span (no ``index_add_``/``scatter_add_`` or other
atomics), and the per-segment broadcast back is a ``repeat_interleave``.

Numerics follow the port's per-leaf ``Lamb`` and ``Lars`` (``optim/lamb.py``,
``optim/lars.py``): the same operations in the same order on a one-leaf
vector; the only differences are the reduction order of the norms and the
mask expansions.
``parallel.train_step.make_flat_apply_step`` consumes it.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dedloc_tpu_torch.models.convert import grad_name
from dedloc_tpu_torch.optim.lamb import bias_corrections, trust_ratio_scale


def spec_spans(
    spec: Sequence[Tuple[str, Tuple[int, ...], np.dtype]]
) -> List[Tuple[int, int]]:
    """Contiguous (offset, size) spans of each spec entry in the flat
    buffer — the segment boundaries every per-layer reduction uses."""
    spans = []
    offset = 0
    for _name, shape, _dtype in spec:
        size = int(np.prod(shape)) if shape else 1
        spans.append((offset, size))
        offset += size
    return spans


def segment_sumsq(flat: torch.Tensor, spans) -> torch.Tensor:
    """Per-segment sum of squares over the flat buffer: one slice dot per
    contiguous span (deterministic: no atomics). Empty spans give 0."""
    zero = torch.zeros((), dtype=torch.float32, device=flat.device)
    return torch.stack([
        torch.dot(flat[o:o + s], flat[o:o + s]) if s else zero
        for o, s in spans
    ])


def segment_sizes(spans, device) -> torch.Tensor:
    """The spans' sizes as a long tensor on ``device`` (``expand_segments``
    takes it; built once per device, so an update copies nothing from the
    host)."""
    return torch.tensor([s for _o, s in spans], dtype=torch.long, device=device)


def expand_segments(per_segment: torch.Tensor, sizes: torch.Tensor,
                    total: int) -> torch.Tensor:
    """Broadcast a [num_segments] vector back to the flat [total] buffer
    (inverse of a segment reduction); ``sizes`` from ``segment_sizes``."""
    return torch.repeat_interleave(per_segment, sizes, output_size=total)


class FlatLamb:
    """The port's ``Lamb`` chain ([clip] -> moments+decay -> trust -> lr)
    over one flat fp32 buffer.

    ``decay_flags`` follow the TreeLayout spec order (sorted names).
    ``update`` is pure: the persistent state stays the per-leaf
    ``LambState`` (see ``make_flat_apply_step``).
    """

    def __init__(
        self,
        spec,
        decay_flags: Sequence[bool],
        learning_rate,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-6,
        weight_decay: float = 0.01,
        clamp_value: float = 10000.0,
        max_grad_norm: Optional[float] = None,
    ) -> None:
        from dedloc_tpu_torch.optim.lamb import Lamb

        self.spans = spec_spans(spec)
        self.total = sum(s for _o, s in self.spans)
        self.decay_flags = np.asarray(list(decay_flags), np.float32)
        if len(self.decay_flags) != len(self.spans):
            raise ValueError("one decay flag per spec entry")
        # the per-leaf chain's learning-rate rule
        self._chain = Lamb(learning_rate, b1=b1, b2=b2, eps=eps,
                           weight_decay=weight_decay, clamp_value=clamp_value,
                           max_grad_norm=max_grad_norm)
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = float(weight_decay)
        self.clamp_value = float(clamp_value)
        self.max_grad_norm = max_grad_norm
        self._on_device = {}  # device -> (segment sizes, decay flags)

    def _segments(self, device):
        cached = self._on_device.get(device)
        if cached is None:
            cached = self._on_device[device] = (
                segment_sizes(self.spans, device),
                torch.from_numpy(self.decay_flags).to(device))
        return cached

    def update(
        self,
        flat_grads: torch.Tensor,
        flat_params: torch.Tensor,
        flat_mu: torch.Tensor,
        flat_nu: torch.Tensor,
        count: torch.Tensor,
        sched_count: torch.Tensor,
    ):
        """One LAMB step on flat buffers (counts are 0-d int32 tensors).
        Returns (flat_updates, new_flat_mu, new_flat_nu, new_count) where
        ``flat_updates`` is the delta to add to the params."""
        b1, b2 = self.b1, self.b2
        sizes, decay_flags = self._segments(flat_grads.device)
        g = flat_grads
        if self.max_grad_norm is not None:
            g_norm = torch.sqrt(torch.dot(g, g))
            g = torch.where(g_norm < self.max_grad_norm, g,
                            (g / g_norm) * self.max_grad_norm)
        mu = flat_mu * b1 + (1 - b1) * g
        nu = flat_nu * b2 + (1 - b2) * g * g
        count = count + 1
        bc1, bc2 = bias_corrections(b1, b2, count)
        adam_step = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        if self.weight_decay > 0.0:
            decay = expand_segments(decay_flags, sizes, self.total)
            adam_step = adam_step + self.weight_decay * decay * flat_params
        w_norm = torch.sqrt(segment_sumsq(flat_params, self.spans))
        u_norm = torch.sqrt(segment_sumsq(adam_step, self.spans))
        ratio = trust_ratio_scale(w_norm, u_norm, self.clamp_value)
        trusted = adam_step * expand_segments(ratio, sizes, self.total)
        lr = self._chain._lr(sched_count)
        return -lr * trusted, mu, nu, count


class FlatLars:
    """The port's ``Lars`` over one flat fp32 buffer: per-layer local rates
    from segment norms, momentum folded in. ``excluded_flags`` marks spans
    the trust adaptation skips (plain ``-lr * g``, apex LARC's skip list).
    The persistent state stays the per-leaf ``LarsState``."""

    def __init__(
        self,
        spec,
        excluded_flags: Sequence[bool],
        learning_rate,
        momentum: float = 0.9,
        weight_decay: float = 1e-6,
        trust_coefficient: float = 0.001,
        eps: float = 1e-8,
        clip: bool = True,
    ) -> None:
        from dedloc_tpu_torch.optim.lars import Lars

        self.spans = spec_spans(spec)
        self.total = sum(s for _o, s in self.spans)
        self.excluded_flags = np.asarray(list(excluded_flags), np.float32)
        if len(self.excluded_flags) != len(self.spans):
            raise ValueError("one exclusion flag per spec entry")
        # the per-leaf chain's learning-rate rule
        self._chain = Lars(learning_rate, momentum=momentum,
                           weight_decay=weight_decay,
                           trust_coefficient=trust_coefficient, eps=eps,
                           clip=clip)
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)
        self.trust_coefficient = float(trust_coefficient)
        self.eps = float(eps)
        self.clip = bool(clip)
        self._on_device = {}  # device -> (segment sizes, exclusion flags)

    def _segments(self, device):
        cached = self._on_device.get(device)
        if cached is None:
            cached = self._on_device[device] = (
                segment_sizes(self.spans, device),
                torch.from_numpy(self.excluded_flags).to(device))
        return cached

    def update(
        self,
        flat_grads: torch.Tensor,
        flat_params: torch.Tensor,
        flat_momentum: torch.Tensor,
        sched_count: torch.Tensor,
    ):
        """One LARS step on flat buffers (``sched_count`` a 0-d int32
        tensor). Returns ``(flat_updates, new_flat_momentum)``: the update
        added to the params is the new momentum."""
        from dedloc_tpu_torch.optim.lars import local_rate

        sizes, excluded = self._segments(flat_grads.device)
        lr = self._chain._lr(sched_count)
        g = flat_grads + self.weight_decay * flat_params
        w_norm = torch.sqrt(segment_sumsq(flat_params, self.spans))
        g_norm = torch.sqrt(segment_sumsq(g, self.spans))
        rate = local_rate(w_norm, g_norm, lr, self.trust_coefficient,
                          self.eps, self.clip)
        excl = expand_segments(excluded, sizes, self.total)
        per_elem = expand_segments(rate, sizes, self.total)
        scaled = -(excl * lr + (1.0 - excl) * per_elem) * g
        new_mom = self.momentum * flat_momentum + scaled
        return new_mom, new_mom


def tree_flags(mask: Mapping[str, bool], params: Mapping[str, torch.Tensor],
               spec_names: Sequence[str]) -> List[bool]:
    """Per-spec-entry flags from a per-parameter mask keyed by the port's
    names (e.g. ``albert_weight_decay_mask``), reordered into the
    sorted-JAX-name spec order the flat buffer uses."""
    by_name = {grad_name(n, p.ndim)[0]: bool(mask[n]) for n, p in params.items()}
    return [by_name[name] for name in spec_names]
