"""The boundary's LAMB / LARS over the port's own leaves, in the order of
the averaging wire's layout.

Port of ``dedloc_tpu/optim/flat.py``. The JAX package runs the whole LAMB
update (moments, debias, weight decay, per-layer trust ratios) or LARC
update (weight decay, per-layer local rates, momentum) on one flat fp32
vector in the sorted-name ``TreeLayout`` order of the JAX wire names, with
the per-layer norms as segment reductions over its spans. Here the leaves
stay where they are: ``FlatLamb`` and ``FlatLars`` run the same update as
passes of ``ops/multi_tensor.py`` over one ``LeafTable`` of the spec's
leaves (sizes in spec order, each leaf's weight-decay or exclusion flag),
in two steps that ``parallel.train_step.make_flat_apply_step`` drives:

- ``candidate``: the norms (chunk partials, a fixed-order sum a leaf), the
  per-leaf trust ratios or local rates, and the candidate parameters into
  a buffer of their own; no state is written;
- ``commit``: where the guard's device bool holds, the moments or the
  momentum of this step and the kept parameters written in place.

Determinism: every replica must apply the identical averaged bytes to
identical state and get identical bits, so every reduction is a
fixed-order sum of chunk partials (no ``index_add_``/``scatter_add_`` or
other atomics).

Numerics follow the port's per-leaf ``Lamb`` and ``Lars`` (``optim/lamb.py``,
``optim/lars.py``): the same operations in the same order on each element;
the only difference is the reduction order of the norms. ``flat_twin``
builds the flat form of a per-leaf optimizer.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dedloc_tpu_torch.models.convert import grad_name
from dedloc_tpu_torch.ops import multi_tensor as mt
from dedloc_tpu_torch.optim.lamb import (
    Lamb,
    albert_weight_decay_mask,
    bias_corrections,
    trust_ratio_scale,
)
from dedloc_tpu_torch.optim.lars import Lars, local_rate


def spec_spans(
    spec: Sequence[Tuple[str, Tuple[int, ...], np.dtype]]
) -> List[Tuple[int, int]]:
    """Contiguous (offset, size) spans of each spec entry in the flat
    buffer of the wire's layout."""
    spans = []
    offset = 0
    for _name, shape, _dtype in spec:
        size = int(np.prod(shape)) if shape else 1
        spans.append((offset, size))
        offset += size
    return spans


class FlatLamb:
    """The port's ``Lamb`` chain ([clip] -> moments+decay -> trust -> lr)
    over the spec's leaves.

    ``decay_flags`` follow the TreeLayout spec order (sorted names). The
    persistent state stays the per-leaf ``LambState``; ``fields`` names its
    tensor fields in the order the passes bind them.
    """

    fields = ("mu", "nu")

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
        self.spans = spec_spans(spec)
        self.total = sum(s for _o, s in self.spans)
        self.decay_flags = np.asarray(list(decay_flags), np.float32)
        if len(self.decay_flags) != len(self.spans):
            raise ValueError("one decay flag per spec entry")
        self.table = mt.LeafTable([s for _o, s in self.spans], self.decay_flags != 0)
        # the per-leaf chain's learning-rate rule
        self._chain = Lamb(learning_rate, b1=b1, b2=b2, eps=eps,
                           weight_decay=weight_decay, clamp_value=clamp_value,
                           max_grad_norm=max_grad_norm)
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = float(weight_decay)
        self.clamp_value = float(clamp_value)
        self.max_grad_norm = max_grad_norm

    def candidate(self, b: mt.Bound, opt) -> Optional[torch.Tensor]:
        """One LAMB step from ``opt`` (counts as 0-d int32 tensors) with the
        candidate parameters into role ``OUT`` of ``b`` (roles: gradients,
        parameters, mu, nu, out). Returns what ``commit`` needs: the global
        gradient norm of the clip (None without it)."""
        g_norm = None
        if self.max_grad_norm is not None:
            g_norm = torch.sqrt(mt.sumsq(b, mt.G).sum())
        bc1, bc2 = bias_corrections(self.b1, self.b2, opt.count + 1)
        sums = mt.lamb_norms(b, self, g_norm, bc1, bc2)
        ratio = trust_ratio_scale(torch.sqrt(sums[0]), torch.sqrt(sums[1]),
                                  self.clamp_value)
        neg_lr = -self._chain._lr(opt.schedule_count)
        mt.lamb_candidate(b, self, g_norm, bc1, bc2, neg_lr, ratio)
        return g_norm

    def commit(self, b: mt.Bound, ok: torch.Tensor, g_norm) -> None:
        """Where ``ok``: the step's moments into mu and nu and role ``OUT``
        (the kept parameters) into the parameters."""
        mt.lamb_commit(b, self, g_norm, ok)

    def counts(self, opt) -> Dict[str, torch.Tensor]:
        """The count fields this step advances (besides the schedule's)."""
        return {"count": opt.count + 1}


class FlatLars:
    """The port's ``Lars`` over the spec's leaves: per-layer local rates
    from the leaves' norms, momentum folded in. ``excluded_flags`` marks
    leaves the trust adaptation skips (plain ``-lr * g``, apex LARC's skip
    list). The persistent state stays the per-leaf ``LarsState``."""

    fields = ("momentum",)

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
        self.spans = spec_spans(spec)
        self.total = sum(s for _o, s in self.spans)
        self.excluded_flags = np.asarray(list(excluded_flags), np.float32)
        if len(self.excluded_flags) != len(self.spans):
            raise ValueError("one exclusion flag per spec entry")
        self.table = mt.LeafTable([s for _o, s in self.spans], self.excluded_flags != 0)
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

    def candidate(self, b: mt.Bound, opt) -> torch.Tensor:
        """One LARS step from ``opt`` with the candidate parameters into the
        last role of ``b`` (roles: gradients, parameters, momentum, out).
        Returns each leaf's negated rate, which ``commit`` needs."""
        lr = self._chain._lr(opt.schedule_count)
        sums = mt.lars_norms(b, self)
        rate = local_rate(torch.sqrt(sums[0]), torch.sqrt(sums[1]), lr,
                          self.trust_coefficient, self.eps, self.clip)
        if self.excluded_flags.any():
            excluded = b.table.arrays(rate.device)["flags"] != 0
            rate = torch.where(excluded, lr, rate)
        neg_rate = -rate
        mt.lars_candidate(b, self, neg_rate)
        return neg_rate

    def commit(self, b: mt.Bound, ok: torch.Tensor, neg_rate) -> None:
        """Where ``ok``: the step's momentum and the kept parameters."""
        mt.lars_commit(b, self, neg_rate, ok)

    def counts(self, opt) -> Dict[str, torch.Tensor]:
        return {}


def tree_flags(mask: Mapping[str, bool], params: Mapping[str, torch.Tensor],
               spec_names: Sequence[str]) -> List[bool]:
    """Per-spec-entry flags from a per-parameter mask keyed by the port's
    names (e.g. ``albert_weight_decay_mask``), reordered into the
    sorted-JAX-name spec order the flat buffer uses."""
    by_name = {grad_name(n, p.ndim)[0]: bool(mask[n]) for n, p in params.items()}
    return [by_name[name] for name in spec_names]


def flat_twin(tx, spec, params: Mapping[str, torch.Tensor]):
    """The flat form of the per-leaf optimizer ``tx`` over ``spec`` (the
    sorted-JAX-name layout of the gradient buffer): a ``Lamb`` gives a
    ``FlatLamb`` with its hyperparameters and the decay flags of the mask
    ``Lamb.update`` applies, a ``Lars`` a ``FlatLars`` with no exclusions
    (``Lars`` has none). Raises ``TypeError`` for any other optimizer."""
    names = [name for name, _shape, _dtype in spec]
    if isinstance(tx, Lamb):
        return FlatLamb(
            spec, tree_flags(albert_weight_decay_mask(params), params, names),
            tx.learning_rate, b1=tx.b1, b2=tx.b2, eps=tx.eps,
            weight_decay=tx.weight_decay, clamp_value=tx.clamp_value,
            max_grad_norm=tx.max_grad_norm)
    if isinstance(tx, Lars):
        return FlatLars(
            spec, [False] * len(spec), tx.learning_rate, momentum=tx.momentum,
            weight_decay=tx.weight_decay, trust_coefficient=tx.trust_coefficient,
            eps=tx.eps, clip=tx.clip)
    raise TypeError(f"no flat form of the optimizer {type(tx)!r}")
