"""ZeRO-1: optimizer moments sharded over the slice's data axis.

Port of ``dedloc_tpu/parallel/zero.py``. The moments (LAMB's ``mu`` and
``nu``, twice the parameters' memory) live as shards on the ranks of the
data axis; params and gradients stay replicated over it, so this is ZeRO
stage 1: moment memory / n. With tensor or expert parallelism a moment
follows its parameter's layout (``tp_rules``) and ZeRO shards only what
those rules left replicated.

The apply (``parallel/train_step.py`` ``mesh_update``) updates each rank's
moment shard; LAMB's trust ratio needs the full leaf's norms, so the
partial squared norms are summed over the leaf's axes, and the updated
parameter shards are all-gathered back over the data axis.

Specs are in the JAX layout (the shape a leaf has in the JAX package), so
a leaf is split along the same dimension in both packages.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from dedloc_tpu_torch.parallel.mesh import Mesh, PartitionSpec as P, local_block


def _spec_for_leaf(leaf, mesh: Mesh, axis: str) -> P:
    """Shard the largest dimension divisible by the axis size; scalars and
    indivisible shapes replicate."""
    n = mesh.shape[axis]
    shape = tuple(getattr(leaf, "shape", ()))
    if not shape:
        return P()
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % n == 0 and shape[d] >= n:
            spec = [None] * len(shape)
            spec[d] = axis
            return P(*spec)
    return P()


def _jax_shaped(name: str, t: torch.Tensor):
    """A stand-in with the JAX-layout shape of the port tensor ``name``."""
    from dedloc_tpu_torch.models.convert import grad_name

    _j, perm = grad_name(name, t.ndim)
    shape = tuple(t.shape) if perm is None else tuple(t.shape[d] for d in perm)
    return np.empty(shape, dtype=np.uint8) if shape else np.empty((), np.uint8)


def opt_state_shardings(opt_state: Any, mesh: Mesh, axis: Optional[str] = "data",
                        tp_rules: Any = None, full_shapes: Optional[Mapping] = None):
    """The optimizer state's NamedTuple with a spec (JAX layout) in place
    of each tensor and ``P()`` for each count.

    ``axis``: ZeRO-1 data-axis sharding (None disables). ``tp_rules``: the
    tensor/expert rules (``parallel/sharding.py``); a moment follows its
    parameter's rule, and ZeRO applies only to what the rules left
    replicated. ``full_shapes`` ({name: full port shape}) when the state
    holds shards already."""
    from dedloc_tpu_torch.models.convert import grad_name
    from dedloc_tpu_torch.parallel.sharding import spec_for_path

    rule_axes = {a for _, spec in (tp_rules or ()) for a in spec if a is not None}
    use_rules = tp_rules is not None and bool(rule_axes & set(mesh.shape))
    out = {}
    for field in opt_state._fields:
        value = getattr(opt_state, field)
        if not isinstance(value, dict):
            out[field] = P()
            continue
        specs = {}
        for n, t in value.items():
            spec = P()
            if use_rules:
                spec = spec_for_path(grad_name(n, t.ndim)[0], tp_rules)
            if spec == P() and axis is not None and axis in mesh.shape:
                shape = full_shapes[n] if full_shapes is not None else t.shape
                spec = _spec_for_leaf(_jax_shaped(n, torch.empty(shape, device="meta")),
                                      mesh, axis)
            specs[n] = spec
        out[field] = specs
    return type(opt_state)(**out)


def zero_part(name: str, ndim: int, moment_spec: Sequence,
              param_spec: Sequence) -> P:
    """The port-layout spec of the split a moment has beyond its
    parameter's own (the ZeRO axis), or ``P()``."""
    from dedloc_tpu_torch.parallel.sharding import port_spec

    m = port_spec(name, ndim, moment_spec)
    p = port_spec(name, ndim, param_spec)
    return P(*(a if a != b else None for a, b in zip(m, p)))


def shard_opt_state(opt_state: Any, mesh: Mesh, axis: str = "data",
                    shardings: Any = None,
                    param_specs: Optional[Mapping[str, Sequence]] = None):
    """The optimizer state with each moment cut to this rank's ZeRO block
    (``shardings`` from ``opt_state_shardings``, by default ZeRO alone over
    ``axis``). The moments come in their parameter's layout (full, or the
    parameter's own block under ``param_specs``)."""
    if shardings is None:
        shardings = opt_state_shardings(opt_state, mesh, axis)
    out = {}
    for field in opt_state._fields:
        value = getattr(opt_state, field)
        if not isinstance(value, dict):
            out[field] = value
            continue
        specs = getattr(shardings, field)
        out[field] = {
            n: t[local_block(t.shape, zero_part(
                n, t.ndim, specs[n], (param_specs or {}).get(n, P())),
                mesh)].contiguous()
            for n, t in value.items()}
    return type(opt_state)(**out)


def opt_state_bytes_per_device(opt_state: Any, mesh: Mesh,
                               axis: str = "data") -> int:
    """Post-sharding per-device footprint of a (full) optimizer state."""
    n = mesh.shape[axis]
    total = 0
    for field in opt_state._fields:
        value = getattr(opt_state, field)
        leaves = value.items() if isinstance(value, dict) else [(None, value)]
        for name, leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                size, itemsize = leaf.numel(), leaf.element_size()
                spec = _spec_for_leaf(_jax_shaped(name, leaf), mesh, axis)
            else:  # an int count: one int32 on the device
                size, itemsize, spec = 1, 4, P()
            total += size * itemsize // (n if axis in spec else 1)
    return total
