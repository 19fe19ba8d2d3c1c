"""Parameter partition rules: tensor and expert parallelism over the slice
mesh, by path-regex rules on the JAX leaf names.

Port of ``dedloc_tpu/parallel/sharding.py``. The rules are the JAX
package's and match ``jax.tree_util.keystr`` paths; a port parameter is
matched under its JAX name (``models/convert.py`` ``grad_name``), so every
port leaf gets its JAX leaf's spec. Specs are kept in the JAX layout (a
``Linear`` weight's spec is its JAX kernel's, ``[in, out]``); ``port_spec``
turns one into the port's layout where a tensor is cut.

The Megatron rule set for the ALBERT family:

  column-parallel:  q/k/v projections, FFN up-projection -> output dim
  row-parallel:     attention output, FFN down-projection -> input dim
  vocab-parallel:   word-embedding table and the tied MLM decoder bias

``models/albert.py`` runs the matching forward on the local shards.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

import torch

from dedloc_tpu_torch.parallel.mesh import (
    Mesh,
    PartitionSpec as P,
    all_gather,
    local_block,
)

Rules = Sequence[Tuple[str, P]]

ALBERT_TP_RULES: Rules = (
    (r"\['attention'\]\['(query|key|value)'\]\['kernel'\]", P(None, "model")),
    (r"\['attention'\]\['(query|key|value)'\]\['bias'\]", P("model")),
    (r"\['attention'\]\['dense'\]\['kernel'\]", P("model", None)),
    (r"\['ffn'\]\['kernel'\]", P(None, "model")),
    (r"\['ffn'\]\['bias'\]", P("model")),
    (r"\['ffn_output'\]\['kernel'\]", P("model", None)),
    (r"\['word_embeddings'\]\['embedding'\]", P("model", None)),
    (r"\['mlm_bias'\]", P("model")),
)

# the expert-stacked FFN weights shard their leading expert axis; the
# router stays replicated. Concatenate with ALBERT_TP_RULES when both
# axes exist.
ALBERT_EP_RULES: Rules = (
    (r"\['moe_(wi|wo)'\]", P("expert")),
)


def spec_for_path(path_str: str, rules: Rules) -> P:
    for pattern, spec in rules:
        if re.search(pattern, path_str):
            return spec
    return P()


def rules_for(mesh: Mesh) -> Rules:
    """The trainer's rule set for ``mesh``: TP rules with a ``model`` axis,
    EP rules with an ``expert`` axis."""
    return (tuple(ALBERT_TP_RULES if "model" in mesh.shape else ())
            + tuple(ALBERT_EP_RULES if "expert" in mesh.shape else ()))


def partition_specs(params: Mapping[str, torch.Tensor],
                    rules: Rules = ALBERT_TP_RULES) -> Dict[str, P]:
    """{port name: spec in the JAX layout}, by the rules on the JAX names."""
    from dedloc_tpu_torch.models.convert import grad_name

    return {n: spec_for_path(grad_name(n, t.ndim)[0], rules)
            for n, t in params.items()}


def port_spec(name: str, ndim: int, spec: Sequence) -> P:
    """A JAX-layout spec in the port's layout for parameter ``name``."""
    from dedloc_tpu_torch.models.convert import grad_name

    _jname, perm = grad_name(name, ndim)
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    if perm is None:
        return P(*spec)
    out = [None] * ndim
    for j, d in enumerate(perm):  # JAX dim j is the port's dim perm[j]
        out[d] = spec[j]
    return P(*out)


def shard_tensor(t: torch.Tensor, spec: Sequence, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` placed by ``spec`` (in
    t's own layout), as a contiguous copy."""
    return t[local_block(t.shape, spec, mesh)].contiguous()


def gather_tensor(t: torch.Tensor, spec: Sequence, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's block ``t`` (spec in t's layout):
    an all-gather along each split dim (no gradient)."""
    for d, entry in enumerate(spec):
        if entry is not None and mesh.group(entry) is not None:
            t = all_gather(t, mesh, entry, dim=d)
    return t


def shard_params(params: Mapping[str, torch.Tensor], mesh: Mesh,
                 rules: Rules = ALBERT_TP_RULES) -> Dict[str, torch.Tensor]:
    """The full parameters (port names and layout) cut to this rank's
    blocks by the rules."""
    specs = partition_specs(params, rules)
    return {n: shard_tensor(t, port_spec(n, t.ndim, specs[n]), mesh)
            for n, t in params.items()}


@torch.no_grad()
def shard_module(module: torch.nn.Module, mesh: Mesh, rules: Rules) -> Dict[str, P]:
    """Cut every parameter of ``module`` (full, identical on every rank) to
    this rank's block in place; returns the specs (JAX layout)."""
    params = dict(module.named_parameters())
    specs = partition_specs(params, rules)
    for n, p in params.items():
        p.data = shard_tensor(p.data, port_spec(n, p.ndim, specs[n]), mesh)
    return specs


def mesh_shape_for(n_devices: int) -> Tuple[Tuple[int, int, int], Tuple[str, str, str]]:
    """Factor n devices into a (data, model, seq) grid: model and seq at
    most 2, data absorbs the rest."""
    axes = ("data", "model", "seq")
    if n_devices % 8 == 0:
        return (n_devices // 4, 2, 2), axes
    if n_devices % 4 == 0:
        return (n_devices // 4, 2, 2), axes
    if n_devices % 2 == 0:
        return (n_devices // 2, 2, 1), axes
    return (n_devices, 1, 1), axes
