"""Pipeline parallelism: GPipe microbatch pipelining over a mesh axis.

Port of ``dedloc_tpu/parallel/pipeline.py``, with JAX's SPMD schedule: every
rank of the pipe axis runs the same loop in lockstep, activations hop stage
to stage by ``ppermute``, and autograd through the loop gives GPipe's
reverse schedule (``ppermute``'s gradient is the reverse hop).

Schedule: fill and drain. With S stages and M microbatches the loop runs
T = M + S - 1 ticks; stage s computes microbatch m at tick s + m, stage 0
feeds, the last stage collects, and one sum over the pipe axis gives every
rank the outputs. A stage skips its compute on the ticks outside its
window (the bubble, where JAX computes on zeros whose results nothing
reads), so each rank runs its stage M times; the hops run every tick. The
whole schedule is one autograd node per rank (``_Pipeline``), whose
backward runs the reverse schedule: ranks hold separate autograd graphs,
and a hop's gradient must be sent and received by both of its ranks.

Stage parameters are either stacked (a leading ``[S, ...]`` stage axis:
pass the full stack or this rank's ``[1, ...]`` block, ``stage_param_
sharding``), or shared (ALBERT's one block, replicated; each stage applies
it ``num_hidden_layers / S`` times, ``shared_stage_fn``).

The head after the pipeline runs on every rank on the same outputs; only
the last stage's copy may send a gradient back (``last_stage_grad``), so
each parameter's gradient is the sum of the ranks' parts over the pipe
axis, as over the data axis.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from dedloc_tpu_torch.parallel.mesh import Mesh, PartitionSpec as P


def stage_param_sharding(mesh: Mesh, axis: str = "pipe") -> P:
    """The placement of stacked stage params: leading stage axis over
    ``axis``."""
    return P(axis)


def pipeline_apply(stage_fn: Callable[[Any, Any], Any], stage_params: Any,
                   microbatches: Any, mesh: Mesh, axis: str = "pipe",
                   stacked_params: bool = True,
                   micro_spec: Sequence = P()) -> Any:
    """Run ``microbatches`` (``[M, ...]``, or a tuple of such leaves)
    through the mesh's S pipelined stages; returns ``[M, ...]`` outputs,
    the same on every rank of the pipe axis.

    ``stage_fn(params_s, x) -> y`` keeps x's structure; ``stage_params`` is
    a dict of tensors (or None). With ``stacked_params`` every leaf has a
    leading stage axis: the full ``[S, ...]`` stack or this rank's ``[1,
    ...]`` block. ``micro_spec`` says how the microbatches' other dims are
    split over other axes (e.g. ``P(None, "data")``): the ranks hold their
    blocks already, and it must not name the pipe axis."""
    spec_axes = [a for entry in micro_spec if entry is not None
                 for a in (entry if isinstance(entry, tuple) else (entry,))]
    if axis in spec_axes:
        raise ValueError(f"micro_spec must not shard over the pipe axis {axis!r}")
    n_stages = mesh.shape[axis]
    single = isinstance(microbatches, torch.Tensor)
    micro = (microbatches,) if single else tuple(microbatches)
    n_micro = micro[0].shape[0]
    if any(l.shape[0] != n_micro for l in micro):
        raise ValueError(
            "every microbatch leaf needs the same leading microbatch count; "
            f"got {[l.shape[0] for l in micro]}")
    params = dict(stage_params or {})
    if stacked_params:
        for leaf in params.values():
            if leaf.shape[:1] not in ((n_stages,), (1,)):
                raise ValueError(
                    f"stacked stage params need leading dim {n_stages} (= "
                    f"mesh axis {axis!r}) or this rank's block of 1; got "
                    f"{tuple(leaf.shape)}")
    run = _Run(stage_fn, mesh, axis, stacked_params, list(params), single,
               len(micro))
    outs = _Pipeline.apply(run, *micro, *params.values())
    return outs[0] if single else tuple(outs)


class _Run:
    """What the pipeline Function needs besides tensors."""

    def __init__(self, stage_fn, mesh, axis, stacked, names, single, n_leaves):
        self.stage_fn, self.mesh, self.axis = stage_fn, mesh, axis
        self.stacked, self.names, self.single = stacked, names, single
        self.n_leaves = n_leaves
        self.stage = mesh.axis_index(axis)
        self.n_stages = mesh.shape[axis]

    def stage_params(self, tensors):
        if not self.stacked:
            return dict(zip(self.names, tensors))
        pick = lambda p: (p[self.stage] if p.shape[0] == self.n_stages
                          and self.n_stages > 1 else p[0])
        return {n: pick(p) for n, p in zip(self.names, tensors)}

    def call(self, params, xs):
        y = self.stage_fn(params, xs[0] if self.single else tuple(xs))
        return (y,) if self.single else tuple(y)


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node per rank. The forward runs each of
    this stage's M microbatches with a graph (inputs as leaves) and the
    hops with raw ``ppermute``; the backward runs the ticks in reverse: a
    stage takes its output gradient (the pipeline's for the last stage,
    else the one its successor sent back), back-propagates its microbatch
    and sends the input's gradient to its predecessor. Every rank runs
    every hop in both directions, in the same order."""

    @staticmethod
    def forward(ctx, run, *tensors):
        from dedloc_tpu_torch.parallel.mesh import all_reduce, ppermute_raw

        micro, param_t = tensors[:run.n_leaves], tensors[run.n_leaves:]
        stage, n_stages, n_micro = run.stage, run.n_stages, micro[0].shape[0]
        fwd = [(i, i + 1) for i in range(n_stages - 1)]
        grads_in = [m.requires_grad for m in micro]
        # a later stage's inputs are activations: their gradients go back
        differentiable = [g or (stage > 0 and m.is_floating_point())
                          for g, m in zip(grads_in, micro)]
        buf = [torch.zeros_like(m[0]) for m in micro]
        graphs = {}
        outs = [torch.zeros_like(m) for m in micro]
        with torch.enable_grad():
            # the parameters as given: a stage_fn that reads them from its
            # module (ALBERT's shared block) builds its graph on the same
            # tensors
            leaves = list(param_t)
            params = run.stage_params(leaves)
            for t in range(n_micro + n_stages - 1):
                m = t - stage  # the microbatch this stage holds at tick t
                if 0 <= m < n_micro:
                    src = [v[t] for v in micro] if stage == 0 else buf
                    xs = [x.detach().requires_grad_(g)
                          for x, g in zip(src, differentiable)]
                    ys = run.call(params, xs)
                    graphs[m] = (xs, ys)
                    if stage == n_stages - 1:
                        for o, y in zip(outs, ys):
                            o[m] = y.detach()
                    sent = [y.detach() for y in ys]
                else:  # the bubble: nothing here is read
                    sent = [torch.zeros_like(b) for b in buf]
                buf = [ppermute_raw(y, run.mesh, run.axis, fwd) for y in sent]
        ctx.run, ctx.graphs, ctx.leaves = run, graphs, leaves
        ctx.grads_in, ctx.n_micro = grads_in, n_micro
        # every other stage holds zeros: the sum replicates the outputs
        return tuple(all_reduce(o, run.mesh, run.axis) for o in outs)

    @staticmethod
    def backward(ctx, *grad_outs):
        from dedloc_tpu_torch.parallel.mesh import ppermute_raw

        run, graphs, leaves = ctx.run, ctx.graphs, ctx.leaves
        stage, n_stages, n_micro = run.stage, run.n_stages, ctx.n_micro
        back = [(i + 1, i) for i in range(n_stages - 1)]
        micro_grads = [torch.zeros_like(g) if need else None
                       for g, need in zip(grad_outs, ctx.grads_in)]
        param_grads = [None] * len(leaves)
        wanted = [p for p in leaves if p.requires_grad]
        received = [torch.zeros_like(g[0]) for g in grad_outs]
        for t in reversed(range(n_micro + n_stages - 1)):
            m = t - stage
            if 0 <= m < n_micro:
                xs, ys = graphs.pop(m)
                g_ys = ([g[m] for g in grad_outs] if stage == n_stages - 1
                        else received)
                pairs = [(y, g) for y, g in zip(ys, g_ys) if y.requires_grad]
                inputs = [x for x in xs if x.requires_grad] + wanted
                got = torch.autograd.grad([y for y, _ in pairs],
                                          inputs, [g for _, g in pairs],
                                          allow_unused=True)
                gx = iter(got[:len(inputs) - len(wanted)])
                sent = []
                for i, x in enumerate(xs):
                    g = next(gx) if x.requires_grad else None
                    g = torch.zeros_like(x) if g is None else g
                    if stage == 0 and micro_grads[i] is not None:
                        micro_grads[i][m] = g
                    sent.append(g)
                for j, g in enumerate(got[len(inputs) - len(wanted):]):
                    k = [i for i, p in enumerate(leaves) if p.requires_grad][j]
                    if g is not None:
                        param_grads[k] = g if param_grads[k] is None else param_grads[k] + g
            else:
                sent = [torch.zeros_like(r) for r in received]
            received = [ppermute_raw(g, run.mesh, run.axis, back) for g in sent]
        param_grads = [torch.zeros_like(p) if g is None and p.requires_grad else g
                       for p, g in zip(leaves, param_grads)]
        return (None, *micro_grads, *param_grads)


def shared_stage_fn(block_fn: Callable[[Any, Any], Any],
                    iters_per_stage: int) -> Callable[[Any, Any], Any]:
    """ALBERT-style stage: apply ONE shared block ``iters_per_stage`` times
    (stages differ only in position). Use with ``stacked_params=False``."""

    def stage(params, x):
        for _ in range(iters_per_stage):
            x = block_fn(params, x)
        return x

    return stage


class _LastStageGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


def last_stage_grad(x: torch.Tensor, mesh: Mesh, axis: str = "pipe") -> torch.Tensor:
    """Identity forward; the gradient reaches x on the pipe axis's last
    stage only. For what every stage computes after the pipeline on the
    same outputs (the head and the loss): one stage's gradient counts."""
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return x
    return _LastStageGrad.apply(x, mesh.axis_index(axis) == mesh.shape[axis] - 1)
