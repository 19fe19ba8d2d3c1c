"""A slice of ranks as ONE collaboration peer.

Port of the JAX package's slice-as-one-peer (``roles/trainer.py`` with
``mesh_devices > 1``; ``collaborative/optimizer.py`` ``mesh``): there one
process drives the slice's devices; here the slice is N ranks
(``parallel/mesh.py``). Rank 0 leads: only it runs the DHT, the averager,
telemetry and checkpointing, and its ``CollaborativeOptimizer`` decides
each boundary. Every decision that touches the slice's state reaches the
other ranks as a command broadcast from rank 0, which they carry out in
the same order (``follow``):

- ``grads``: each rank's accumulator summed over the batch axes and its
  TP/EP blocks gathered, so rank 0 averages full tensors under the
  single-device names and shapes (the join-time schema fingerprint is a
  single-device peer's);
- ``apply``: rank 0's averaged mean gradients broadcast whole; each rank
  applies on its own blocks (the guarded mesh apply: ZeRO moments, TP/EP
  leaves) and the NaN verdict is the slice's;
- ``views``: the state gathered to full tensors under the JAX names, for
  state sharing and checkpoints (rank 0 keeps them);
- ``adopt``: a full named state (a peer's, a checkpoint's) broadcast, each
  rank keeping its blocks;
- ``restore``: an overlapped round failed: each rank adds the parts it
  committed to that round back into its accumulator;
- ``end``: the boundary is over: whether a global step was applied, whether
  the accumulator restarts, whether this boundary committed the
  accumulation to a background (overlapped) round, and the collaboration's
  step number.

**Overlap averaging on a slice.** Rank 0 averages the gathered full sums
in the background while every rank accumulates the next micro-batches.
Each rank keeps the parts it committed (``committed``) until the flight
resolves: a landed round consumes them and the late apply keeps every
rank's in-flight accumulation; a failed one restores each rank's own parts
(never the full sums, which would count every other rank's part again).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dedloc_tpu_torch.models.convert import gather_named, grad_name, shard_named
from dedloc_tpu_torch.parallel.mesh import PartitionSpec as P, broadcast, local_block
from dedloc_tpu_torch.parallel.sharding import gather_tensor, port_spec
from dedloc_tpu_torch.parallel.train_step import (
    TrainState,
    reduce_grads,
    zeros_like_grads,
)

# an optimizer's per-parameter state: LAMB's moments, LARS's momentum
_MOMENT = re.compile(r"^\[1\]\[\d+\]\.(mu|nu|momentum)(.*)$")


class Slice:
    """The slice's ranks around rank 0's collaboration (module docstring).
    ``param_sharding``/``opt_state_sharding``: the specs (JAX layout) of
    the parameter and moment blocks the ranks hold."""

    def __init__(self, mesh, tx, param_sharding=None, opt_state_sharding=None):
        self.mesh = mesh
        self.tx = tx
        self.leader = mesh.rank == 0
        self.pspecs: Mapping[str, P] = param_sharding or {}
        self.mspecs: Mapping[str, P] = (opt_state_sharding.mu
                                        if opt_state_sharding is not None
                                        else self.pspecs)
        # the full tensors rank 0 collected at this boundary (``grads``),
        # and the (accumulator, count) of this rank they were summed from
        self.gathered: Optional[Dict[str, torch.Tensor]] = None
        self.live: Optional[Tuple[Dict[str, torch.Tensor], int]] = None
        # this rank's (accumulator, count) committed to an overlapped round
        # still in flight; ``end(commit=True)`` on rank 0 asks for it
        self.committed: Optional[Tuple[Dict[str, torch.Tensor], int]] = None
        self._commit = False

    # ------------------------------------------------------------- layout

    def _pspec(self, name: str, ndim: int) -> P:
        return port_spec(name, ndim, self.pspecs.get(name, P()))

    def full_shape(self, name: str, t: torch.Tensor) -> Tuple[int, ...]:
        spec = self._pspec(name, t.ndim)
        return tuple(s * (self.mesh.axis_size(a) if a is not None else 1)
                     for s, a in zip(t.shape, tuple(spec) + (None,) * t.ndim))

    def full_like(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Storage-free stand-ins with each parameter's full shape."""
        return {n: torch.empty((), device=p.device).expand(self.full_shape(n, p))
                for n, p in params.items()}

    def state_specs(self, names, params: Mapping[str, torch.Tensor]) -> Dict[str, P]:
        """Specs (JAX layout) of the shared-state names: ``[0]`` params,
        LAMB's moments under ``[1][i].mu``/``.nu`` and LARS's momentum
        under ``[1][0].momentum`` as the moment layout, counts
        replicated."""
        by_jax = {grad_name(n, p.ndim)[0]: n for n, p in params.items()}
        out = {}
        for key in names:
            if key.startswith("[0]"):
                out[key] = self.pspecs.get(by_jax[key[3:]], P())
                continue
            m = _MOMENT.match(key)
            out[key] = self.mspecs.get(by_jax[m.group(2)], P()) if m else P()
        return out

    # ------------------------------------------------------- collectives

    def full_grads(self, grad_acc: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Every rank's accumulator summed over the batch axes, its TP/EP
        blocks gathered: the full gradient sums (every rank calls)."""
        summed = reduce_grads(grad_acc, self.mesh, self.pspecs)
        return {n: gather_tensor(g, self._pspec(n, g.ndim), self.mesh)
                for n, g in summed.items()}

    def state_views(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The full state under the JAX shared-state names, in the JAX
        layout (every rank calls; every rank gets them)."""
        local = self.tx.state_views(state.params, state.opt_state)
        return gather_named(local, self.state_specs(local, state.params), self.mesh)

    def _send(self, cmd: str, payload=None) -> None:
        box = [cmd, payload]
        dist.broadcast_object_list(box, src=0)

    def _recv(self):
        box = [None, None]
        dist.broadcast_object_list(box, src=0)
        return box

    def _apply_local(self, apply_fn, state: TrainState, full: Optional[Dict],
                     like: Mapping[str, torch.Tensor]):
        """Broadcast rank 0's full mean gradients (one fp32 buffer, names
        in ``like``'s order) and apply this rank's blocks of them."""
        names = list(like)
        shapes = [self.full_shape(n, like[n]) for n in names]
        sizes = [int(np.prod(s)) for s in shapes]
        device = next(iter(like.values())).device
        if self.leader:
            buf = torch.cat([full[n].to(device, torch.float32).reshape(-1)
                             for n in names])
        else:
            buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
        buf = broadcast(buf, self.mesh, self.mesh.axis_names)
        grads, offset = {}, 0
        for n, shape, size in zip(names, shapes, sizes):
            g = buf[offset:offset + size].view(shape)
            grads[n] = g[local_block(shape, self._pspec(n, len(shape)), self.mesh)]
            offset += size
        return apply_fn(state, grads)

    def _adopt_local(self, state: TrainState, named, step: int) -> TrainState:
        from dedloc_tpu_torch.collaborative.optimizer import adopt_state

        local = self.tx.state_views(state.params, state.opt_state)
        blocks = shard_named(named, self.state_specs(local, state.params), self.mesh)
        return adopt_state(state, blocks, step, self.tx)

    # -------------------------------------------------- rank 0's commands

    def _restore_local(self, grad_acc, n_acc: int) -> int:
        """Add this rank's committed parts into ``grad_acc`` in place; the
        new count."""
        parts, n = self.committed
        self.committed = None
        with torch.no_grad():
            for k, a in grad_acc.items():
                a.add_(parts[k])
        return n_acc + n

    def _settle(self, grad_acc, n_acc: int, commit: bool, inflight: bool):
        """``end``'s bookkeeping of the committed parts, on every rank:
        (accumulator, count) to carry on with."""
        if commit:
            self.committed = (grad_acc, n_acc)
            return zeros_like_grads(grad_acc), 0
        if not inflight:
            self.committed = None  # the flight landed and consumed them
        return grad_acc, n_acc

    def collect_grads(self, grad_acc, n_acc: int = 0) -> Dict[str, torch.Tensor]:
        self._send("grads")
        self.live = (grad_acc, n_acc)
        self.gathered = self.full_grads(grad_acc)
        return self.gathered

    def commit(self) -> None:
        """This boundary's accumulation goes to an overlapped round: at
        ``end`` every rank keeps its parts as ``committed`` and starts a
        fresh accumulator."""
        self._commit = True

    def consumed(self) -> None:
        """The overlapped round landed: its committed parts are spent (the
        other ranks drop theirs at ``end``)."""
        self.committed = None

    def restore(self, grad_acc, n_acc: int) -> int:
        """The overlapped round failed: every rank adds its committed parts
        back (rank 0's into ``grad_acc``, in place); the new count."""
        self._send("restore")
        return self._restore_local(grad_acc, n_acc)

    def apply(self, apply_fn, state: TrainState, mean_grads):
        self._send("apply")
        return self._apply_local(apply_fn, state, mean_grads, state.params)

    def views(self, state: TrainState) -> Dict[str, torch.Tensor]:
        self._send("views")
        return self.state_views(state)

    def check_adoptable(self, state: TrainState, named) -> None:
        """Raise ``KeyError``/``ValueError`` (nothing sent, nothing
        changed) unless ``named`` has the slice's full names and shapes."""
        local = self.tx.state_views(state.params, state.opt_state)
        if set(named) != set(local):
            diff = sorted(set(named) ^ set(local))
            raise KeyError(f"state names differ: {diff[:4]}")
        specs = self.state_specs(local, state.params)
        for key, t in local.items():
            spec = tuple(specs[key]) + (None,) * t.ndim
            want = tuple(s * (self.mesh.axis_size(a) if a else 1)
                         for s, a in zip(t.shape, spec))
            if tuple(np.shape(named[key])) != want:
                raise ValueError(f"{key}: shape {tuple(np.shape(named[key]))} "
                                 f"does not match the slice's {want}")

    def adopt(self, state: TrainState, named, step: int) -> TrainState:
        self.check_adoptable(state, named)
        self._send("adopt", (dict(named), int(step)))
        return self._adopt_local(state, named, step)

    def end(self, stepped: bool, reset: bool, local_step: int,
            grad_acc=None, n_acc: int = 0):
        """Close the boundary on every rank; rank 0's (accumulator, count)
        to carry on with (``grad_acc`` kept unless it committed)."""
        commit, self._commit = self._commit, False
        inflight = self.committed is not None or commit
        self._send("end", (bool(stepped), bool(reset), int(local_step),
                           commit, inflight))
        if commit:
            grad_acc, n_acc = self.live  # rank 0's own parts of the round
        self.gathered = self.live = None
        return self._settle(grad_acc, n_acc, commit, inflight)

    # -------------------------------------------------- the other ranks

    def follow(self, state: TrainState, grad_acc, n_acc: int, apply_fn=None):
        """Carry out rank 0's commands until its ``end``: returns (state,
        grad_acc, n_acc, stepped, local_step)."""
        while True:
            cmd, payload = self._recv()
            if cmd == "grads":
                self.full_grads(grad_acc)
            elif cmd == "apply":
                state, _ok = self._apply_local(apply_fn, state, None, state.params)
            elif cmd == "views":
                self.state_views(state)
            elif cmd == "adopt":
                named, step = payload
                state = self._adopt_local(state, named, step)
            elif cmd == "restore":
                n_acc = self._restore_local(grad_acc, n_acc)
            elif cmd == "end":
                stepped, reset, local_step, commit, inflight = payload
                grad_acc, n_acc = self._settle(grad_acc, n_acc, commit, inflight)
                if reset and not commit:
                    grad_acc, n_acc = zeros_like_grads(state.params), 0
                return state, grad_acc, n_acc, stepped, local_step
            else:
                raise RuntimeError(f"unknown slice command {cmd!r}")
