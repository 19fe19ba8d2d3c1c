"""The boundary's leaf table and its plain route on the CPU
(``ops/multi_tensor.py``): spans, flags and the chunk map at the chunk's
edges, the buffer ``empty_like`` lays out, the accumulator mean against
the formula it replaced, and the flat apply from the wire's buffer against
the one from a dict. The kernels themselves run only on the card
(``tests/test_torch_multi_tensor_card.py``)."""
import numpy as np
import pytest
import torch

from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline
from dedloc_tpu_torch.collaborative.optimizer import _fused_mean_clip
from dedloc_tpu_torch.models.convert import grad_name, to_jax_layout
from dedloc_tpu_torch.ops import multi_tensor as mt
from dedloc_tpu_torch.optim.flat import flat_twin
from dedloc_tpu_torch.optim.lamb import Lamb, albert_weight_decay_mask
from dedloc_tpu_torch.optim.lars import Lars
from dedloc_tpu_torch.parallel.train_step import FlatLayout, TrainState, make_flat_apply_step
from dedloc_tpu_torch.utils.device import divide

C = mt.CHUNK


def _tree(seed=0, scale=1.0):
    """A leaf of one element, odd sizes, leaves over a chunk, and weights
    whose wire layout is transposed (``Linear``) or permuted (``Conv2d``)."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"enc.LayerNorm.weight": (C + 1,), "enc.dense.bias": (1,),
              "enc.dense.weight": (3, C + 7), "stem.conv.weight": (4, 3, 5, 5),
              "head.bias": (C,), "head.weight": (9, 13)}
    return {n: torch.randn(s, generator=g) * scale for n, s in shapes.items()}


@pytest.mark.parametrize("sizes, counts", [
    ([1, C - 1, C, C + 1, 0, 2 * C, 3], [1, 1, 1, 2, 0, 2, 1]),
    ([5 * C + 3], [6]),
])
def test_chunk_map_at_the_edges(sizes, counts):
    table = mt.LeafTable(sizes)
    assert table.sizes.tolist() == sizes
    assert table.chunk0.tolist() == np.concatenate([[0], np.cumsum(counts)]).tolist()
    assert table.n_chunks == sum(counts) == len(table.chunk_leaf)
    for leaf, size in enumerate(sizes):
        chunks = np.flatnonzero(table.chunk_leaf == leaf)
        assert chunks.tolist() == list(range(table.chunk0[leaf], table.chunk0[leaf + 1]))
        # the chunks' first elements tile the leaf: the last holds the ragged end
        starts = (chunks - table.chunk0[leaf]) * C
        assert starts.tolist() == list(range(0, size, C))
    assert table.flags.tolist() == [0] * len(sizes)
    assert (table.offsets % mt.ALIGN == 0).all()
    assert (np.diff(table.offsets) >= table.sizes).all()
    with pytest.raises(ValueError, match="one flag per leaf"):
        mt.LeafTable(sizes, [True] * (len(sizes) + 1))


@pytest.mark.parametrize("kind", ["lamb", "lars"])
def test_flat_twins_table_follows_the_spec(kind):
    """A flat twin's table lists the spec's leaves (sorted JAX names) with
    their sizes and the decay mask (LAMB) or no exclusion (LARS) in that
    order."""
    params = _tree()
    spec = DeviceFlatPipeline.for_tree(params).spec
    tx = Lamb(0.1) if kind == "lamb" else Lars(0.1)
    table = flat_twin(tx, spec, params).table
    by_jax = {grad_name(n, p.ndim)[0]: n for n, p in params.items()}
    names = [by_jax[name] for name, _shape, _dtype in spec]
    assert names != list(params)  # the spec's order is not the tree's
    assert table.sizes.tolist() == [params[n].numel() for n in names]
    mask = albert_weight_decay_mask(params)
    want = [mask[n] for n in names] if kind == "lamb" else [False] * len(names)
    assert table.flags.tolist() == [int(f) for f in want]
    assert 0 < sum(want) < len(want) or kind == "lars"


def test_empty_like_is_views_of_one_aligned_buffer():
    params = _tree()
    leaves = list(params.values())
    table = mt.LeafTable([p.numel() for p in leaves])
    out = table.empty_like(leaves)
    base = out[0].data_ptr()
    assert [o.shape for o in out] == [p.shape for p in leaves]
    assert all(o.dtype == torch.float32 and o.is_contiguous() for o in out)
    assert all(o.untyped_storage().data_ptr() == out[0].untyped_storage().data_ptr()
               for o in out)
    assert [(o.data_ptr() - base) // 4 for o in out] == table.offsets[:-1].tolist()
    with pytest.raises(ValueError, match="tensors for"):
        table.bind([leaves[:-1]])


def test_rebind_swaps_one_role():
    """``rebind`` keeps a binding whose role is given the same tensors and
    otherwise swaps that role alone."""
    leaves = list(_tree().values())
    table = mt.LeafTable([p.numel() for p in leaves])
    out, other = table.empty_like(leaves), table.empty_like(leaves)
    b = table.bind([leaves, out])
    assert b.rebind(1, list(out)) is b
    again = b.rebind(1, other)
    assert again.roles[0] is b.roles[0] and again.roles[1] == other
    with pytest.raises(ValueError, match="tensors for"):
        b.rebind(1, other[:-1])


@pytest.mark.parametrize("cap", [0.0, 1.0, 1e6])
def test_mean_clip_is_the_formula_it_replaced(cap):
    """``_fused_mean_clip`` on the CPU: bitwise the per-leaf formula (the
    divide, a fixed-order sum of per-leaf dots, one scale), as fp32 views
    of one buffer; the accumulator is left as it was."""
    acc = _tree(seed=3, scale=2.0)
    before = {k: v.clone() for k, v in acc.items()}
    got = _fused_mean_clip(acc, 3, cap)
    mean = {k: divide(g, 3) for k, g in acc.items()}
    if cap > 0:
        gnorm = torch.sqrt(torch.stack(
            [torch.dot(g.reshape(-1), g.reshape(-1)) for g in mean.values()]).sum())
        scale = torch.clamp_max(torch.full_like(gnorm, cap) / (gnorm + 1e-12), 1.0)
        mean = {k: g * scale for k, g in mean.items()}
    assert list(got) == list(acc)
    for k in acc:
        assert torch.equal(got[k], mean[k]), k
        assert torch.equal(acc[k], before[k]), k
    storage = {v.untyped_storage().data_ptr() for v in got.values()}
    assert len(storage) == 1


@pytest.mark.parametrize("kind", ["lamb", "lars"])
def test_wire_buffer_and_dict_apply_alike(kind):
    """The flat apply from the wire's buffer (JAX layout: transposed and
    permuted kernels, read into the port's layout once) and from the dict
    give bitwise the same state over 2 steps."""
    params = _tree()
    spec = DeviceFlatPipeline.for_tree(params).spec
    tx = Lamb(0.05, max_grad_norm=1.0) if kind == "lamb" else Lars(0.3)
    layout = FlatLayout(spec, params)
    states, applies = [], []
    for from_tree in (True, False):
        state = TrainState.create({n: p.clone() for n, p in params.items()}, tx)
        states.append(state)
        applies.append(make_flat_apply_step(flat_twin(tx, spec, state.params), spec,
                                            from_tree=from_tree))
    for step in range(2):
        grads = _fused_mean_clip(_tree(seed=10 + step, scale=0.1), 2, 0.0)
        wire = torch.cat([to_jax_layout(grads[n], perm).reshape(-1)
                          for n, _o, _s, _shape, perm in layout.entries])
        states[0], ok0 = applies[0](states[0], grads)
        states[1], ok1 = applies[1](states[1], wire)
        assert bool(ok0) and bool(ok1)
    a, b = states
    assert int(a.step) == int(b.step) == 2
    for n in params:
        assert torch.equal(a.params[n], b.params[n]), n
        assert not torch.equal(a.params[n], params[n]), n
    for f in flat_twin(tx, spec, params).fields:
        for n in params:
            assert torch.equal(getattr(a.opt_state, f)[n], getattr(b.opt_state, f)[n])
