"""On the card: the boundary's multi-tensor passes (``ops/multi_tensor.py``)
and the applies built on them (``parallel/train_step.py``
``make_flat_apply_step``, ``collaborative/optimizer.py``
``_fused_mean_clip``).

    python -m pytest tests/test_torch_multi_tensor_card.py -m card --noconftest -s

(``--noconftest``: the directory's conftest loads JAX, which the card's
machine does not need.) Skipped without a CUDA device.

The tree has leaves of one element, odd sizes, a leaf of exactly one chunk,
leaves larger than a chunk, and ``Linear`` / ``Conv2d`` weights, whose wire
layout is transposed (the spec's order and the flat buffer's element order
differ from the port's).

- a binding with its last role swapped (``rebind``) against a fresh one;
- each wrapper against its plain version on the same bound tensors: the
  mean's division bitwise, the elementwise passes bitwise given the same
  per-leaf scalars, the norms within fp32 summation order;
- LAMB (global clip on and off) and LARS, with and without ``post_apply``,
  from a dict and from the wire's flat buffer: 3 applies on the card
  against the plain route on the CPU from the same state and gradients;
- a NaN in one leaf rolls parameters, optimizer tensors, step and counts
  back bitwise; two applies from one state are bitwise equal;
- the launches of an apply (wrapper calls and CUDA kernels in a profiler
  trace) are the same for 10 and 200 leaves, and the mean clip and the
  apply pass under ``torch.cuda.set_sync_debug_mode("error")``;
- peak memory over the mean and one LAMB apply of Moonlight-shaped leaves
  stays within 8 bytes a parameter beyond the state and accumulator.
"""
import pytest
import torch

from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline
from dedloc_tpu_torch.collaborative.optimizer import _fused_mean_clip
from dedloc_tpu_torch.models.convert import to_jax_layout
from dedloc_tpu_torch.ops import multi_tensor as mt
from dedloc_tpu_torch.optim.flat import flat_twin
from dedloc_tpu_torch.optim.lamb import Lamb
from dedloc_tpu_torch.optim.lars import Lars
from dedloc_tpu_torch.optim.schedules import (
    linear_warmup_cosine_annealing,
    linear_warmup_linear_decay,
)
from dedloc_tpu_torch.parallel.train_step import (
    FlatLayout,
    TrainState,
    make_flat_apply_step,
)

C = mt.CHUNK
SHAPES = [("l0.bias", (1,)), ("l1.dense.weight", (37, 129)),
          ("l2.LayerNorm.weight", (4097,)), ("l3.big.weight", (3, 2 * C + 5)),
          ("l4.conv.weight", (16, 3, 7, 7)), ("l5.dense.bias", (C,)),
          ("l6.odd.weight", (7, 11)), ("l7.bias", (1,)),
          ("l8.wide.weight", (5 * C + 3,)), ("l9.head.weight", (129, 257))]
# fp32 summation order of the norms, amplified a little by m / sqrt(v)
REL = 2e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest "
                    "tests/test_torch_multi_tensor_card.py -m card --noconftest")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _shapes(n_leaves):
    """``SHAPES`` repeated under new prefixes up to ``n_leaves`` leaves."""
    out = []
    for i in range(n_leaves):
        name, shape = SHAPES[i % len(SHAPES)]
        out.append((name if i < len(SHAPES) else f"m{i // len(SHAPES)}.{name}", shape))
    return out


def _tree(n_leaves=len(SHAPES), seed=0, scale=1.0, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    return {n: (torch.randn(s, generator=g) * scale).to(device)
            for n, s in _shapes(n_leaves)}


def _spec(params):
    return DeviceFlatPipeline.for_tree(params).spec


def _tx(kind):
    if kind == "lars":
        return Lars(linear_warmup_cosine_annealing(0.3, 2, 10), weight_decay=1e-4)
    return Lamb(linear_warmup_linear_decay(5e-2, 0, 10), weight_decay=0.01,
                max_grad_norm=1.0 if kind == "lamb" else None)


def _renorm(state):
    """A ``post_apply`` like SwAV's prototypes: one weight's rows
    re-normalised out of place, the rest as they were."""
    params = dict(state.params)
    w = params["l9.head.weight"]
    params["l9.head.weight"] = w / torch.clamp_min(w.norm(dim=1, keepdim=True), 1e-12)
    return TrainState(step=state.step, params=params, opt_state=state.opt_state)


def _wire(grads, layout):
    return torch.cat([to_jax_layout(grads[n], perm).reshape(-1)
                      for n, _o, _s, _shape, perm in layout.entries])


def _state_tensors(state):
    opt = state.opt_state
    out = {f"p.{n}": t for n, t in state.params.items()}
    for f, v in opt._asdict().items():
        if isinstance(v, dict):
            out.update({f"{f}.{n}": t for n, t in v.items()})
        else:
            out[f] = v
    out["step"] = state.step
    return out


def _close(name, got, want, rel=REL):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert bool(torch.isfinite(got).all()), name
    err = float((got - want).abs().max()) if got.numel() else 0.0
    assert err <= rel * float(want.abs().max() if want.numel() else 0) + 1e-7, (name, err)
    return err


def _bound(params, seed=1):
    """(table, roles G, P, MU, NU, OUT) over the tree on the card."""
    names = list(params)
    table = mt.LeafTable([params[n].numel() for n in names],
                         [not n.endswith("bias") for n in names])
    roles = [[_tree(len(names), seed + r, 0.1 if r else 1.0)[n] for n in names]
             for r in range(4)]
    roles[3] = [v.abs() for v in roles[3]]  # nu >= 0
    return table, roles + [table.empty_like(roles[0])]


@pytest.mark.card
def test_rebind_matches_a_fresh_bind(card):
    """The apply binds once and gives ``post_apply``'s output the last role
    by ``rebind``: the same offsets as binding every role anew, the same
    binding for the same tensors, and the new role's tensors checked."""
    table, roles = _bound(_tree())
    b = table.bind(roles)
    assert b.rebind(mt.OUT, roles[mt.OUT]) is b
    other = table.empty_like(roles[mt.P])
    again, fresh = b.rebind(mt.OUT, other), table.bind(roles[:mt.OUT] + [other])
    assert again.vec == fresh.vec
    assert torch.equal(again.offs, fresh.offs)
    i = next(i for i, t in enumerate(other) if t.dim() == 2 and min(t.shape) > 1)
    other[i] = torch.empty(other[i].shape[::-1], device="cuda").t()
    with pytest.raises(ValueError, match="contiguous"):
        b.rebind(mt.OUT, other)


@pytest.mark.card
def test_each_wrapper_matches_its_plain_version(card):
    params = _tree()
    table, roles = _bound(params)
    b = table.bind(roles)
    report = {}
    report["sumsq"] = _close("sumsq", mt.sumsq(b, mt.G), mt.sumsq_plain(roles[0]), 1e-5)
    report["sumsq_mean"] = _close("sumsq mean", mt.sumsq(b, mt.G, divisor=3),
                                  mt.sumsq_plain(roles[0], divisor=3), 1e-5)
    assert bool(mt.all_finite(b, mt.G))
    roles[0][3].view(-1)[2 * C + 1] = float("inf")
    assert not bool(mt.all_finite(b, mt.G))
    roles[0][3].view(-1)[2 * C + 1] = 0.5
    # the mean's division is IEEE on both routes: bitwise
    out = table.empty_like(roles[0])
    mt.scaled_copy(table.bind([roles[0], out]), 3)
    want = [torch.empty_like(x) for x in out]
    mt.scaled_copy_plain(roles[0], want, 3)
    assert all(torch.equal(x, y) for x, y in zip(out, want))
    scale = torch.tensor(0.37, device="cuda")
    mt.scaled_copy(table.bind([roles[0], out]), 3, scale)
    mt.scaled_copy_plain(roles[0], want, 3, scale)
    assert all(torch.equal(x, y) for x, y in zip(out, want))

    for clip in (1.0, None):
        hp = Lamb(0.1, weight_decay=0.01, max_grad_norm=clip)
        g_norm = torch.sqrt(mt.sumsq_plain(roles[0]).sum()) if clip else None
        bc1, bc2 = (torch.tensor(v, device="cuda") for v in (0.19, 0.001999))
        norms = mt.lamb_norms(b, hp, g_norm, bc1, bc2)
        report[f"lamb_norms_{clip}"] = _close(
            "lamb norms", norms, mt.lamb_norms_plain(b, hp, g_norm, bc1, bc2), 1e-5)
        ratio = torch.rand(len(table), device="cuda") + 0.5
        neg_lr = torch.tensor(-0.01, device="cuda")
        mt.lamb_candidate(b, hp, g_norm, bc1, bc2, neg_lr, ratio)
        got = [x.clone() for x in roles[4]]
        mt.lamb_candidate_plain(b, hp, g_norm, bc1, bc2, neg_lr, ratio)
        report[f"lamb_candidate_bitwise_{clip}"] = all(
            torch.equal(x, y) for x, y in zip(got, roles[4]))
        for x, y in zip(got, roles[4]):
            _close("lamb candidate", x, y, 1e-6)
        before = [[t.clone() for t in r] for r in roles]
        for ok in (False, True):
            mt.lamb_commit(b, hp, g_norm, torch.tensor(ok, device="cuda"))
            if not ok:
                assert all(torch.equal(x, y) for r, s in zip(roles, before)
                           for x, y in zip(r, s)), "a rejected commit wrote"
        got = [[t.clone() for t in r] for r in roles[1:4]]
        for r, s in zip(roles, before):
            for x, y in zip(r, s):
                x.copy_(y)
        mt.lamb_commit_plain(b, hp, g_norm, torch.tensor(True, device="cuda"))
        report[f"lamb_commit_bitwise_{clip}"] = all(
            torch.equal(x, y) for r, s in zip(got, roles[1:4]) for x, y in zip(r, s))
        for r, s in zip(got, roles[1:4]):
            for x, y in zip(r, s):
                _close("lamb commit", x, y, 1e-6)

    hp = Lars(0.1, weight_decay=1e-4)
    lb = table.bind([roles[0], roles[1], roles[2], roles[4]])
    report["lars_norms"] = _close("lars norms", mt.lars_norms(lb, hp),
                                  mt.lars_norms_plain(lb, hp.weight_decay), 1e-5)
    neg_rate = -torch.rand(len(table), device="cuda")
    mt.lars_candidate(lb, hp, neg_rate)
    got = [x.clone() for x in roles[4]]
    mt.lars_candidate_plain(lb, hp, neg_rate)
    report["lars_candidate_bitwise"] = all(torch.equal(x, y) for x, y in zip(got, roles[4]))
    for x, y in zip(got, roles[4]):
        _close("lars candidate", x, y, 1e-6)
    before = [[t.clone() for t in r] for r in (roles[1], roles[2])]
    mt.lars_commit(lb, hp, neg_rate, torch.tensor(False, device="cuda"))
    assert all(torch.equal(x, y) for r, s in zip((roles[1], roles[2]), before)
               for x, y in zip(r, s)), "a rejected LARS commit wrote"
    mt.lars_commit(lb, hp, neg_rate, torch.tensor(True, device="cuda"))
    got = [[t.clone() for t in r] for r in (roles[1], roles[2])]
    for r, s in zip((roles[1], roles[2]), before):
        for x, y in zip(r, s):
            x.copy_(y)
    mt.lars_commit_plain(lb, hp, neg_rate, torch.tensor(True, device="cuda"))
    report["lars_commit_bitwise"] = all(
        torch.equal(x, y) for r, s in zip(got, (roles[1], roles[2])) for x, y in zip(r, s))
    print("multi-tensor wrappers vs plain:", report)
    bitwise = {k: v for k, v in report.items() if "bitwise" in k}
    assert all(bitwise.values()), bitwise


def _run(kind, post, from_tree, device, steps=3, n_leaves=len(SHAPES)):
    params = _tree(n_leaves, device=device)
    spec = _spec(params)
    tx = _tx(kind)
    state = TrainState.create({n: p.clone() for n, p in params.items()}, tx)
    apply = make_flat_apply_step(flat_twin(tx, spec, state.params), spec,
                                 post_apply=_renorm if post else None,
                                 from_tree=from_tree)
    layout = FlatLayout(spec, state.params)
    out = []
    for s in range(steps):
        acc = _tree(n_leaves, seed=10 + s, scale=0.3, device=device)
        grads = _fused_mean_clip(acc, 2, 0.0 if s else 5.0)
        state, ok = apply(state, grads if from_tree else _wire(grads, layout))
        assert bool(ok)
        out.append({k: v.detach().cpu().clone() for k, v in _state_tensors(state).items()})
    return out


@pytest.mark.card
@pytest.mark.parametrize("from_tree", [True, False])
@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("kind", ["lamb", "lamb_noclip", "lars"])
def test_apply_on_the_card_matches_the_plain_route(card, kind, post, from_tree):
    ours, plain = _run(kind, post, from_tree, "cuda"), _run(kind, post, from_tree, "cpu")
    worst = 0.0
    for step, (a, b) in enumerate(zip(ours, plain)):
        assert sorted(a) == sorted(b)
        for name in b:
            if b[name].dtype == torch.int32:
                assert torch.equal(a[name], b[name]), (step, name)
            else:
                worst = max(worst, _close(f"{step} {name}", a[name], b[name]))
    print(f"{kind} post={post} from_tree={from_tree}: worst {worst:.3e}")


@pytest.mark.card
@pytest.mark.parametrize("kind", ["lamb", "lars"])
def test_nan_rolls_back_bitwise_and_applies_repeat_bitwise(card, kind):
    params = _tree()
    spec = _spec(params)
    tx = _tx(kind)
    runs = []
    for _ in range(2):
        state = TrainState.create({n: p.clone() for n, p in params.items()}, tx)
        apply = make_flat_apply_step(flat_twin(tx, spec, state.params), spec,
                                     post_apply=_renorm if kind == "lars" else None,
                                     from_tree=True)
        for s in range(2):
            state, ok = apply(state, _fused_mean_clip(_tree(seed=20 + s), 3, 0.0))
            assert bool(ok)
        runs.append(_state_tensors(state))
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0]), "two runs differ"
    before = {k: v.clone() for k, v in runs[0].items()}
    bad = _tree(seed=30)
    bad["l3.big.weight"].view(-1)[C + 17] = float("nan")
    state, ok = apply(state, _fused_mean_clip(bad, 3, 0.0))
    assert not bool(ok)
    after = _state_tensors(state)
    for k, v in before.items():
        assert torch.equal(after[k].reshape(v.shape), v), k


def _launches_of_one_apply(n_leaves):
    params = _tree(n_leaves)
    spec = _spec(params)
    tx = _tx("lamb")
    state = TrainState.create(params, tx)
    apply = make_flat_apply_step(flat_twin(tx, spec, state.params), spec,
                                 post_apply=lambda s: s, from_tree=True)
    acc = _tree(n_leaves, seed=5)
    state, _ok = apply(state, _fused_mean_clip(acc, 2, 1.0))  # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # nothing in the boundary waits on the card
    try:
        state, _ok = apply(state, _fused_mean_clip(acc, 2, 1.0))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    before = {w.__name__: w.launches for w in mt.WRAPPERS}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, _ok = apply(state, _fused_mean_clip(acc, 2, 1.0))
        torch.cuda.synchronize()
    calls = {w.__name__: w.launches - before[w.__name__] for w in mt.WRAPPERS}
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return calls, kernels


@pytest.mark.card
def test_launches_do_not_depend_on_the_leaf_count(card):
    few, many = _launches_of_one_apply(10), _launches_of_one_apply(200)
    print("launches of the mean clip and one LAMB apply, 10 / 200 leaves:", few, many)
    assert few[0] == many[0]
    assert few[0]["lamb_candidate"] == 1 and few[0]["scaled_copy"] == 1
    assert few[1] == many[1] and few[1] > 0


@pytest.mark.card
def test_peak_memory_of_a_moonlight_shaped_apply(card):
    """Moonlight's leaves at a reduced count: two routed-expert stacks
    [8, 2048, 2816], an attention projection, norms: the mean and the apply
    hold at most 8 bytes a parameter beyond params, moments and the
    accumulator."""
    shapes = {"e0.experts.gate_up_proj": (8, 2048, 2816),
              "e1.experts.down_proj": (8, 1408, 2048),
              "a.q_proj.weight": (3072, 2048), "a.kv_a_layernorm.weight": (512,),
              "a.input_layernorm.weight": (2048,), "r.gate.e_score_correction": (64,)}
    g = torch.Generator(device="cuda").manual_seed(0)
    params = {n: torch.randn(s, generator=g, device="cuda") * 0.02
              for n, s in shapes.items()}
    n_params = sum(p.numel() for p in params.values())
    spec = _spec(params)
    tx = Lamb(2.2e-4, weight_decay=0.1, max_grad_norm=1.0)
    state = TrainState.create(params, tx)
    acc = {n: torch.randn(s, generator=g, device="cuda") * 1e-3 for n, s in shapes.items()}
    apply = make_flat_apply_step(flat_twin(tx, spec, state.params), spec,
                                 post_apply=lambda s: s, from_tree=True)
    state, ok = apply(state, _fused_mean_clip(acc, 2, 0.0))  # builds the kernels
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, ok = apply(state, _fused_mean_clip(acc, 2, 0.0))
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - held
    print(f"Moonlight-shaped apply: {n_params:,} parameters, {held / n_params:.2f} B "
          f"a parameter held, {extra / n_params:.3f} B a parameter more at the peak")
    assert bool(ok)
    assert extra <= 8 * n_params + (16 << 20)
