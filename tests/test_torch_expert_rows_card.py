"""On the card: the expert layer's row kernels (``ops/expert_rows.py``) at
the Moonlight cell's shape, T = 16,384 tokens (2 x 8,192), k = 6 of 64
experts, 8 held (a live share near 1/8), H = 2,048, F = 1,408.

    python -m pytest tests/test_torch_expert_rows_card.py -m card --noconftest -s

(``--noconftest``: the directory's conftest loads JAX, which the card's
machine does not need.) Skipped without a CUDA device.

- each kernel against its plain version, with every row of every input
  past the live count filled with NaN before the call: the outputs and
  gradients are finite and within bf16 tolerance (fp32 outputs: 1e-4 of
  the largest reference value);
- the grouped products (``torch._grouped_mm``) with NaN in the dead rows
  of their operands: the weight gradients, which sum over rows, are
  finite, so the library reads no row past the last group;
- the whole layer (``routed_experts``): forward and backward against the
  eager masked formula in bf16, with NaN past the live count of every
  buffer the layer allocates; two backward runs bitwise equal (no
  atomics); and no ``where``, ``index_select``, ``index_add`` or ``bmm``
  over the ``T * k`` rows.
"""
import json

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

T, K, E, N, H, F = 16384, 6, 64, 8, 2048, 1408


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest "
                    "tests/test_torch_expert_rows_card.py -m card --noconftest")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _experts(seed=0):
    """[T, k] distinct experts a token, uniform over the 64: a pair is held
    (experts 0-7) with probability 1/8."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(T, E, generator=g, device="cuda").topk(K, dim=-1).indices


def _nan_dead(t, live):
    t = t.clone()
    t[live:] = float("nan")
    return t


def _close(name, got, want, rel):
    got, want = got.float(), want.float()
    assert got.shape == want.shape, name
    assert bool(torch.isfinite(got).all()), name
    err = float((got - want).abs().max().detach())
    assert err <= rel * float(want.abs().max().detach()) + 1e-6, (name, err)
    return err


BF16, FP32 = 2 ** -7, 1e-4  # of max |ref|: one bf16 step and as much again


@pytest.mark.card
def test_each_row_kernel_matches_its_plain_version_with_nan_dead_rows(card):
    from dedloc_tpu_torch.ops import expert_rows as er
    from dedloc_tpu_torch.parallel.moe import sort_pairs

    g = torch.Generator(device="cuda").manual_seed(1)
    pairs = sort_pairs(_experts(), 0, N)
    live = int(pairs.offs[-1])
    assert 0.10 < live / (T * K) < 0.15, live
    x = torch.randn(T, H, generator=g, device="cuda")
    gates = torch.rand(T, K, generator=g, device="cuda")
    errs = {}
    rows, inverse = er.expert_gather(x, pairs.order, pairs.offs, K, torch.bfloat16)
    rows_p, inverse_p = er.expert_gather_plain(x, pairs.order, pairs.offs, K,
                                               torch.bfloat16)
    assert torch.equal(inverse, inverse_p) and torch.equal(rows[:live], rows_p[:live])
    h = _nan_dead(torch.randn(T * K, 2 * F, generator=g, device="cuda").bfloat16(), live)
    act = er.swiglu_rows(h, pairs.offs)
    errs["swiglu"] = _close("swiglu", act[:live], er.swiglu_rows_plain(h, pairs.offs)[:live],
                            BF16)
    dact = _nan_dead(torch.randn(T * K, F, generator=g, device="cuda").bfloat16(), live)
    dh = er.swiglu_rows_bwd(h, dact, pairs.offs)
    errs["swiglu_bwd"] = _close("swiglu_bwd", dh[:live],
                                er.swiglu_rows_bwd_plain(h, dact, pairs.offs)[:live], BF16)
    out = _nan_dead(torch.randn(T * K, H, generator=g, device="cuda").bfloat16(), live)
    y = er.expert_combine(out, inverse, pairs.offs, gates, torch.float32)
    errs["combine"] = _close("combine", y, er.expert_combine_plain(
        out, inverse, pairs.offs, gates, torch.float32), FP32)
    dx = er.expert_combine(out, inverse, pairs.offs, None, torch.float32)
    errs["gather_bwd"] = _close("gather_bwd", dx, er.expert_combine_plain(
        out, inverse, pairs.offs, None, torch.float32), FP32)
    dy = torch.randn(T, H, generator=g, device="cuda")
    d_out, d_gates = er.expert_combine_bwd(out, inverse, pairs.offs, gates, dy)
    d_out_p, d_gates_p = er.expert_combine_bwd_plain(out, inverse, pairs.offs, gates, dy)
    errs["combine_bwd.d_out"] = _close("d_out", d_out[:live], d_out_p[:live], BF16)
    errs["combine_bwd.d_gates"] = _close("d_gates", d_gates, d_gates_p, FP32)
    # the backward kernels twice: bitwise equal
    again = er.expert_combine_bwd(out, inverse, pairs.offs, gates, dy)
    assert torch.equal(again[0][:live], d_out[:live]) and torch.equal(again[1], d_gates)
    assert torch.equal(er.swiglu_rows_bwd(h, dact, pairs.offs)[:live], dh[:live])
    assert torch.equal(er.expert_combine(out, inverse, pairs.offs, None, torch.float32), dx)
    print(json.dumps({"expert_rows_check": [T, K, H, F, N], "live": live, "max_err": errs,
                      "card": torch.cuda.get_device_name(0)}))


@pytest.mark.card
def test_the_grouped_products_read_no_row_past_the_last_group(card):
    from dedloc_tpu_torch.parallel.moe import grouped_mm, sort_pairs

    g = torch.Generator(device="cuda").manual_seed(2)
    pairs = sort_pairs(_experts(1), 0, N)
    live = int(pairs.offs[-1])
    for k_, n_ in ((H, 2 * F), (F, H)):
        x = _nan_dead(torch.randn(T * K, k_, generator=g, device="cuda").bfloat16(), live)
        w = (torch.randn(N, k_, n_, generator=g, device="cuda") * 0.02).bfloat16()
        x.requires_grad_(True)
        w.requires_grad_(True)
        y = grouped_mm(x, w, pairs.offs)
        dy = _nan_dead(torch.randn(T * K, n_, generator=g, device="cuda").bfloat16(), live)
        dx, dw = torch.autograd.grad(y, (x, w), dy)
        assert bool(torch.isfinite(y[:live]).all()) and bool(torch.isfinite(dx[:live]).all())
        assert bool(torch.isfinite(dw).all()), f"dw [{k_}, {n_}] read a dead row"
        want = torch.cat([x[a:b].detach().float().t() @ dy[a:b].float()
                          for a, b in zip([0] + pairs.offs[:-1].tolist(),
                                          pairs.offs.tolist())]).view(N, k_, n_)
        _close(f"dw [{k_}, {n_}]", dw, want, 1e-2)


class _MaskedGroupedMM(torch.autograd.Function):
    """The grouped product as the layer ran it before the row kernels: the
    rows past the last group zeroed after each product, forward and
    backward."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(x, w, offs)
        real = (torch.arange(x.shape[0], device=x.device) < offs[-1])[:, None]
        return torch.where(real, torch._grouped_mm(x, w, offs=offs), 0)

    @staticmethod
    def backward(ctx, dy):
        x, w, offs = ctx.saved_tensors
        dy = dy.contiguous()
        real = (torch.arange(x.shape[0], device=x.device) < offs[-1])[:, None]
        dx = torch.where(real, torch._grouped_mm(dy, w.transpose(-1, -2), offs=offs), 0)
        return dx, torch._grouped_mm(x.t(), dy, offs=offs), None


def _masked_layer(x, r, gate_up, down, dtype):
    """The layer's eager formula before the row kernels (every pass over
    all T * k rows, the grouped products' tails zeroed)."""
    from dedloc_tpu_torch.parallel.moe import sort_pairs

    t, k = r.experts.shape
    held = r.experts < N
    pairs = sort_pairs(r.experts, 0, N)
    rows = x.to(dtype).index_select(0, pairs.order // k)
    h = _MaskedGroupedMM.apply(rows, gate_up.to(dtype), pairs.offs)
    act = (torch.nn.functional.silu(h[:, :F].float()) * h[:, F:].float()).to(dtype)
    out = _MaskedGroupedMM.apply(act, down.to(dtype), pairs.offs)
    inverse = torch.empty_like(pairs.order).scatter_(
        0, pairs.order, torch.arange(t * k, device=x.device))
    per_pair = out.index_select(0, inverse).view(t, k, -1)
    weight = (r.gates * held).to(dtype)
    return torch.bmm(weight[:, None, :], per_pair)[:, 0].float()


class _RowOps(TorchDispatchMode):
    """The ATen operations that touch a 2-D tensor of ``T * k`` rows."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat = [a for a in list(args) + list((kwargs or {}).values())
                + (list(out) if isinstance(out, (tuple, list)) else [out])
                if isinstance(a, torch.Tensor)]
        if any(a.dim() == 2 and a.shape[0] == T * K for a in flat):
            self.seen.add(func.overloadpacket.__name__)
        return out


class _NanEmpty(TorchDispatchMode):
    """Every fresh ``empty`` / ``empty_strided`` filled with NaN: the rows a
    kernel leaves unwritten then poison whatever reads them."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in ("empty", "empty_strided", "empty_like") \
                and out.is_floating_point():
            out.fill_(float("nan"))
        return out


@pytest.mark.card
def test_the_layer_matches_the_masked_formula_and_runs_on_the_kernels(card):
    from dedloc_tpu_torch.parallel import moe

    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(T, H, generator=g, device="cuda").requires_grad_(True)
    gates = torch.rand(T, K, generator=g, device="cuda").requires_grad_(True)
    r = moe.TopKRouting(None, _experts(2), gates, None)
    gate_up = (torch.randn(N, H, 2 * F, generator=g, device="cuda") * 0.02).requires_grad_(True)
    down = (torch.randn(N, F, H, generator=g, device="cuda") * 0.02).requires_grad_(True)
    leaves = (x, gates, gate_up, down)
    dy = torch.randn(T, H, generator=g, device="cuda")

    def run():
        with _NanEmpty():
            y = moe.routed_experts(x, r, gate_up, down, 0, torch.bfloat16)
            return (y,) + torch.autograd.grad(y, leaves, dy)

    with _RowOps() as ops:
        got = run()
    banned = ops.seen & {"where", "index_select", "index_add", "index_add_", "bmm",
                         "index", "index_put", "index_put_", "scatter", "scatter_"}
    assert not banned, sorted(ops.seen)
    again = run()
    for name, a, b in zip(("y", "dx", "d_gates", "d_gate_up", "d_down"), got, again):
        assert torch.equal(a, b), f"{name}: two runs differ"
    y = _masked_layer(x, r, gate_up, down, torch.bfloat16)
    want = (y,) + torch.autograd.grad(y, leaves, dy)
    errs = {name: _close(name, a, b, 2e-2) for name, a, b in zip(
        ("y", "dx", "d_gates", "d_gate_up", "d_down"), got, want)}
    print(json.dumps({"expert_layer_check": [T, K, H, F, N], "aten_ops_on_rows":
                      sorted(ops.seen), "max_err": errs}))
