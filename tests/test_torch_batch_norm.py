"""The fused batch norm (``ops/batch_norm.py``) on the CPU, where its
autograd ``Function`` runs the kernels' plain twins and its hand-derived
backward, against the plain formula it replaces (``batch_norm_reference``:
flax's statistics, then the epilogue, differentiated by autograd): every
epilogue, fp32 and bf16 inputs and outputs, [M, C] rows and channels-last
[N, C, H, W], training and eval mode; a constant channel whose variance
clamps at 0; what the backward saves; the wrapper's argument checks. The
kernels themselves are held to the twins on the card by ``chip_smoke.py``;
the slice mesh by ``tests/test_torch_swav_mesh.py``."""
import numpy as np
import pytest
import torch

from dedloc_tpu_torch.ops import batch_norm as bn

MOMENTUM, EPS = 0.9, 1e-5
N, C, H, W = 4, 6, 3, 5
# fp32: the two paths sum in other orders (the reference over [N, H, W] of
# a 4-D tensor, the twins over [M] rows) and form dweight as rstd * Σg(x -
# mean) against autograd's chain: ~1e-6 of the largest |ref|
FP32_RTOL = 1e-5
# a bf16 output or x gradient: one bf16 step (2^-8) of the largest |ref|,
# where the two fp32 values just before the rounding straddle a boundary
BF16_RTOL = 2 ** -7


def _inputs(layout, dtype, seed=0):
    rng = np.random.default_rng(seed)
    shape = (N * H * W, C) if layout == "rows" else (N, C, H, W)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    x = t(rng.standard_normal(shape) * 2 + 0.5).to(dtype)
    residual = t(rng.standard_normal(shape))
    dy = t(rng.standard_normal(shape))
    if layout == "nchw":
        x, residual, dy = (a.contiguous(memory_format=torch.channels_last)
                           for a in (x, residual, dy))
    return dict(x=x, residual=residual, dy=dy,
                weight=t(1 + 0.1 * rng.standard_normal(C)),
                bias=t(0.1 * rng.standard_normal(C)),
                running_mean=t(0.1 * rng.standard_normal(C)),
                running_var=t(1 + 0.1 * rng.random(C)))


def _run(fn, inp, train, relu, with_residual, out_dtype):
    """fn's (y, new mean, new var) and the gradients of sum(y * dy) with
    respect to x, weight, bias and the residual."""
    x = inp["x"].clone().requires_grad_()
    weight = inp["weight"].clone().requires_grad_()
    bias = inp["bias"].clone().requires_grad_()
    residual = inp["residual"].clone().requires_grad_() if with_residual else None
    y, mean, var = fn(x, weight, bias, inp["running_mean"], inp["running_var"],
                      train=train, momentum=MOMENTUM, eps=EPS, relu=relu,
                      residual=residual, out_dtype=out_dtype)
    leaves = [x, weight, bias] + ([residual] if with_residual else [])
    grads = torch.autograd.grad((y.float() * inp["dy"]).sum(), leaves)
    return dict(y=y, mean=mean, var=var, dx=grads[0], dweight=grads[1],
                dbias=grads[2], dresidual=grads[3] if with_residual else None)


def _close(name, got, want, rtol):
    assert got.shape == want.shape, name
    got, want = got.detach().double(), want.detach().double()
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= rtol * scale, f"{name}: max abs err {err:.3e} > {rtol:.1e} x {scale:.3e}"


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("layout", ["rows", "nchw"])
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)], ids=["fp32", "bf16_in", "bf16_in_out"])
@pytest.mark.parametrize("epilogue", ["none", "relu", "residual_relu"])
def test_function_matches_the_plain_formula(epilogue, x_dtype, out_dtype, layout, train):
    inp = _inputs(layout, x_dtype)
    relu, with_residual = epilogue != "none", epilogue == "residual_relu"
    args = (inp, train, relu, with_residual, out_dtype)
    got, want = _run(bn.batch_norm, *args), _run(bn.batch_norm_reference, *args)
    assert got["y"].dtype == out_dtype and got["dx"].dtype == x_dtype
    if layout == "nchw":  # the layout the convolutions read, no copy
        assert got["y"].is_contiguous(memory_format=torch.channels_last)
    low = lambda dtype: BF16_RTOL if dtype == torch.bfloat16 else FP32_RTOL
    _close("y", got["y"], want["y"], low(out_dtype))
    for name in ("mean", "var", "dweight", "dbias"):
        _close(name, got[name], want[name], FP32_RTOL)
    _close("dx", got["dx"], want["dx"], low(x_dtype))
    if with_residual:
        _close("dresidual", got["dresidual"], want["dresidual"], FP32_RTOL)
    if not train:  # the running statistics as they were
        assert got["mean"] is inp["running_mean"] and got["var"] is inp["running_var"]
    # the CPU route runs the plain twins: no kernel launched
    assert all(w.launches == 0 for w in bn.WRAPPERS)


def _constant_channels():
    """[M, C] rows whose channel 0 is a constant with a negative raw
    variance (mean2 - mean² rounds below 0: clamped, no gradient through
    it) and channel 1 a constant with a raw variance >= 0."""
    inp = _inputs("rows", torch.float32, seed=3)
    x = inp["x"].clone()
    for channel, negative in ((0, True), (1, False)):
        for v in (0.1, 0.2, 0.3, 0.7, 1.1, 1.3, 2.9, 3.7, 5.3, 7.1, 9.9, 13.7):
            x[:, channel] = v
            st, _, _ = bn.bn_stats_plain(x, inp["running_mean"], inp["running_var"],
                                         MOMENTUM)
            if bool(st[C + channel] < 0) == negative:
                break
    inp["x"] = x
    return inp


@pytest.mark.parametrize("epilogue", ["none", "relu"])
def test_constant_channel_clamps_and_drops_the_variance_term(epilogue):
    inp = _constant_channels()
    st, _, new_var = bn.bn_stats_plain(inp["x"], inp["running_mean"],
                                       inp["running_var"], MOMENTUM)
    assert st[C] < 0 and st[C + 1] >= 0
    # the running variance moves with the clamped batch variance (0)
    assert new_var[0] == MOMENTUM * inp["running_var"][0]
    args = (inp, True, epilogue == "relu", False, torch.float32)
    got, want = _run(bn.batch_norm, *args), _run(bn.batch_norm_reference, *args)
    for name in ("y", "dx", "dweight", "dbias"):
        _close(name, got[name], want[name], FP32_RTOL)
    # channel 0's x gradient without the variance term: weight * rstd * (g
    # - Σg / M), which the reference's clamp_min gives by passing nothing
    g = inp["dy"][:, 0] * (got["y"][:, 0] > 0) if epilogue == "relu" else inp["dy"][:, 0]
    rstd = torch.rsqrt(torch.tensor(EPS))
    _close("dx, channel 0", got["dx"][:, 0],
           inp["weight"][0] * rstd * (g - g.mean()), FP32_RTOL)


def test_backward_saves_the_input_and_a_byte_mask_only():
    """Per element the Function keeps x in its own dtype (bf16) and, behind
    a residual ReLU, a one-byte mask: no fp32 activation."""
    inp = _inputs("nchw", torch.bfloat16)
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    x = inp["x"].clone().requires_grad_()
    residual = inp["residual"].clone().requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        bn.batch_norm(x, inp["weight"].requires_grad_(), inp["bias"], inp["running_mean"],
                      inp["running_var"], train=True, momentum=MOMENTUM, eps=EPS,
                      relu=True, residual=residual)
    per_element = sorted(str(d) for shape, d in saved if np.prod(shape) == x.numel())
    assert per_element == ["torch.bfloat16", "torch.uint8"]


@pytest.mark.parametrize("case", ["nchw_contiguous", "channels", "residual_shape",
                                  "three_dims", "weight_dtype"])
def test_wrapper_checks_raise(case):
    inp = _inputs("nchw", torch.bfloat16)
    kw = dict(train=True, momentum=MOMENTUM, eps=EPS, relu=True)
    x, weight, residual = inp["x"], inp["weight"], None
    if case == "nchw_contiguous":
        x = x.contiguous()
    elif case == "channels":
        weight = torch.ones(C + 1)
    elif case == "residual_shape":
        residual = inp["residual"][:, :, :2]
    elif case == "three_dims":
        x = x.reshape(N, C, H * W)
    else:
        weight = weight.double()
    with pytest.raises(ValueError):
        bn.batch_norm(x, weight, inp["bias"], inp["running_mean"], inp["running_var"],
                      residual=residual, **kw)
