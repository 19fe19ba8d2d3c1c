"""The fused add+LayerNorm kernels' least time over their device time
(%): each forward launch (``_ln_fwd_kernel``, with its residuals) and
each backward pair (``_ln_bwd_kernel`` + ``_ln_reduce_kernel``) at the
cell's [B*S, hidden] rows (``counts/roofline.py``)."""
from portbench.counts import roofline
from portbench.metrics import _trace


def read(run):
    shape = run.shapes.get("ln")
    if run.profile is None or shape is None:
        return None
    fwd = _trace.kernels(run.profile, "_ln_fwd_kernel")
    bwd = _trace.kernels(run.profile, "_ln_bwd_kernel")
    red = _trace.kernels(run.profile, "_ln_reduce_kernel")
    took = _trace.seconds(fwd + bwd + red)
    if not took:
        return None
    b = roofline.ln_bounds(*shape)
    return 100.0 * (len(fwd) * b["forward"] + len(bwd) * b["backward"]) / took
