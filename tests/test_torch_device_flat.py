"""The port's device-flat boundary against the JAX package's: the same
seeded gradients (ALBERT-tiny's, in both packages' layouts) give the same
wire bytes in fp32 and fp16, uint8 within one code, the same spec and
schema fingerprint, and the same error-feedback commit discipline."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.averaging.averager import spec_fingerprint as jax_spec_fingerprint
from dedloc_tpu.averaging.device_flat import DeviceFlatPipeline as JaxPipeline
from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.models.albert import AlbertForPreTraining as JaxModel
from dedloc_tpu_torch.averaging import DeviceFlatPipeline, named_device_leaves
from dedloc_tpu_torch.averaging.averager import schema_fingerprint, spec_fingerprint
from dedloc_tpu_torch.models import convert

CHUNK = 1 << 12  # several uint8 blocks over ALBERT-tiny's gradients


@pytest.fixture(scope="module")
def grads():
    """Seeded gradient-like values for every ALBERT-tiny leaf: the JAX tree
    (JAX names and layout) and the port's dict (the same values, in the
    port's names and layout), with a cold leaf and a constant leaf."""
    params = JaxModel(JaxConfig.tiny()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    values = [rng.standard_normal(np.shape(x)).astype(np.float32) * 1e-2
              for x in leaves]
    values[0] = values[0] * 1e-6  # a cold leaf
    values[1] = np.full_like(values[1], 0.5)  # constant: scale 0 -> 1
    jtree = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(v) for v in values])
    named = {jax.tree_util.keystr(p): np.asarray(x)
             for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    port = {k: v.clone() for k, v in convert.params_from_jax(named).items()}
    return jtree, port


def _both(grads, compression, **fetch_kw):
    jtree, port = grads
    jp = JaxPipeline.for_tree(jtree, compression=compression, chunk_elems=CHUNK)
    tp = DeviceFlatPipeline.for_tree(port, compression=compression,
                                     chunk_elems=CHUNK)
    return jp, tp, jp.fetch(jtree, **fetch_kw), tp.fetch(port, **fetch_kw)


def test_spec_and_fingerprint_match_the_jax_pipeline(grads):
    jtree, port = grads
    jp = JaxPipeline.for_tree(jtree)
    tp = DeviceFlatPipeline.for_tree(port)
    assert [(n, tuple(s)) for n, s, _ in tp.spec] == [
        (n, tuple(s)) for n, s, _ in jp.spec]
    assert spec_fingerprint(tp.spec) == jax_spec_fingerprint(jp.spec)
    # and the schema a named-dict view of the buffer carries
    view = tp.fetch(port, use_ef=False).result()
    assert schema_fingerprint(view) == spec_fingerprint(tp.spec)


@pytest.mark.parametrize("compression", ["none", "float16"])
@pytest.mark.parametrize("n", [1, 3])
def test_fp32_and_fp16_wire_bitwise_equal_jax(grads, compression, n):
    _jp, _tp, jf, tf = _both(grads, compression, n=n, use_ef=False)
    assert tf.wire_bytes == jf.wire_bytes
    assert tf.result().flat.tobytes() == jf.result().flat.tobytes()


def test_uint8_wire_within_one_code(grads):
    _jp, tp, jf, tf = _both(grads, "uint8", n=3, use_ef=False)
    jlo, jscale = (np.asarray(m) for m in jf._meta)
    tlo, tscale = (m.numpy() for m in tf._meta)
    assert tlo.tobytes() == jlo.tobytes()
    # (hi - lo) / 255: XLA's CPU code may take the reciprocal, the port
    # divides, so the per-block scale may differ in its last bit
    np.testing.assert_array_max_ulp(tscale, jscale, maxulp=1)
    assert tf.wire_bytes == jf.wire_bytes
    a, b = tf.result().flat, jf.result().flat
    for i, (lo, hi) in enumerate(tp.bounds):
        assert np.max(np.abs(a[lo:hi] - b[lo:hi])) <= jscale[i] * 1.0001


def test_contribution_clip_matches_jax(grads):
    """The clip scales by cap / ||mean||. The norm is one fp32 reduce over
    2e4 elements: the port's is within 1e-7 of the float64 norm here, the
    JAX package's CPU reduce (sequential fp32) 2.2e-5 off, inside the
    n * eps bound (1.2e-3) of any fp32 summation order."""
    cap = 1e-3
    _jp, _tp, jf, tf = _both(grads, "none", n=2, clip_cap=cap, use_ef=False)
    mean = _both(grads, "none", n=2, use_ef=False)[3].result().flat.astype(np.float64)
    exact = mean * min(1.0, cap / (np.sqrt(np.dot(mean, mean)) + 1e-12))
    ours = tf.result().flat
    np.testing.assert_allclose(ours, exact, rtol=1e-6, atol=1e-15)
    np.testing.assert_allclose(ours, jf.result().flat, rtol=1e-4, atol=1e-15)


@pytest.mark.parametrize("compression", ["float16", "uint8"])
def test_error_feedback_residual_matches_jax(grads, compression):
    jp, tp, jf, tf = _both(grads, compression, n=1, use_ef=True)
    # one uint8 code of the coarsest block (a tie may round either way)
    code = float(np.max(np.asarray(jf._meta[1]))) if jf._meta else 0.0
    jp.commit(jf)
    tp.commit(tf)
    np.testing.assert_allclose(tp.residual_norm(), jp.residual_norm(), rtol=1e-3)
    # the second round folds the committed residual in, on both sides
    jtree, port = grads
    j2 = jp.fetch(jtree, use_ef=True).result().flat
    t2 = tp.fetch(port, use_ef=True).result().flat
    if compression == "float16":
        assert t2.tobytes() == j2.tobytes()
    else:
        assert np.max(np.abs(t2 - j2)) <= 2 * code * 1.0001


def test_ef_commit_discipline(grads):
    """As tests/test_device_flat.py: an uncommitted round leaves no trace,
    a retry re-derives the same contribution, a reset drops the residual."""
    _jtree, port = grads
    pipe = DeviceFlatPipeline.for_tree(port, compression="uint8", chunk_elems=16)
    f1 = pipe.fetch(port, use_ef=True)
    f1.result()
    assert pipe.residual_norm() == 0.0
    f2 = pipe.fetch(port, use_ef=True)
    np.testing.assert_array_equal(f2.result().flat, f1.result().flat)
    pipe.commit(f2)
    assert pipe.residual_norm() > 0
    pipe.reset_residual()
    assert pipe.residual_norm() == 0.0


def test_ef_uint8_drift_stays_within_one_residual():
    """Cumulative applied signal tracks the cumulative true gradient to
    within one residual over 25 committed uint8 rounds (the same bound as
    tests/test_device_flat.py), and error feedback beats none."""
    rng = np.random.default_rng(0)
    pipe = DeviceFlatPipeline.for_tree({"w": torch.zeros(64)},
                                       compression="uint8", chunk_elems=32)
    true_sum, applied = np.zeros(64, np.float32), np.zeros(64, np.float32)
    drifts = []
    for _ in range(25):
        g = rng.standard_normal(64).astype(np.float32)
        true_sum += g
        fetch = pipe.fetch({"w": torch.from_numpy(g)}, use_ef=True)
        applied += fetch.result().flat
        pipe.commit(fetch)
        drifts.append(float(np.max(np.abs(applied - true_sum))))
    assert max(drifts) < 0.1
    plain = DeviceFlatPipeline.for_tree({"w": torch.zeros(64)},
                                        compression="uint8", chunk_elems=32)
    rng2 = np.random.default_rng(0)
    true2, applied2 = np.zeros(64, np.float32), np.zeros(64, np.float32)
    for _ in range(25):
        g = rng2.standard_normal(64).astype(np.float32)
        true2 += g
        applied2 += plain.fetch({"w": torch.from_numpy(g)}, use_ef=False).result().flat
    assert np.max(np.abs(applied2 - true2)) > drifts[-1]


def test_named_leaves_are_the_jax_names_in_the_jax_layout(grads):
    jtree, port = grads
    jnamed = {jax.tree_util.keystr(p): np.asarray(x)
              for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    ours = dict(named_device_leaves(port))
    assert sorted(ours) == sorted(jnamed)
    for name, leaf in ours.items():
        np.testing.assert_array_equal(leaf.numpy(), jnamed[name], err_msg=name)


def test_double_buffering_and_thread_safe_result(grads):
    _jtree, port = grads
    pipe = DeviceFlatPipeline.for_tree(port, compression="float16")
    f1 = pipe.fetch(port, n=1, use_ef=False)
    f2 = pipe.fetch(port, n=2, use_ef=False)
    results = []
    threads = [threading.Thread(target=lambda: results.append(f2.result()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert all(r is results[0] for r in results) and len(results) == 4
    a, b = f1.result().flat, results[0].flat
    assert a is not b
    # neither outstanding fetch clobbered the other's host buffer
    for n, got in ((1, a), (2, b)):
        alone = DeviceFlatPipeline.for_tree(port, compression="float16")
        assert got.tobytes() == alone.fetch(port, n=n, use_ef=False).result().flat.tobytes()


def test_schema_change_and_non_float_leaves(grads):
    _jtree, port = grads
    pipe = DeviceFlatPipeline.for_tree(port)
    assert pipe.matches_tree(port)
    changed = dict(port)
    name = next(iter(changed))
    changed[name] = torch.zeros(3)
    assert not pipe.matches_tree(changed)
    with pytest.raises(ValueError, match="non-float"):
        DeviceFlatPipeline.for_tree({"step": torch.zeros(3, dtype=torch.int32)})
