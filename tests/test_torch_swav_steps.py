"""The port's SwAV accumulate step against the JAX package's, from the
same numpy inputs and weights: two micro-batches with the queue on
(gradients, counter, running statistics, queue, losses), in fp32 and in
the bf16 default. The helpers and the tolerances are
``tests/test_torch_swav.py``'s."""
import numpy as np

from test_torch_swav import (  # noqa: E402
    BF16_GRAD_COS,
    BF16_GRAD_REL,
    BF16_LOSS_RTOL,
    BF16_STATS_RTOL,
    GRAD_FLOOR,
    GRAD_RTOL,
    STEP_ATOL,
    NO_EXCESS,
    _accumulate_both,
    _fp32_cfg,
    _rel,
    _tree_to_named,
    convert,
    jswav,
    swav,
)


def test_accumulate_step_matches_jax_fp32():
    jcfg, tcfg = _fp32_cfg(True, queue_length=16), _fp32_cfg(False, queue_length=16)
    (jga, jn, jbs, jq, jl), (tga, tn, tbs, tq, tl) = _accumulate_both(jcfg, tcfg)
    assert int(jn) == tn == 2
    np.testing.assert_allclose(tl, jl, rtol=STEP_ATOL)
    want = _tree_to_named(jga)
    got = convert.params_to_jax(tga)
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        _rel(got[name], ref, GRAD_RTOL, GRAD_FLOOR)
    for name, ref in _tree_to_named(jbs).items():
        np.testing.assert_allclose(convert.params_to_jax(tbs)[name], ref,
                                   atol=STEP_ATOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(tq.embeddings.numpy(), np.asarray(jq.embeddings),
                               atol=STEP_ATOL, rtol=0)


def test_accumulate_step_matches_jax_bf16():
    jcfg = jswav.SwAVConfig.tiny(queue_length=16)
    tcfg = swav.SwAVConfig.tiny(queue_length=16)
    (jga, _jn, jbs, _jq, jl), (tga, _tn, tbs, _tq, tl) = _accumulate_both(
        jcfg, tcfg, NO_EXCESS)
    np.testing.assert_allclose(tl, jl, rtol=BF16_LOSS_RTOL)
    want = _tree_to_named(jga)
    got = convert.params_to_jax(tga)
    keys = sorted(want)
    ref = np.concatenate([np.asarray(want[k], np.float64).ravel() for k in keys])
    ours = np.concatenate([got[k].astype(np.float64).ravel() for k in keys])
    assert np.linalg.norm(ours - ref) / np.linalg.norm(ref) < BF16_GRAD_REL
    assert ours @ ref / (np.linalg.norm(ours) * np.linalg.norm(ref)) > BF16_GRAD_COS
    for name, ref in _tree_to_named(jbs).items():
        _rel(convert.params_to_jax(tbs)[name], ref, BF16_STATS_RTOL)
