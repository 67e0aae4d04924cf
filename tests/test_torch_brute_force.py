"""The port's plain descriptor matcher (`pytheiasfm_tpu_torch/matching/
brute_force.py`) against the JAX package's, on the cases of
`tests/test_matching.py` and on random masked batches.

Tolerance: match indices equal exactly (the well-separated cases have no
near-ties), distances to 1e-6 absolute (the same f32 products summed in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.matching import brute_force as jbf
from pytheiasfm_tpu_torch.matching import brute_force as tbf
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)


def _rand_unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _both_pair(d1, d2, ratio, **kw):
    m1 = np.ones(len(d1), bool)
    m2 = np.ones(len(d2), bool)
    ij, dj = jbf.match_descriptor_pair(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2),
        jnp.asarray(ratio, jnp.float32), **kw,
    )
    it, dt = tbf.match_descriptor_pair(
        torch.tensor(d1), torch.tensor(d2), torch.tensor(m1), torch.tensor(m2),
        ratio, **kw,
    )
    ij, it = np.asarray(ij), it.numpy()
    np.testing.assert_array_equal(it, ij)
    fin = np.isfinite(np.asarray(dj))
    np.testing.assert_array_equal(np.isfinite(dt.numpy()), fin)
    np.testing.assert_allclose(dt.numpy()[fin], np.asarray(dj)[fin], atol=1e-6)
    return it


def test_identity_permutation(rng):
    d = _rand_unit(rng, 40, 64)
    perm = rng.permutation(40)
    d2 = d[perm] + rng.normal(size=d.shape).astype(np.float32) * 0.01
    idx = _both_pair(d, d2, 0.8, use_bf16=False)
    matched = idx >= 0
    assert matched.sum() >= 38
    np.testing.assert_array_equal(idx[matched], np.argsort(perm)[matched])


def test_lowes_ratio_rejects_ambiguous(rng):
    a = _rand_unit(rng, 1, 32)
    d2 = np.concatenate([a + 1e-4, a - 1e-4], axis=0).astype(np.float32)
    assert _both_pair(a, d2, 0.8, use_bf16=False)[0] == -1


def test_symmetric_check(rng):
    base = _rand_unit(rng, 1, 32)[0]
    d1 = np.stack([base, base + 0.05 * _rand_unit(rng, 1, 32)[0]]).astype(np.float32)
    d2 = np.stack([base, _rand_unit(rng, 1, 32)[0]]).astype(np.float32)
    idx = _both_pair(
        d1, d2, 0.95, use_lowes_ratio=False, keep_only_symmetric=True, use_bf16=False
    )
    assert idx[0] == 0 and idx[1] == -1


def test_single_column_has_no_second_best(rng):
    d1 = _rand_unit(rng, 3, 16)
    _both_pair(d1, d1[:1], 0.8, use_bf16=False)


@pytest.mark.parametrize("use_bf16", [True, False])
@pytest.mark.parametrize("flags", [(True, True), (False, False), (True, False)])
def test_batch_matches_jax(rng, use_bf16, flags):
    P, N, D = 3, 96, 32
    d1 = _rand_unit(rng, P * N, D).reshape(P, N, D)
    d2 = d1 + rng.normal(size=d1.shape).astype(np.float32) * 0.05
    d2 = d2[:, rng.permutation(N)]
    m1 = np.ones((P, N), bool)
    m2 = np.ones((P, N), bool)
    m1[1, -10:] = False
    m2[2, :4] = False
    kw = dict(use_lowes_ratio=flags[0], keep_only_symmetric=flags[1], use_bf16=use_bf16)
    ij, dj = jbf.match_descriptors_batch(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2),
        jnp.asarray(0.8, jnp.float32), **kw,
    )
    it, dt = tbf.match_descriptors_batch(
        torch.tensor(d1), torch.tensor(d2), torch.tensor(m1), torch.tensor(m2),
        0.8, **kw,
    )
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    fin = np.isfinite(np.asarray(dj))
    np.testing.assert_allclose(dt.numpy()[fin], np.asarray(dj)[fin], atol=1e-6)


def test_auto_dispatch_on_cpu_is_the_plain_path(rng):
    from pytheiasfm_tpu_torch.matching import streaming_matcher as sm

    d1 = torch.tensor(_rand_unit(rng, 64, 32))[None]
    m = torch.ones(1, 64, dtype=torch.bool)
    before = sm.streaming_top2.launches
    auto = tbf.match_descriptors_batch_auto(d1, d1, m, m, 0.8)
    plain = tbf.match_descriptors_batch(d1, d1, m, m, 0.8)
    assert sm.streaming_top2.launches == before
    assert torch.equal(auto[0], plain[0])
    assert torch.isinf(auto[1]).sum() == 0  # the plain path's distances
