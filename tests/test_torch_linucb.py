"""The port's LinUCB math (``repro_torch.core.linucb``) against
``repro.core.linucb`` on the same numpy-seeded inputs, on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import linucb as jlinucb  # noqa: E402
from repro.core.types import LinUCBState as JLinUCBState  # noqa: E402
from repro_torch.core import linucb  # noqa: E402
from repro_torch.core.types import LinUCBState  # noqa: E402


def _inputs(n, K, d, seed):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.normal(size=(n, d))).astype(np.float32)
    A = 0.1 * rng.normal(size=(n, d, d))
    Minv = np.linalg.inv(np.eye(d) + A @ A.transpose(0, 2, 1)).astype(
        np.float32)
    ctx = rng.normal(size=(n, K, d))
    ctx = (ctx / np.linalg.norm(ctx, axis=-1, keepdims=True)).astype(
        np.float32)
    occ = rng.integers(0, 1000, n).astype(np.int32)
    return w, Minv, ctx, occ


@pytest.mark.parametrize("n,K,d", [(37, 20, 25), (64, 7, 19)])
def test_ucb_scores_match_reference(n, K, d):
    w, Minv, ctx, occ = _inputs(n, K, d, seed=n * 100 + K)
    want = np.asarray(jlinucb.ucb_scores_batch(
        jnp.asarray(w), jnp.asarray(Minv), jnp.asarray(ctx),
        jnp.asarray(occ), 0.3))
    got = linucb.ucb_scores(torch.from_numpy(w), torch.from_numpy(Minv),
                            torch.from_numpy(ctx), torch.from_numpy(occ),
                            0.3).numpy()
    # unit contexts keep |score| ~ 1: f32 sums in another order differ by
    # a few ulps of 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_cold_start_scores_are_zero_and_index_zero_wins():
    n, K, d = 9, 12, 6
    _, _, ctx, _ = _inputs(n, K, d, seed=3)
    lin = linucb.init_linucb(n, d, device="cpu")
    w = linucb.user_vector(lin.Minv, lin.b)
    c = torch.from_numpy(ctx)
    scores = linucb.ucb_scores(w, lin.Minv, c, lin.occ, 0.3)
    assert bool((scores == 0).all())
    assert bool((linucb.choose(w, lin.Minv, c, lin.occ, 0.3) == 0).all())


def test_init_linucb_matches_reference_and_does_not_alias():
    lin = linucb.init_linucb(5, 4, device="cpu")
    ref = jlinucb.init_linucb(5, 4)
    for got, want in zip(lin, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Minv is updated in place on the card: it must own its storage
    assert lin.M.data_ptr() != lin.Minv.data_ptr()


def test_sherman_morrison_and_masked_update_match_reference():
    n, d = 23, 7
    rng = np.random.default_rng(11)
    _, Minv, _, occ = _inputs(n, 2, d, seed=5)
    M = np.linalg.inv(Minv).astype(np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    r = rng.random(n).astype(np.float32)
    mask = rng.random(n) < 0.6

    want = jlinucb.masked_batch_update(
        JLinUCBState(*(jnp.asarray(a) for a in (M, Minv, b, occ))),
        jnp.asarray(x), jnp.asarray(r), jnp.asarray(mask))
    got = linucb.masked_batch_update(
        LinUCBState(*(torch.from_numpy(a) for a in (M, Minv, b, occ))),
        torch.from_numpy(x), torch.from_numpy(r), torch.from_numpy(mask))
    # the reference's own rank-1 tolerance (tests/test_interact.py)
    for g, w_ in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=3e-5,
                                   atol=3e-5)
    np.testing.assert_array_equal(got.occ.numpy(), np.asarray(want.occ))
    np.testing.assert_allclose(
        linucb.sherman_morrison(torch.from_numpy(Minv),
                                torch.from_numpy(x)).numpy(),
        np.asarray(jlinucb.sherman_morrison(jnp.asarray(Minv),
                                            jnp.asarray(x))),
        rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(
        linucb.user_vector(torch.from_numpy(Minv), torch.from_numpy(b)),
        np.asarray(jlinucb.user_vector(jnp.asarray(Minv), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
