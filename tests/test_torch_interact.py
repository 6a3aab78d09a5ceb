"""The port's choose (``repro_torch.kernels.interact``) against the
reference's Pallas choose kernel in interpret mode, on the CPU.

Ties are held to the rule "identical candidate rows give identical
scores, and the first index wins", i.e. to the Pallas kernel: the jnp
oracle ``linucb.choose_batch`` breaks that rule on exact duplicates
(XLA's vmapped einsum rounds identical rows differently by position).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.interact import ops as jinteract  # noqa: E402
from repro_torch.core.backend import BackendConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.interact import ops  # noqa: E402


def _inputs(n, K, d, seed):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.normal(size=(n, d))).astype(np.float32)
    A = 0.1 * rng.normal(size=(n, d, d))
    Minv = np.linalg.inv(np.eye(d) + A @ A.transpose(0, 2, 1)).astype(
        np.float32)
    ctx = rng.normal(size=(n, K, d)).astype(np.float32)
    occ = rng.integers(0, 1000, n).astype(np.int32)
    return w, Minv, ctx, occ


def _both(w, Minv, ctx, occ, alpha):
    jc, jx = jinteract.choose(jnp.asarray(w), jnp.asarray(Minv),
                              jnp.asarray(ctx), jnp.asarray(occ), alpha,
                              use_pallas=True, interpret=True)
    c, x = ops.choose(*(torch.from_numpy(a) for a in (w, Minv, ctx, occ)),
                      alpha)
    return (np.asarray(jc), np.asarray(jx)), (c.numpy(), x.numpy())


@pytest.mark.parametrize("n,K,d", [(37, 20, 25), (64, 7, 19), (8, 16, 8),
                                   (9, 64, 32)])
def test_choose_matches_pallas_interpret(n, K, d):
    w, Minv, ctx, occ = _inputs(n, K, d, seed=n * 1000 + K)
    (jc, jx), (c, x) = _both(w, Minv, ctx, occ, 0.3)
    assert c.dtype == np.int32 and x.shape == (n, d)
    np.testing.assert_array_equal(c, jc)
    # the Pallas gather is a one-hot product: exact up to its own rounding
    np.testing.assert_allclose(x, jx, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(x, ctx[np.arange(n), c])


def test_duplicate_candidates_take_the_first_index():
    n, K, d = 16, 12, 8
    rng = np.random.default_rng(0)
    ctx = rng.normal(size=(n, K, d)).astype(np.float32)
    ctx[:, 5] = ctx[:, 2]
    ctx[:, 9] = ctx[:, 2]
    w = rng.normal(size=(n, d)).astype(np.float32)
    Minv = np.broadcast_to(np.eye(d, dtype=np.float32), (n, d, d)).copy()
    occ = np.ones(n, np.int32)
    (jc, _), (c, _) = _both(w, Minv, ctx, occ, 0.3)
    assert not np.any(c == 5) and not np.any(c == 9)
    np.testing.assert_array_equal(c, jc)


def test_backend_choose_returns_x_then_choice_and_launches_nothing():
    n, K, d = 12, 5, 4
    w, Minv, ctx, occ = (torch.from_numpy(a) for a in _inputs(n, K, d, 7))
    before = dict(_build.LAUNCHES)
    be = BackendConfig.create().interact()
    x, choice = be.choose(w, Minv, ctx, occ, 0.3)
    c2, x2 = ops.choose(w, Minv, ctx, occ, 0.3)
    assert torch.equal(choice, c2) and torch.equal(x, x2)
    assert _build.LAUNCHES == before
    # bf16 is a ported precision now; a name no preset has still raises
    assert BackendConfig.create("bf16").precision.state_dtype == "bf16"
    with pytest.raises(ValueError):
        BackendConfig.create("fp16")


@pytest.mark.parametrize("n,K,d,want", [
    (20480, 20, 25, (ops.REGISTER_TILE, 12)),   # offline and DCCB epochs
    (256, 64, 25, (ops.REGISTER_TILE, 1)),      # serving: a block per user
    (256, 64, 32, (ops.REGISTER_TILE, 1)),
    (20480, 20, 33, (ops.WARP_PER_USER, 4)),    # past the tile's d
    (256, 64, 33, (ops.WARP_PER_USER, 4)),
    (256, 257, 25, (ops.WARP_PER_USER, 4)),     # past its threads a user
])
def test_geometry_at_the_path_shapes(n, K, d, want):
    assert ops.geometry(n, K, d, 132) == want


@pytest.mark.parametrize("n,K,d", [(20480, 20, 25), (256, 64, 32),
                                   (100000, 7, 19), (5, 256, 32),
                                   (20480, 20, 1)])
def test_geometry_fits_a_block_and_four_blocks_an_sm(n, K, d):
    variant, users = ops.geometry(n, K, d, 132)
    assert variant == ops.REGISTER_TILE and users >= 1
    assert users * -(-K // ops.TILE_TK) <= ops.TILE_THREADS
    smem = ops.tile_smem(users, K, d)
    assert smem <= ops.MAX_SMEM
    if users > 1:
        assert ops.TILE_BLOCKS_PER_SM * (smem + ops.BLOCK_RESERVED) \
            <= ops.SM_SMEM
