"""The port's UCB scoring (``repro_torch.kernels.ucb``) against the
reference's Pallas kernel in interpret mode and its jnp oracle, on the
CPU; and its first-index argmax against the port's fused choose."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ucb import ops as jucb  # noqa: E402
from repro.kernels.ucb.ref import ucb_scores_ref as jucb_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.interact import ops as interact_ops  # noqa: E402
from repro_torch.kernels.ucb import ops  # noqa: E402


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


@pytest.mark.parametrize("n,K,d", [(37, 20, 25), (1, 20, 25), (64, 7, 19),
                                   (5, 33, 3), (264, 20, 25), (265, 20, 25)])
def test_ucb_scores_match_pallas_interpret_and_oracle(n, K, d):
    w, Minv, ctx, occ = _inputs(n, K, d, seed=n * 100 + K)
    j_in = [jnp.asarray(a) for a in (w, Minv, ctx, occ)]
    want = np.asarray(jucb.ucb_scores(*j_in, 0.3, use_pallas=True,
                                      interpret=True))
    oracle = np.asarray(jucb_ref(*j_in, 0.3))
    before = dict(_build.LAUNCHES)
    got = ops.ucb_scores(*(torch.from_numpy(a) for a in (w, Minv, ctx, occ)),
                         0.3)
    assert _build.LAUNCHES == before            # CPU: the plain version
    assert got.shape == (n, K) and got.dtype == torch.float32
    # d-term f32 sums in another order: a few ulps of O(1) scores
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,K,d", [(37, 20, 25), (16, 12, 8)])
def test_argmax_of_scores_is_the_fused_choice(n, K, d):
    """Including exact duplicate candidates (k = 2, 5, 9), which must
    score bit-identically so that the first copy wins."""
    w, Minv, ctx, occ = _inputs(n, K, d, seed=7 + n)
    ctx[:, 5] = ctx[:, 2]
    ctx[:, 9] = ctx[:, 2]
    w[: n // 2] = 2.0 * ctx[: n // 2, 2]        # half the users favour k=2
    t = [torch.from_numpy(a) for a in (w, Minv, ctx, occ)]
    scores = ops.ucb_scores(*t, 0.3)
    assert torch.equal(scores[:, 5], scores[:, 2])
    assert torch.equal(scores[:, 9], scores[:, 2])
    first = torch.argmax(scores, dim=-1).to(torch.int32)
    choice, _ = interact_ops.choose(*t, 0.3)
    assert torch.equal(first, choice)
    assert bool((choice[: n // 2] == 2).all())


@pytest.mark.parametrize("n,K,d,sms,want", [
    (1, 20, 25, 132, ops.BLOCK_PER_USER),   # CLUB's call
    (264, 20, 25, 132, ops.BLOCK_PER_USER),  # two blocks on each of 132 SMs
    (265, 20, 25, 132, ops.REGISTER_TILE),
    (228, 20, 25, 114, ops.BLOCK_PER_USER),  # and of 114
    (229, 20, 25, 114, ops.REGISTER_TILE),
    (1, 20, 32, 132, ops.BLOCK_PER_USER),
    (1, 20, 33, 132, ops.WARP_PER_USER),
    (264, 20, 32, 132, ops.BLOCK_PER_USER),
    (265, 20, 32, 132, ops.REGISTER_TILE),
    (265, 20, 33, 132, ops.WARP_PER_USER),
    (256, 64, 25, 132, ops.BLOCK_PER_USER),  # topk's shortlist check
    (256, 64, 25, 114, ops.REGISTER_TILE),
    (1, 891, 32, 132, ops.BLOCK_PER_USER),  # the block's shared memory: full
    (1, 892, 32, 132, ops.WARP_PER_USER),
    (20480, 20, 25, 132, ops.REGISTER_TILE),  # rows 8 and 8b's shape
    (20480, 20, 25, 114, ops.REGISTER_TILE),
    (265, 256, 32, 132, ops.REGISTER_TILE),  # 128 threads a user: the edge
    (265, 257, 32, 132, ops.WARP_PER_USER),
])
def test_variant_at_its_limits(n, K, d, sms, want):
    """A block per user up to two users an SM, d = 32 and the block's
    shared memory (Minv, w, contexts and t-values: 4 (d^2 + d + 2 K d)
    bytes); past any of them choose's register tile where
    ``interact.ops.geometry`` takes the shape (d <= 32, ceil(K / 2)
    threads a user within a block of 128); a warp per user past that."""
    assert ops.variant(n, K, d, sms) == want


@pytest.mark.parametrize("n,K,d", [(265, 20, 25), (20480, 20, 25),
                                   (20480, 20, 32), (300, 7, 19),
                                   (300, 256, 32), (5000, 1, 1)])
@pytest.mark.parametrize("minv_bytes", [4, 2])
def test_tile_takes_chooses_geometry(n, K, d, minv_bytes):
    """Past the block per user, ucb takes the tile wherever choose's
    ``interact.ops.geometry`` does (for Minv's element size), with its
    users a block; their shared memory (``interact.ops.tile_smem``, the
    scores region included) fits the budget of four blocks an SM."""
    for sms in (132, 114):
        assert ops.variant(n, K, d, sms, minv_bytes) == ops.REGISTER_TILE
        kind, users = interact_ops.geometry(n, K, d, sms, minv_bytes)
        assert kind == interact_ops.REGISTER_TILE
        smem = interact_ops.tile_smem(users, K, d, minv_bytes)
        assert smem <= ops.MAX_SMEM
        if users > 1:
            assert interact_ops.TILE_BLOCKS_PER_SM * (
                smem + interact_ops.BLOCK_RESERVED) <= interact_ops.SM_SMEM


def test_tile_threads_bind_before_its_shared_memory():
    """At the tile's largest d, a user's 128 threads (K = 256) take far
    less than a block's shared memory, so the threads are the edge: the
    tile at K = 256, the warp per user at 257."""
    assert interact_ops.tile_smem(1, 256, 32) < ops.MAX_SMEM
    assert interact_ops.tile_smem(1, 256, 32, 2) < ops.MAX_SMEM
    assert ops.variant(265, 256, 32, 132, 2) == ops.REGISTER_TILE
    assert ops.variant(265, 257, 32, 132, 2) == ops.WARP_PER_USER


def _cu_constant(name, kind="int", source="ucb.cu"):
    """A constant of a kernel source, read from its text."""
    import re
    text = (_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr {kind} {name} = (\d+);",
                         text).group(1))


def test_wrapper_constants_match_the_kernel_source():
    """The wrapper's copies of csrc/ucb.cu's constants, of the tile's in
    csrc/ucb_tile.cuh (which choose.cu shares) and of csrc/stage.cuh's,
    and the launch's variant numbers in both launches."""
    assert ops.BLOCK_PER_USER_MAX_D == _cu_constant("kBlockMaxD")
    assert ops.MAX_SMEM == _cu_constant("kMaxSmem", "size_t", "stage.cuh")
    assert _cu_constant("kBlockThreads") == 256
    assert interact_ops.TILE_MAX_D == _cu_constant("kTileMaxD",
                                                   source="ucb_tile.cuh")
    assert interact_ops.TILE_THREADS == _cu_constant("kTileThreads",
                                                     source="ucb_tile.cuh")
    assert interact_ops.TILE_TK == _cu_constant("kTK", source="ucb_tile.cuh")
    for source in ("ucb.cu", "choose.cu"):
        assert '#include "ucb_tile.cuh"' in (_build.CSRC / source).read_text()
    text = (_build.CSRC / "ucb.cu").read_text()
    assert ("if (variant == 2) {" in text and "if (variant == 1) {" in text
            and "if (variant != 0)" in text)
    assert text.count("return launch(w, Minv, ctx, occ, alpha, n, K, d, "
                      "variant, users, scores,") == 2
    assert (ops.WARP_PER_USER, ops.BLOCK_PER_USER, ops.REGISTER_TILE) == (
        0, 1, 2)
    # the launch takes the variant and the tile's users after (n, K, d)
    assert _build.KERNELS["ucb"][2][5:10] == [_build._I] * 5
    assert _build.KERNELS["ucb_bf16"][2] == _build.KERNELS["ucb"][2]
