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
    (265, 20, 25, 132, ops.WARP_PER_USER),
    (228, 20, 25, 114, ops.BLOCK_PER_USER),  # and of 114
    (229, 20, 25, 114, ops.WARP_PER_USER),
    (1, 20, 32, 132, ops.BLOCK_PER_USER),
    (1, 20, 33, 132, ops.WARP_PER_USER),
    (264, 20, 32, 132, ops.BLOCK_PER_USER),
    (265, 20, 33, 132, ops.WARP_PER_USER),
    (256, 64, 25, 132, ops.BLOCK_PER_USER),  # topk's shortlist check
    (256, 64, 25, 114, ops.WARP_PER_USER),
    (1, 891, 32, 132, ops.BLOCK_PER_USER),  # the block's shared memory: full
    (1, 892, 32, 132, ops.WARP_PER_USER),
])
def test_variant_at_its_limits(n, K, d, sms, want):
    """A block per user up to two users an SM, d = 32 and the block's
    shared memory (Minv, w, contexts and t-values: 4 (d^2 + d + 2 K d)
    bytes); a warp per user past any of them."""
    assert ops.variant(n, K, d, sms) == want


def _cu_constant(name, kind="int"):
    """A constant of csrc/ucb.cu, read from its source text."""
    import re
    text = (_build.CSRC / "ucb.cu").read_text()
    return int(re.search(rf"constexpr {kind} {name} = (\d+);",
                         text).group(1))


def test_wrapper_constants_match_the_kernel_source():
    """The wrapper's copies of csrc/ucb.cu's constants, and the launch's
    variant numbers."""
    assert ops.BLOCK_PER_USER_MAX_D == _cu_constant("kBlockMaxD")
    assert ops.MAX_SMEM == _cu_constant("kMaxSmem", "size_t")
    assert _cu_constant("kBlockThreads") == 256
    text = (_build.CSRC / "ucb.cu").read_text()
    assert "if (variant == 1) {" in text and "if (variant != 0)" in text
    assert (ops.WARP_PER_USER, ops.BLOCK_PER_USER) == (0, 1)
    # the launch takes the variant after (n, K, d)
    assert _build.KERNELS["ucb"][2][5:9] == [_build._I] * 4
