"""The port's rank-1 updates (``repro_torch.kernels.rank1``), M-free and
M-ful, against the reference's Pallas kernels in interpret mode, on the
CPU; and ``InteractBackend.update_lin`` against the reference's engine."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rank1 import ops as jrank1  # noqa: E402
from repro_torch.kernels.rank1 import ops  # noqa: E402


@pytest.mark.parametrize("n,d", [(37, 25), (64, 32), (5, 3)])
def test_rank1_update_inv_matches_pallas_interpret(n, d):
    rng = np.random.default_rng(n + d)
    A = 0.1 * rng.normal(size=(n, d, d))
    Minv = np.linalg.inv(np.eye(d) + A @ A.transpose(0, 2, 1)).astype(
        np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    r = rng.random(n).astype(np.float32)
    mask = rng.random(n) < 0.7
    mask[0], mask[-1] = True, False

    want = jrank1.rank1_update_inv(*(jnp.asarray(a) for a in
                                     (Minv, b, x, r, mask)),
                                   use_pallas=True, interpret=True)
    inputs = [torch.from_numpy(a.copy()) for a in (Minv, b, x, r, mask)]
    got = ops.rank1_update_inv(*inputs)
    # the reference's own tolerance for this kernel (tests/test_interact.py)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=3e-5,
                                   atol=3e-5)
    # masked-out users are identity updates, bit for bit
    np.testing.assert_array_equal(got[0].numpy()[~mask], Minv[~mask])
    np.testing.assert_array_equal(got[1].numpy()[~mask], b[~mask])
    # Minv and b are updated in place on the CPU too, as the kernel does
    assert got[0] is inputs[0] and got[1] is inputs[1]
    assert not np.array_equal(inputs[0].numpy()[mask], Minv[mask])


def _mful_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    A = 0.1 * rng.normal(size=(n, d, d))
    M = (np.eye(d) + A @ A.transpose(0, 2, 1)).astype(np.float32)
    Minv = np.linalg.inv(M).astype(np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    r = rng.random(n).astype(np.float32)
    mask = rng.random(n) < 0.7
    mask[0], mask[-1] = True, False
    return M, Minv, b, x, r, mask


def _assert_mful_close(got, want):
    """Minv: the Sherman-Morrison tolerance; M and b: one rounding of
    ``M + x x^T`` / ``b + r x`` (XLA may contract them into FMAs)."""
    M, Minv, b = (np.asarray(a) for a in want)
    np.testing.assert_allclose(got[0], M, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1], Minv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2], b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,d", [(37, 25), (64, 32), (5, 3), (1, 25)])
def test_rank1_update_matches_pallas_interpret(n, d):
    M, Minv, b, x, r, mask = _mful_inputs(n, d, seed=3 * n + d)
    if n == 1:
        mask[0] = True
    want = jrank1.rank1_update(*(jnp.asarray(a) for a in
                                 (M, Minv, b, x, r, mask)),
                               use_pallas=True, interpret=True)
    inputs = [torch.from_numpy(a.copy()) for a in (M, Minv, b, x, r, mask)]
    got = ops.rank1_update(*inputs)
    _assert_mful_close([g.numpy() for g in got], want)
    # in place, as the kernel does
    assert all(g is i for g, i in zip(got, inputs[:3]))
    # masked-out users are identity updates, bit for bit
    for g, a in zip(got, (M, Minv, b)):
        np.testing.assert_array_equal(g.numpy()[~mask], a[~mask])


def test_rank1_update_writes_through_a_row_view():
    """CLUB updates one user's row of the full state: a leading-dim slice
    is updated in place and the other rows are left as they were."""
    n, d, u = 9, 6, 4
    M, Minv, b, x, r, _ = _mful_inputs(n, d, seed=11)
    state = [torch.from_numpy(a.copy()) for a in (M, Minv, b)]
    rows = [t[u:u + 1] for t in state]
    live = torch.ones(1, dtype=torch.bool)
    ops.rank1_update(*rows, torch.from_numpy(x[u:u + 1]),
                     torch.from_numpy(r[u:u + 1]), live)
    want = jrank1.rank1_update(*(jnp.asarray(a[u:u + 1]) for a in
                                 (M, Minv, b, x, r)), jnp.ones(1, bool),
                               use_pallas=True, interpret=True)
    _assert_mful_close([t.numpy()[u:u + 1] for t in state], want)
    for t, a in zip(state, (M, Minv, b)):
        np.testing.assert_array_equal(np.delete(t.numpy(), u, 0),
                                      np.delete(a, u, 0))


def test_update_lin_matches_the_reference_pallas_engine():
    from repro.core import backend as jbackend
    from repro.core.types import LinUCBState as JLin
    from repro_torch.core.backend import BackendConfig
    from repro_torch.core.types import LinUCBState
    n, d = 37, 25
    M, Minv, b, x, r, mask = _mful_inputs(n, d, seed=5)
    occ = np.random.default_rng(5).integers(0, 50, n).astype(np.int32)
    jbe = jbackend.BackendConfig.create("pallas").interact(n, d, 20,
                                                            interpret=True)
    want = jbe.update_lin(JLin(*(jnp.asarray(a) for a in (M, Minv, b, occ))),
                          jnp.asarray(x), jnp.asarray(r), jnp.asarray(mask))
    lin = LinUCBState(*(torch.from_numpy(a.copy()) for a in (M, Minv, b,
                                                              occ)))
    got = BackendConfig.create().interact().update_lin(
        lin, *(torch.from_numpy(a) for a in (x, r, mask)))
    _assert_mful_close([t.numpy() for t in got[:3]], want[:3])
    np.testing.assert_array_equal(got.occ.numpy(), np.asarray(want.occ))
    assert all(g is i for g, i in zip(got, lin))     # all four in place


@pytest.mark.parametrize("n,d,sms,want", [
    (1, 25, 132, ops.BLOCK_PER_USER),            # CLUB's user and cluster rows
    (1, 32, 132, ops.BLOCK_PER_USER),
    (264, 25, 132, ops.BLOCK_PER_USER),          # two blocks an SM, 132 SMs
    (265, 25, 132, ops.WARP_PER_USER),
    (228, 25, 114, ops.BLOCK_PER_USER),          # and of 114
    (229, 25, 114, ops.WARP_PER_USER),
    (264, 25, 114, ops.WARP_PER_USER),
    (20480, 25, 132, ops.WARP_PER_USER),         # the M-ful update there
    (1, 33, 132, ops.WARP_PER_USER),             # d^2 > 4 a thread
    (1, 33, 114, ops.WARP_PER_USER),
])
def test_variant_choice(n, d, sms, want):
    """The M-ful update: a block per user up to two an SM at d <= 32,
    else a warp per user."""
    assert ops.variant(n, d, sms) == want


@pytest.mark.parametrize("n,d,sms,want", [
    (1, 25, 132, ops.BLOCK_PER_USER),
    (264, 25, 132, ops.BLOCK_PER_USER),
    (265, 25, 132, ops.STAGED_SPAN),
    (228, 25, 114, ops.BLOCK_PER_USER),
    (229, 25, 114, ops.STAGED_SPAN),
    (20480, 25, 132, ops.STAGED_SPAN),           # DistCLUB's rounds
    (20480, 25, 114, ops.STAGED_SPAN),
    (20480, 32, 132, ops.STAGED_SPAN),
    (20480, 1, 132, ops.STAGED_SPAN),            # a word over 4-8 users
    (20480, 2, 114, ops.STAGED_SPAN),
    (20480, 33, 132, ops.WARP_PER_USER),         # a user's rows past a warp
    (1, 33, 132, ops.WARP_PER_USER),
])
@pytest.mark.parametrize("minv_bytes", [4, 2])
def test_variant_choice_of_the_m_free_update(n, d, sms, want, minv_bytes):
    """The M-free update (``inv_variant``): the block per user where the
    M-ful update takes it, else the staged span at d <= 32 (its spans fit
    a block's shared memory there), else a warp per user; the M-ful
    update keeps the warp per user wherever the M-free takes the span."""
    assert ops.inv_variant(n, d, sms, minv_bytes) == want
    if want == ops.STAGED_SPAN:
        assert ops.variant(n, d, sms) == ops.WARP_PER_USER


@pytest.mark.parametrize("d,minv_bytes", [
    (25, 4), (25, 2), (32, 4), (32, 2), (8, 4), (1, 2)])
def test_span_smem(d, minv_bytes):
    """A staged-span block's shared memory: its group's spans of
    ``SPAN_USERS`` users, each region whole 16-byte words with room for
    the copy's shift, then 34 words a user; within a block's at most,
    and ``SPAN_BLOCKS_PER_SM`` blocks (the kernel's launch bounds) fit an
    SM at every d <= 32."""
    from repro_torch.kernels import _build
    users = ops.SPAN_USERS
    def words(nbytes):
        return -(-nbytes // 16) * 16
    one = ops.span_smem(d, minv_bytes)
    assert one == (words(minv_bytes * (users * d * d + 16 // minv_bytes - 1))
                   + 2 * words(4 * (users * d + 3)) + 4 * 34 * users)
    assert one <= _build.MAX_SMEM
    assert ops.SPAN_BLOCKS_PER_SM * (
        ops.span_smem(ops.SPAN_MAX_D, minv_bytes)
        + _build.BLOCK_RESERVED) <= _build.SM_SMEM


@pytest.mark.parametrize("d", [1, 2, 3])
def test_small_d_alternating_masks_match_pallas_interpret(d):
    """The staged span's smallest widths, where one 16-byte word holds
    several users' blocks (4-8 at d = 1, 1-2 at d = 2): live and masked
    users alternate, one masked user among live ones and one live among
    masked; masked users' rows bit-identical, live ones as the reference
    has them."""
    n = 37
    rng = np.random.default_rng(100 + d)
    A = 0.1 * rng.normal(size=(n, d, d))
    Minv = np.linalg.inv(np.eye(d) + A @ A.transpose(0, 2, 1)).astype(
        np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    r = rng.random(n).astype(np.float32)
    mask = np.arange(n) % 2 == 0
    mask[20:27] = False
    mask[23] = True
    mask[28:35] = True
    mask[31] = False
    want = jrank1.rank1_update_inv(*(jnp.asarray(a) for a in
                                     (Minv, b, x, r, mask)),
                                   use_pallas=True, interpret=True)
    got = ops.rank1_update_inv(*(torch.from_numpy(a.copy()) for a in
                                 (Minv, b, x, r, mask)))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=3e-5,
                                   atol=3e-5)
    np.testing.assert_array_equal(got[0].numpy()[~mask], Minv[~mask])
    np.testing.assert_array_equal(got[1].numpy()[~mask], b[~mask])
    assert not np.array_equal(got[0].numpy()[mask], Minv[mask])


def _cu_constant(name):
    """A constant of csrc/rank1.cu, read from its source text."""
    import re
    from repro_torch.kernels import _build
    text = (_build.CSRC / "rank1.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_span_constants_match_the_kernel_source():
    """The wrapper's copies of the staged span's constants in
    csrc/rank1.cu, its variant number, and the launches' arguments: the
    variant after (n, d), for the M-free and the M-ful updates alike."""
    from repro_torch.kernels import _build
    assert ops.SPAN_MAX_D == _cu_constant("kSpanMaxD")
    assert ops.SPAN_USERS == _cu_constant("kSpanWarps")
    assert ops.SPAN_BLOCKS_PER_SM == _cu_constant("kSpanMinBlocks")
    text = (_build.CSRC / "rank1.cu").read_text()
    assert "if (variant == 2) {" in text
    assert '#include "stage.cuh"' in text
    assert (ops.WARP_PER_USER, ops.BLOCK_PER_USER, ops.STAGED_SPAN) == (
        0, 1, 2)
    for name in ("rank1_update_inv", "rank1_update_inv_bf16"):
        assert _build.KERNELS[name][2][5:] == [_build._I] * 3 + [_build._P]
    for name in ("rank1_update", "rank1_update_bf16"):
        assert _build.KERNELS[name][2][6:] == [_build._I] * 3 + [_build._P]


def test_club_row_views_take_the_block_variant():
    """CLUB's two updates an interaction: the user's row views of the
    full state and the cluster's, both n = 1 at the paper's d = 25.  The
    full state takes the staged span for the M-free update and the warp
    per user for the M-ful one."""
    n, d, u = 20480, 25, 4321
    b = torch.zeros(n, d)
    for sms in (132, 114):
        assert ops.variant(*b[u:u + 1].shape, sms) == ops.BLOCK_PER_USER
        assert ops.inv_variant(*b[u:u + 1].shape,
                               sms) == ops.BLOCK_PER_USER
        assert ops.variant(*b.shape, sms) == ops.WARP_PER_USER
        assert ops.inv_variant(*b.shape, sms) == ops.STAGED_SPAN
