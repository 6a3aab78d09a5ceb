"""The port's streaming top-K (``repro_torch.kernels.topk``, plain
versions on the CPU) against ``repro.kernels.topk`` and the reference's
``RetrievalBackend`` on the same numpy inputs: shortlists, tie rules,
tile bounds and the cluster-pruned stream with its skip counts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core.backend import BackendConfig as JConfig  # noqa: E402
from repro.kernels.topk import ref as jref  # noqa: E402
from repro_torch.core.backend import BackendConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.topk import ops, ref  # noqa: E402


def _stats(rng, n, d, scale=0.1):
    w = rng.normal(size=(n, d)).astype(np.float32)
    A = scale * rng.normal(size=(n, d, d))
    Minv = (np.eye(d) + A @ A.transpose(0, 2, 1)).astype(np.float32)
    occ = rng.integers(0, 50, n).astype(np.int32)
    return w, Minv, occ


def _items(rng, N, d, p_dead=0.25):
    x = rng.normal(size=(N, d))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    live = (rng.random(N) > p_dead).astype(np.float32)
    return x, live


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _regions(rng, N, d, R=4, noise=0.02):
    """A region-structured catalog sorted by region, with its tiles."""
    c = rng.normal(size=(R, d))
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    reg = rng.integers(0, R, N)
    x = c[reg] + noise * rng.normal(size=(N, d))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    perm = np.argsort(reg, kind="stable").astype(np.int32)
    return x, perm, c


def _tiles(x_sorted, live_sorted, T):
    N, d = x_sorted.shape
    et = x_sorted.reshape(T, N // T, d).astype(np.float64)
    lt = live_sorted.reshape(T, N // T)
    cnt = lt.sum(1)
    mu = (et * lt[..., None]).sum(1) / np.maximum(cnt, 1)[:, None]
    r = np.where(lt > 0, np.linalg.norm(et - mu[:, None], axis=-1), 0).max(1)
    xn = np.where(lt > 0, np.linalg.norm(et, axis=-1), 0).max(1)
    return (mu.astype(np.float32), r.astype(np.float32),
            xn.astype(np.float32), cnt.astype(np.int32))


@pytest.mark.parametrize("n,d,N,k", [
    (10, 7, 70, 8),        # everything ragged
    (37, 19, 1000, 13),    # the card's small shape
    (5, 12, 260, 4),
    (6, 25, 40, 64),       # N < k_short: an underfull shortlist
])
def test_shortlist_matches_reference(n, d, N, k):
    rng = np.random.default_rng(n * 100 + d)
    w, Minv, occ = _stats(rng, n, d)
    x, live = _items(rng, N, d)
    jrb = JConfig.create("reference").retrieval(d, k, row_block=4,
                                                item_block=16)
    js, ji = jrb.shortlist(*(jnp.asarray(a) for a in (w, Minv, occ, x, live)),
                           0.3)
    before = dict(_build.LAUNCHES)
    rb = BackendConfig.create().retrieval(k)
    s, i = rb.shortlist(*_t(w, Minv, occ, x, live), 0.3)
    assert _build.LAUNCHES == before
    assert s.shape == (n, k) and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    fin = np.isfinite(np.asarray(js))
    np.testing.assert_array_equal(np.isfinite(s.numpy()), fin)
    np.testing.assert_allclose(s.numpy()[fin], np.asarray(js)[fin], rtol=0,
                               atol=1e-5)


def test_all_tied_prefers_lowest_live_ids():
    """w = 0 and occ = 0 score every item 0: the shortlist is the lowest
    LIVE ids in order."""
    n, d, N, k = 4, 8, 40, 6
    rng = np.random.default_rng(0)
    x, _ = _items(rng, N, d)
    live = np.ones(N, np.float32)
    live[[0, 2, 3]] = 0
    eye = np.broadcast_to(np.eye(d, dtype=np.float32), (n, d, d))
    _, ids = BackendConfig.create().retrieval(k).shortlist(
        *_t(np.zeros((n, d), np.float32), eye, np.zeros(n, np.int32), x,
            live), 0.3)
    np.testing.assert_array_equal(ids.numpy(),
                                  np.broadcast_to([1, 4, 5, 6, 7, 8], (n, k)))


def test_underfull_catalog_pads_with_minus_one():
    n, d, N, k = 3, 4, 5, 8
    x = np.eye(N, d, dtype=np.float32)
    live = np.ones(N, np.float32)
    live[4] = 0
    w, Minv, occ = _stats(np.random.default_rng(2), n, d)
    s, i = BackendConfig.create().retrieval(k).shortlist(
        *_t(w, Minv, occ, x, live), 0.3)
    assert (i.numpy()[:, 4:] == -1).all()
    assert not np.isfinite(s.numpy()[:, 4:]).any()
    assert (i.numpy()[:, :4] >= 0).all()


def test_row0_offsets_ids():
    n, d, N, k = 4, 8, 32, 4
    rng = np.random.default_rng(3)
    w, Minv, occ = _stats(rng, n, d)
    x, _ = _items(rng, N, d)
    live = np.ones(N, np.float32)
    rb = BackendConfig.create().retrieval(k)
    _, i0 = rb.shortlist(*_t(w, Minv, occ, x, live), 0.3)
    _, i7 = rb.shortlist(*_t(w, Minv, occ, x, live), 0.3, row0_items=7 * N)
    np.testing.assert_array_equal(i7.numpy(), i0.numpy() + 7 * N)


def test_select_topk_value_semantics():
    """-0.0 ties 0.0 (smaller id wins), the result ignores buffer order,
    and -inf fills the tail with the row's smallest id, as the
    reference's repeated selection does."""
    s = np.array([[0.0, -0.0, 1.0, -np.inf, 0.5, -np.inf]], np.float32)
    i = np.array([[7, 3, 9, 5, 2, 4]], np.int32)
    want_s, want_i = jref.select_topk(jnp.asarray(s), jnp.asarray(i), 6)
    for perm in ([0, 1, 2, 3, 4, 5], [5, 4, 3, 2, 1, 0], [2, 0, 4, 1, 5, 3]):
        got_s, got_i = ref.select_topk(*_t(s[:, perm], i[:, perm]), 6)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_i.tolist() == [[9, 2, 3, 7, 2, 2]]


def test_duplicate_items_tie_wherever_they_sit():
    """Identical rows score bit-identically in any tile, so the smaller id
    comes first and the shortlist does not depend on the tiling."""
    n, d, N, k = 9, 11, 300, 12
    rng = np.random.default_rng(5)
    w, Minv, occ = _stats(rng, n, d)
    x, _ = _items(rng, N, d)
    live = np.ones(N, np.float32)
    w[:] = 3.0 * x[17]                  # every user's best item is row 17
    for j in (5, 63, 64, 255, 299):
        x[j] = x[17]
    args = _t(w, Minv, occ, x, live)
    for block in (1, 7, 64, 4096):
        s, i = ref.topk_ref(*args, 0.3, k, item_block=block)
        np.testing.assert_array_equal(i.numpy()[:, :6],
                                      np.broadcast_to([5, 17, 63, 64, 255,
                                                       299], (n, 6)))
        assert (s[:, :6] == s[:, :1]).all()
        if block == 1:
            first = (s, i)
        assert torch.equal(s, first[0]) and torch.equal(i, first[1])


def test_tile_bounds_match_reference_and_dominate():
    n, d, N, T = 12, 16, 1024, 8
    rng = np.random.default_rng(0)
    w, Minv, occ = _stats(rng, n, d, scale=0.4)
    x, perm, _ = _regions(rng, N, d, noise=0.2)
    xs = x[perm]
    live = np.ones(N, np.float32)
    tiles = _tiles(xs, live, T)
    jtb = jref.tile_bounds(*(jnp.asarray(a) for a in (w, Minv, occ)), 0.3,
                           *(jnp.asarray(a) for a in tiles))
    tb = ref.tile_bounds(*_t(w, Minv, occ), 0.3, *_t(*tiles))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jtb), rtol=1e-5,
                               atol=1e-5)
    from repro_torch.kernels.interact.ref import ucb_scores_ref
    wt, Mt, ot, xt = _t(w, Minv, occ, xs)
    scores = ucb_scores_ref(wt, Mt, xt.expand(n, N, d), ot, 0.3)
    per_tile = scores.view(n, T, N // T).amax(dim=2)
    assert bool((per_tile <= tb).all())


@pytest.mark.parametrize("kind,N,tile,seed", [
    pytest.param("random", 512, 32, 1, id="random"),
    pytest.param("ties", 512, 32, 2, id="ties"),
    pytest.param("regions", 512, 32, 3, id="regions"),
    # tiles that do not divide the pruned kernel's 1024-row chunk (384:
    # two to a chunk) and tiles longer than it (2048: two slices each)
    pytest.param("regions", 6144, 384, 384, id="regions-tile384"),
    pytest.param("regions", 6144, 2048, 2048, id="regions-tile2048"),
])
def test_pruned_matches_reference_and_unpruned(kind, N, tile, seed):
    """Pruned plain == JAX ``topk_ref_pruned`` (ids AND skip counts) and
    bit-equal to the unpruned plain shortlist."""
    n, d, k = 13, 8, 6
    T = N // tile
    rng = np.random.default_rng(seed)
    w, Minv, occ = _stats(rng, n, d)
    if kind == "regions":
        x, perm, c = _regions(rng, N, d, R=8, noise=0.01)
        w = (2.0 * c[rng.integers(0, 8, n)]).astype(np.float32)
    else:
        x, _ = _items(rng, N, d, p_dead=0.0)
        perm = rng.permutation(N).astype(np.int32)
        if kind == "ties":
            x[1::3] = x[0::3][: len(x[1::3])]
    live = (rng.random(N) > 0.1).astype(np.float32)
    xs, ls = x[perm], live[perm]
    tiles = _tiles(xs, ls, T)
    tb = ref.tile_bounds(*_t(w, Minv, occ), 0.3, *_t(*tiles))
    js, ji, jsk, jtot = jref.topk_ref_pruned(
        *(jnp.asarray(a) for a in (w, Minv, occ, xs, ls, perm)), 0.3, k,
        jnp.asarray(tb.numpy()))
    s, i, sk, tot = ops.topk_pruned(*_t(w, Minv, occ, xs, ls, perm), 0.3, k,
                                    tb)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert (sk, tot) == (int(jsk), int(jtot))
    su, iu = ops.topk(*_t(w, Minv, occ, x, live), 0.3, k)
    assert torch.equal(s, su) and torch.equal(i, iu)
    if kind == "regions" and T > 3:     # 3 tiles span several regions each
        assert sk > 0


@pytest.mark.parametrize("tile,d,T,per_chunk,chunks", [
    (128, 25, 2048, 8, 256), (384, 25, 1024, 2, 512), (512, 25, 512, 2, 256),
    (1024, 25, 256, 1, 256), (2048, 25, 128, 1, 128), (512, 64, 512, 1, 512),
    (4, 25, 2**16, 32, 2048), (1, 25, 2**18, 32, 8192),
])
def test_pruned_chunk_plan(tile, d, T, per_chunk, chunks):
    """Tiles a pruned chunk gathers: whole tiles up to the 1024-row chunk
    (256 rows above d = 32), at most 32; one where a tile fills a chunk or
    is longer (its slices stream one a chunk).  The work ``launch_plan``
    sizes the splits by: the chunks of a group's T tiles."""
    assert ops.tiles_per_chunk(tile, d) == per_chunk
    assert per_chunk * tile <= ops.chunk_items(d) or per_chunk == 1
    assert ops.pruned_chunks(T, tile, d) == chunks


def test_walk_plan_is_the_plain_versions_walk():
    """The pruned wrapper's walk: the plain version's user order and
    per-group tile order, and each group's bounds laid out in that order
    (-inf past the last user), on a ragged last group."""
    n, T = 13, 16
    tb = torch.from_numpy(np.random.default_rng(4).normal(
        size=(n, T)).astype(np.float32))
    tb[3] = tb[5]                        # ties keep the stable order
    order, tile_order, tb_walk = ops.walk_plan(tb)
    assert torch.equal(order, torch.argsort(torch.argmax(tb, 1),
                                            stable=True))
    groups = -(-n // 8)
    assert order.dtype == tile_order.dtype == torch.int64
    assert tb_walk.is_contiguous()
    assert tile_order.shape == (groups, T) and tb_walk.shape == (groups, T, 8)
    for g in range(groups):
        users = order[8 * g: 8 * g + 8]
        best = tb[users].amax(dim=0)
        assert torch.equal(tile_order[g].long(),
                           torch.argsort(-best, stable=True))
        for j in range(T):
            t = int(tile_order[g, j])
            want = torch.full((8,), float("-inf"))
            want[:len(users)] = tb[users, t]
            assert torch.equal(tb_walk[g, j], want)


def test_kernel_limits_raise():
    """The CUDA wrappers refuse what the kernels do not handle; a CPU
    tensor runs the plain version, another device type raises."""
    with pytest.raises(ValueError, match="d <= 64"):
        ops._check_limits(65, 8)
    with pytest.raises(ValueError, match="k_short <= 128"):
        ops._check_limits(8, 129)
    w, Minv, occ = _t(*_stats(np.random.default_rng(0), 2, 3))
    x = torch.ones(4, 3)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.topk(w.to("meta"), Minv, occ, x, torch.ones(4), 0.3, 2)


def _cu_constant(name):
    """An ``int`` constant of csrc/topk.cu, read from its source text."""
    import re
    text = (_build.CSRC / "topk.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("groups,work,sms,per_sm", [
    (32, 512, 132, 1), (32, 512, 132, 2), (1, 3, 132, 1), (1, 512, 132, 1),
    (32, 2, 132, 1), (256, 512, 132, 2), (300, 512, 132, 1),
    (2640, 10, 132, 2), (200, 4, 132, 1), (17, 1, 132, 1), (0, 0, 132, 1),
])
def test_launch_plan_fills_whole_waves(groups, work, sms, per_sm):
    """Every split has work (S <= chunks or tiles) and the grid fits in one
    wave of the resident blocks, or fills whole waves, or, where no split
    count up to the work makes whole waves, fills its last wave best."""
    S = ops.launch_plan(groups, work, sms, per_sm)
    slots = sms * per_sm
    assert 1 <= S <= max(work, 1)
    blocks = groups * S
    if groups <= slots:
        assert blocks <= slots
        assert S == max(1, min(work, slots // max(groups, 1)))
    else:
        fills = [groups * s % slots == 0 for s in range(1, work + 1)]
        if any(fills):
            assert blocks % slots == 0 and fills.index(True) + 1 == S
        else:
            def fill(s):
                return groups * s / (-(-groups * s // slots) * slots)
            assert fill(S) == max(fill(s) for s in range(1, work + 1))


def test_launch_plan_at_the_serving_batch():
    """256 users (32 groups) against 2^18 items at one block per SM of
    132: 4 splits, 128 blocks in one wave, 64 chunks each."""
    chunks = -(-2**18 // ops.chunk_items(25))
    assert chunks == 256
    assert ops.launch_plan(32, chunks, 132, 1) == 4


def test_launch_plan_at_the_pruned_serving_batch():
    """The pruned serving batch: 32 groups, 512 tiles of 512 items, two
    tiles a chunk: 256 chunks a group, 4 splits at one block per SM of
    132, 128 blocks in one wave, as the unpruned kernel's grid."""
    chunks = ops.pruned_chunks(2**18 // 512, 512, 25)
    assert chunks == 256
    assert ops.launch_plan(32, chunks, 132, 1) == 4


def test_wrapper_constants_match_the_kernel_source():
    """The wrapper's copies of csrc/topk.cu's constants."""
    assert ops.USERS_PER_BLOCK == _cu_constant("kUsers")
    assert ops.THREADS == _cu_constant("kThreads")
    assert ops.MAX_K == _cu_constant("kMaxK")
    assert ops.MAX_D == _cu_constant("kMaxD")
    assert ops.SMALL_D == _cu_constant("kSmallD")
    assert ops.MAX_TILES == _cu_constant("kMaxTiles")
    text = (_build.CSRC / "topk.cu").read_text()
    # chunk_items follows items_per_thread, the one count of both kernels:
    # 4 items a thread up to SMALL_D, 1 above
    assert "return d <= kSmallD ? 4 : 1;" in text
    assert "tk_pruned" not in text and "XI_SHARED" not in text
    assert ops.chunk_items(ops.SMALL_D) == 4 * ops.THREADS
    assert ops.chunk_items(ops.SMALL_D + 1) == ops.THREADS


def test_ptxas_usage_reads_registers_and_spills():
    """The parser behind chip_smoke.py's spill check, on a report in the
    format ``nvcc -Xptxas -v`` prints."""
    report = "\n".join([
        "ptxas info    : Compiling entry function '_Z1fv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1fv",
        "    8 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1gv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 8 bytes smem",
    ])
    assert _build.ptxas_usage(report) == {"_Z1fv": (64, 16, 12),
                                          "_Z1gv": (255, 0, 0)}
