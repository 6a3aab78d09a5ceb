"""The port's bit-packed graph engine (``repro_torch.kernels.graph``,
``core.clustering``, ``runtime.stages.connected_components``) against
the reference's packing, its Pallas prune / CC-hop kernels in interpret
mode and its dense oracles, on the CPU.  Packed words are compared as
uint32 through ``numpy.view``; everything here is exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import clustering as jclustering  # noqa: E402
from repro.kernels.graph import ops as jgraph  # noqa: E402
from repro_torch.core import clustering  # noqa: E402
from repro_torch.core.backend import BackendConfig  # noqa: E402
from repro_torch.kernels.graph import ops  # noqa: E402
from repro_torch.runtime import stages  # noqa: E402
from repro_torch.runtime.collectives import NullCollectives  # noqa: E402


def random_sym_adj(rng, n, p):
    a = np.triu(rng.random((n, n)) < p, 1)
    return a | a.T


def chain_adj(n):
    a = np.zeros((n, n), bool)
    i = np.arange(n - 1)
    a[i, i + 1] = a[i + 1, i] = True
    return a


def as_u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n", [31, 32, 33, 37, 64])
def test_packing_is_bit_equal_to_reference(n):
    rng = np.random.default_rng(n)
    dense = random_sym_adj(rng, n, 0.5)
    dense[0, :] = True                      # bit 31 set in full words
    packed = ops.pack_bits(torch.from_numpy(dense))
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(as_u32(packed),
                                  np.asarray(jgraph.pack_bits(
                                      jnp.asarray(dense))))
    np.testing.assert_array_equal(ops.unpack_bits(packed, n).numpy(), dense)
    np.testing.assert_array_equal(as_u32(ops.init_packed_adj(n, n)),
                                  np.asarray(jgraph.init_packed_adj(n, n)))


def test_init_packed_adj_row_offset_matches_reference():
    n, n_local, off = 64, 16, 16
    np.testing.assert_array_equal(
        as_u32(ops.init_packed_adj(n_local, n, row_offset=off)),
        np.asarray(jgraph.init_packed_adj(n_local, n, row_offset=off)))


@pytest.mark.parametrize("n,d", [(37, 5), (70, 8), (33, 19)])
def test_prune_is_bit_equal_to_pallas_interpret(n, d):
    rng = np.random.default_rng(n * 10 + d)
    v = rng.normal(size=(n, d)).astype(np.float32)
    occ = rng.integers(0, 100, n).astype(np.int32)
    gamma = 1.2
    dense = random_sym_adj(rng, n, 0.7)
    cb = clustering.cb_width(torch.from_numpy(occ)).numpy()
    # XLA and torch may round |vi|^2 + |vj|^2 - 2 vi.vj differently: keep
    # every pair well away from the dist < thresh boundary
    v64 = v.astype(np.float64)
    dist = np.linalg.norm(v64[:, None] - v64[None, :], axis=-1)
    thresh = gamma * (cb[:, None] + cb[None, :])
    margin = np.abs(dist - thresh)[~np.eye(n, dtype=bool)].min()
    assert margin > 1e-4, margin

    packed = jgraph.pack_bits(jnp.asarray(dense))
    want = jgraph.prune_packed(packed, jnp.asarray(v), jnp.asarray(cb),
                               jnp.asarray(v), jnp.asarray(cb), gamma,
                               use_pallas=True, interpret=True, block_i=8,
                               block_j=32)
    tp = torch.from_numpy(np.array(packed).view(np.int32))
    tv, tcb = torch.from_numpy(v), torch.from_numpy(cb)
    got = ops.prune_packed(tp, tv, tcb, tv, tcb, gamma)
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))
    assert not bool((got & ~tp).any())      # pruning only clears bits
    # the backend computes the widths itself; the dense oracle agrees
    gb = BackendConfig.create().graph(n)
    tocc = torch.from_numpy(occ)
    got_gb = gb.prune_rows(tp, tv, tocc, tv, tocc, gamma)
    np.testing.assert_array_equal(got_gb.numpy(), got.numpy())
    np.testing.assert_array_equal(
        gb.unpack(got_gb).numpy(),
        clustering.prune_edges(torch.from_numpy(dense), tv,
                               torch.from_numpy(occ), gamma).numpy())


@pytest.mark.parametrize("n,p,seed", [(60, 0.02, 0), (96, 0.05, 1),
                                      (33, 0.3, 2), (70, 1.0, 3),
                                      (943, 0.01, 4), (1888, 0.004, 5)])
def test_cc_hop_is_label_equal_to_pallas_interpret(n, p, seed):
    """Full graphs (p = 1) and the paper datasets' ragged row lengths
    (n = 943, 1888: W = 30, 59) among the cases; each graph as drawn and
    with every third row empty; the whole rows, a row shard, and a row
    view whose first word lies off a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    dense = random_sym_adj(rng, n, p)
    labels = rng.permutation(n).astype(np.int32)
    tl = torch.from_numpy(labels)
    blocks = ({"block_i": 8, "block_j": 32} if n < 128
              else {"block_i": 256, "block_j": 1024})
    empty = np.arange(n)[:, None] % 3 == 0
    for adj in (dense, dense & ~empty):
        packed = jgraph.pack_bits(jnp.asarray(adj))
        want = np.asarray(jgraph.cc_hop_packed(
            packed, jnp.asarray(labels), jnp.asarray(labels),
            use_pallas=True, interpret=True, **blocks))
        tp = torch.from_numpy(np.array(packed).view(np.int32))
        got = ops.cc_hop_packed(tp, tl, tl)
        np.testing.assert_array_equal(got.numpy(), want)
        # row shards against the full label vector (bipartite rows); rows
        # from 1 start 4 W bytes in, off a 16-byte boundary (W % 4 != 0)
        W = tp.shape[1]
        assert W % 4
        for off, n_local in ((16, 16), (1, n // 2)):
            got_rows = ops.cc_hop_packed(tp[off:off + n_local],
                                         tl[off:off + n_local], tl)
            np.testing.assert_array_equal(got_rows.numpy(),
                                          want[off:off + n_local])


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("R,W,ptr,vec", [
    (20480, 640, 0, 4),             # the main path: 16-byte loads
    (20480, 640, 3 * 4 * 640, 4),   # rows from 3: still 16-byte aligned
    (20480, 640, 4, 1),             # a buffer's view 4 bytes off 16
    (20480, 640, 8, 2),             # and 8
    (943, 30, 0, 2),                # W = 30: 8-byte loads
    (943, 30, 4 * 30, 2),           # rows from 1
    (943, 30, 4, 1),
    (1888, 59, 0, 1),               # W = 59: 4-byte loads
    (5045, 158, 4 * 158, 2),
    (20000, 625, 4 * 625, 1),
    (512, 16, 0, 4),                # serving's item-cluster anchors
    (700, 625, 0, 1),               # a row shard
    (1, 1, 0, 1),
])
def test_cc_hop_geometry(R, W, ptr, vec, sms):
    """The widest load that divides W and that the base address admits,
    so that every row starts on one; a warp for each row up to
    CC_BLOCKS_PER_SM blocks an SM, no block without a row."""
    got_vec, blocks = ops.cc_hop_geometry(R, W, ptr, sms)
    assert got_vec == vec
    assert W % vec == 0 and ptr % (4 * vec) == 0
    assert all((ptr + 4 * W * r) % (4 * vec) == 0 for r in range(4))
    assert blocks == min(-(-R // ops.CC_WARPS), ops.CC_BLOCKS_PER_SM * sms)
    assert 1 <= blocks <= ops.CC_BLOCKS_PER_SM * sms
    assert (blocks - 1) * ops.CC_WARPS < R


def test_cc_hop_geometry_matches_the_kernel_source():
    """The wrapper's copies of csrc/cc_hop.cu's block shape and launch
    bounds, and the launch's arguments: three pointers, R, W, C, the load
    width, the grid and the dense threshold."""
    from repro_torch.kernels import _build
    assert int(_cu_constant("kWarps", "cc_hop.cu")) == ops.CC_WARPS
    assert int(_cu_constant("kBlocksPerSm", "cc_hop.cu")) \
        == ops.CC_BLOCKS_PER_SM
    assert 0 <= ops.CC_DENSE_MIN < 32
    _, entry, argtypes = _build.KERNELS["cc_hop"]
    assert entry == "cc_hop_launch"
    assert argtypes[3:9] == [_build._I] * 6


@pytest.mark.parametrize("maker,n", [
    ("random_sparse", 60), ("random_dense", 75), ("chain", 300),
    ("chain", 64), ("empty", 40),
])
def test_connected_components_match_dense_oracle(maker, n):
    rng = np.random.default_rng(n)
    dense = {"random_sparse": lambda: random_sym_adj(rng, n, 0.02),
             "random_dense": lambda: random_sym_adj(rng, n, 0.3),
             "chain": lambda: chain_adj(n),
             "empty": lambda: np.zeros((n, n), bool)}[maker]()
    want = np.asarray(jclustering.connected_components(jnp.asarray(dense)))
    gb = BackendConfig.create().graph(n)
    packed = gb.pack(torch.from_numpy(dense))
    got = stages.connected_components(NullCollectives(), gb, packed, n, 0, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        clustering.connected_components(torch.from_numpy(dense)).numpy(),
        want)
    assert int(clustering.num_clusters(got)) == int(
        jclustering.num_clusters(jnp.asarray(want)))


def _cu_constant(name, source="prune.cu"):
    """An ``int`` constant of a csrc source, read from its text."""
    import re
    from repro_torch.kernels import _build
    text = (_build.CSRC / source).read_text()
    return re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)


def test_prune_geometry_matches_the_kernel_source():
    """The wrapper's copies of csrc/prune.cu's tile and threshold
    constants, and the sparse threshold within the kernel's list."""
    assert int(_cu_constant("kThreads")) == 256
    assert int(_cu_constant("kRowsPerWarp")) == ops.ROWS_PER_WARP
    assert int(_cu_constant("kWords")) == ops.WORDS_PER_BLOCK
    assert _cu_constant("kRows") == "kWarps * kRowsPerWarp"
    assert 256 // 32 * ops.ROWS_PER_WARP == ops.ROWS_PER_BLOCK
    assert _cu_constant("kSparseCap") == "32 * kSparseRounds"
    assert 32 * int(_cu_constant("kSparseRounds")) == ops.SPARSE_CAP
    assert 0 <= ops.SPARSE_MAX <= ops.SPARSE_CAP


@pytest.mark.parametrize("R,W,d,want", [
    (20480, 640, 25, 26 * (20480 + 20480)),
    (1, 1, 1, 2 * (128 + 128)),
    (129, 5, 3, 4 * (256 + 256)),
    (33, 2, 40, 41 * (128 + 128)),
])
def test_prune_work_floats(R, W, d, want):
    """The scratch the wrapper allocates: both vector sets transposed and
    their squared norms, rows padded to 128 and columns to 128 (4 words),
    as prune_launch lays it out."""
    assert ops.prune_work_floats(R, W, d) == want


@pytest.mark.parametrize("R,C,p,seed", [
    (16, 128, 0.5, 0), (33, 300, 0.1, 1), (130, 1000, 0.02, 2),
    (1, 1, 1.0, 3), (200, 64, 0.9, 4),
])
def test_warp_tile_bits_counts_each_warps_tile(R, C, p, seed):
    """The set bits of each 16-row by 4-word tile, counted on the unpacked
    bits, ragged edges padded with empty rows and words."""
    dense = np.random.default_rng(seed).random((R, C)) < p
    got = ops.warp_tile_bits(ops.pack_bits(torch.from_numpy(dense)))
    rows = ops.ROWS_PER_WARP
    cols = 32 * ops.WORDS_PER_BLOCK
    want = np.zeros((-(-R // rows), -(-C // cols)), np.int64)
    for i, j in zip(*np.nonzero(dense)):
        want[i // rows, j // cols] += 1
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int(dense.sum())
