"""The port's EmbeddingBag (``repro_torch.kernels.embag``) and the embedding
module's ``bag_lookup`` / ``lookup`` against the reference's oracle and
its Pallas kernel in interpret mode, on the CPU.

rtol = atol = 1e-5 is the reference's own tolerance for this kernel
(``tests/test_kernels.py``): an L-term f32 sum, taken in another order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.embag import ops as jembag  # noqa: E402
from repro.kernels.embag.ref import embedding_bag_ref as jembag_ref  # noqa: E402
from repro.models.recsys import embedding as jembedding  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.embag import ops, ref  # noqa: E402
from repro_torch.models.recsys import embedding  # noqa: E402


def _inputs(V, D, B, L, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    wt = rng.random((B, L)).astype(np.float32)
    return table, idx, wt


@pytest.mark.parametrize("V,D,B,L", [(50, 8, 4, 3), (1000, 64, 16, 10),
                                     (128, 128, 8, 1)])
def test_embedding_bag_matches_reference_and_pallas_interpret(V, D, B, L):
    arrays = _inputs(V, D, B, L, V + B)
    j = [jnp.asarray(a) for a in arrays]
    want_ref = np.asarray(jembag_ref(*j))
    want_pallas = np.asarray(jembag.embedding_bag(*j, use_pallas=True,
                                                  interpret=True))
    _build.reset_launches()
    got = ops.embedding_bag(*(torch.from_numpy(a) for a in arrays))
    assert _build.LAUNCHES["embedding_bag"] == 0
    assert got.shape == (B, D) and got.dtype == torch.float32
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pad_slots_are_zero_weight():
    table = np.arange(20, dtype=np.float32).reshape(10, 2)
    idx = np.array([[1, 2, 0], [3, 0, 0]], np.int32)
    wt = np.array([[1.0, 1.0, 0.0], [2.0, 0.0, 0.0]], np.float32)
    want = np.asarray(jembag.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(wt),
        use_pallas=True, interpret=True))
    got = ops.embedding_bag(*(torch.from_numpy(a) for a in (table, idx, wt)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[0], table[1] + table[2])
    np.testing.assert_array_equal(got.numpy()[1], 2 * table[3])


def test_no_weights_is_a_plain_sum():
    table, idx, _ = _inputs(40, 8, 6, 5, 3)
    want = np.asarray(jembedding.bag_lookup(jnp.asarray(table),
                                            jnp.asarray(idx), use_pallas=False))
    got = embedding.bag_lookup(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), table[idx].sum(1), rtol=1e-5,
                               atol=1e-5)


def test_out_of_range_ids_follow_jnp_gather():
    """A negative id wraps once, then every id clamps to the table: the
    rule of the reference's jnp indexing, where torch's would raise."""
    V, D = 5, 3
    table = np.arange(V * D, dtype=np.float32).reshape(V, D)
    odd = np.array([-1, V, V + 7, -V - 3, -V, 2], np.int32)
    want_rows = np.asarray(jnp.asarray(table)[jnp.asarray(odd)])
    np.testing.assert_array_equal(want_rows, table[[4, 4, 4, 0, 0, 2]])
    t = torch.from_numpy(table)
    ids = torch.from_numpy(odd)
    np.testing.assert_array_equal(ref.wrap_ids(ids, V).numpy(),
                                  [4, 4, 4, 0, 0, 2])
    np.testing.assert_array_equal(embedding.lookup(t, ids).numpy(),
                                  want_rows)
    bags = odd.reshape(2, 3)
    wt = np.array([[1.0, 0.5, 2.0], [1.0, 1.0, 3.0]], np.float32)
    want = np.asarray(jembag.embedding_bag(
        jnp.asarray(table), jnp.asarray(bags), jnp.asarray(wt),
        use_pallas=False))
    got = embedding.bag_lookup(t, torch.from_numpy(bags),
                               torch.from_numpy(wt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_init_table_scale():
    g = torch.Generator().manual_seed(0)
    t = embedding.init_table(g, 4096, 16)
    assert t.shape == (4096, 16) and t.device.type == "cpu"
    assert abs(float(t.std()) - 16 ** -0.5) < 0.01


@pytest.mark.parametrize("B", [1, 512, 262144])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("D", [1, 8, 16, 25, 64, 128, 129])
def test_launch_geometry(D, aligned, B):
    """A warp per bag: G chunk lanes in each of S slot groups (G S = 32,
    G a power of two), 16-byte chunks only where D and the table allow;
    the chunks covered (in turn past 32); 512 bags in >= 128 blocks."""
    geo = ops.launch_geometry(D, B, aligned)
    assert geo.vec == (4 if D % 4 == 0 and aligned else 1)
    chunks = D // geo.vec
    assert geo.vec * chunks == D
    assert geo.g & (geo.g - 1) == 0 and 1 <= geo.g <= 32
    assert geo.g * geo.s == 32
    assert geo.g >= min(chunks, 32)
    assert geo.g == 1 or geo.g // 2 < chunks       # the least that covers
    passes = -(-chunks // geo.g)
    covered = {p * geo.g + lane for p in range(passes)
               for lane in range(geo.g)}
    assert set(range(chunks)) <= covered
    assert 1 <= geo.warps <= 8
    assert geo.blocks * geo.warps >= B > (geo.blocks - 1) * geo.warps
    if B == 512:
        assert geo.blocks >= 128


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
def test_step_slots_cover_each_slot_once(G):
    """The kernel's step (csrc/embag.cu): with kRows = 8 row loads a lane,
    slot group s takes slots s + k S of the step, whose id and weight lane
    s + S (k % G) holds in register k / G, the lane that loaded slot
    l + 32 i into register i.  Every slot of the step is taken once, by
    the G lanes of one group, from the lane that holds it."""
    k_rows, S = 8, 32 // G
    k_slots = k_rows * S
    k_ids = -(-k_slots // 32)
    held = {(lane, i): lane + 32 * i for lane in range(32)
            for i in range(k_ids) if lane + 32 * i < k_slots}
    taken = {}
    for lane in range(32):
        s = lane // G
        for k in range(k_rows):
            slot = held[(s + S * (k % G), k // G)]
            assert slot == s + k * S
            taken.setdefault(slot, set()).add(lane % G)
    assert sorted(taken) == list(range(k_slots))
    assert all(lanes == set(range(G)) for lanes in taken.values())


@pytest.mark.parametrize("L", [1, 31, 32, 33, 50, 100])
def test_embedding_bag_step_edges(L):
    """Bags around the kernel's step and id-window edges (32 ids a pass,
    64 slots a step at D = 16), with pads and ids out of range, against
    the reference's oracle and its Pallas kernel in interpret mode."""
    V, D, B = 40, 16, 3
    rng = np.random.default_rng(L)
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(-V - 5, V + 5, (B, L)).astype(np.int32)
    wt = rng.random((B, L)).astype(np.float32)
    wt[rng.random((B, L)) < 0.25] = 0.0
    j = [jnp.asarray(a) for a in (table, idx, wt)]
    got = ops.embedding_bag(*(torch.from_numpy(a) for a in (table, idx, wt)))
    for want in (jembag_ref(*j), jembag.embedding_bag(*j, use_pallas=True,
                                                      interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
