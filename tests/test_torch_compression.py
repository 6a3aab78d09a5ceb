"""The port's int8 gradient compression
(``repro_torch.distributed.compression``) against ``repro``'s on the
CPU, on tensors made with numpy from a seed: the codes and scales bit
for bit (an element count a multiple of the block and one that is not,
an all-zero tensor, exact ties on the rounding), the decompressed values,
three rounds of error feedback over a tree, and the size ratio."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.distributed import compression as jcomp  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("shape", [(4, 256), (3, 7, 41), (0,)],
                         ids=["whole_blocks", "ragged", "empty"])
def test_compress_is_bit_equal_to_reference(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got, want = compression.compress(_t(x)), jcomp.compress(jnp.asarray(x))
    assert got.n == want.n == x.size
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    back = compression.decompress(got, shape)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcomp.decompress(want, shape)))


def test_all_zero_tensor_and_ties_match_reference():
    """An all-zero tensor takes the 1e-12 scale floor and codes 0; a block
    whose largest value is 127 has scale 1, so its halves are exact ties,
    rounded to even as ``jnp.round`` rounds them."""
    zeros = np.zeros((5, 100), np.float32)
    halves = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 127.0], np.float32)
    for x in (zeros, halves):
        got, want = compression.compress(_t(x)), jcomp.compress(jnp.asarray(x))
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
    assert float(compression.compress(_t(zeros)).scale[0]) == np.float32(1e-12)
    assert not compression.compress(_t(zeros)).q.any()
    assert compression.compress(_t(halves)).q[:7].tolist() == [
        0, 2, 2, 0, -2, 4, 127]


def test_decompress_keeps_dtype_and_bound():
    x = np.random.default_rng(1).normal(size=(9, 300)).astype(np.float32)
    c = compression.compress(_t(x))
    back = compression.decompress(c, x.shape, torch.bfloat16)
    want = jcomp.decompress(jcomp.compress(jnp.asarray(x)), x.shape,
                            jnp.bfloat16)
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(want, np.float32))
    # each value within half a code step of its block's scale
    err = np.abs(compression.decompress(c, x.shape).numpy() - x)
    step = np.repeat(c.scale.numpy(), compression.BLOCK)[:x.size]
    assert (err.reshape(-1) <= 0.5 * step * (1 + 1e-6)).all()


def test_error_feedback_rounds_match_reference():
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 100), "b": {"c": (513,)}}
    grads_np = [{"a": rng.normal(size=shapes["a"]).astype(np.float32),
                 "b": {"c": rng.normal(size=shapes["b"]["c"])
                       .astype(np.float32)}} for _ in range(3)]
    params = {"a": torch.zeros(3, 100), "b": {"c": torch.zeros(513)}}
    err = compression.init_error(params)
    jerr = jcomp.init_error({"a": jnp.zeros((3, 100)),
                             "b": {"c": jnp.zeros((513,))}})
    assert err["b"]["c"].dtype == torch.float32
    for g in grads_np:
        tg = {"a": _t(g["a"]), "b": {"c": _t(g["b"]["c"])}}
        jg = {"a": jnp.asarray(g["a"]), "b": {"c": jnp.asarray(g["b"]["c"])}}
        g_hat, err = compression.ef_step(tg, err)
        jg_hat, jerr = jcomp.ef_step(jg, jerr)
        for got, want in ((g_hat["a"], jg_hat["a"]),
                          (g_hat["b"]["c"], jg_hat["b"]["c"]),
                          (err["a"], jerr["a"]),
                          (err["b"]["c"], jerr["b"]["c"])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the residual kept is smaller than a gradient sent
    assert float(err["a"].abs().max()) < float(np.abs(grads_np[-1]["a"])
                                                .max())


@pytest.mark.parametrize("shape,dtype,jdtype", [
    ((1000,), torch.float32, jnp.float32),
    ((256, 4), torch.bfloat16, jnp.bfloat16),
    ((3, 7), torch.float32, jnp.float32)])
def test_compressed_ratio_matches_reference(shape, dtype, jdtype):
    assert compression.compressed_ratio(shape, dtype) == pytest.approx(
        jcomp.compressed_ratio(shape, jdtype), rel=1e-15)
