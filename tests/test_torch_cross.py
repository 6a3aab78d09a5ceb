"""The port's DCN-v2 cross layer (``repro_torch.kernels.cross``) against the
reference's oracle and its Pallas kernel in interpret mode, on the CPU.

The tolerance, rtol = atol = 2e-5, is the reference's own for this kernel
(``tests/test_kernels.py``): the d-term f32 sums are taken in another
order by each BLAS, and at d = 429 with unit-scale inputs the difference
stays at a few ulp of the O(1) results."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.cross import ops as jcross  # noqa: E402
from repro.kernels.cross.ref import cross_layer_ref as jcross_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cross import ops, ref  # noqa: E402


def _inputs(B, d):
    rng = np.random.default_rng(B + d)
    x0 = rng.normal(size=(B, d)).astype(np.float32)
    xl = rng.normal(size=(B, d)).astype(np.float32)
    W = (rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32)
    bias = rng.normal(size=(d,)).astype(np.float32)
    return x0, xl, W, bias


@pytest.mark.parametrize("B,d", [(16, 16), (37, 24), (100, 64), (9, 429)])
def test_cross_layer_matches_reference_and_pallas_interpret(B, d):
    arrays = _inputs(B, d)
    want_ref = np.asarray(jcross_ref(*(jnp.asarray(a) for a in arrays)))
    want_pallas = np.asarray(jcross.cross_layer(
        *(jnp.asarray(a) for a in arrays), use_pallas=True, interpret=True))
    inputs = [torch.from_numpy(a.copy()) for a in arrays]
    _build.reset_launches()
    got = ops.cross_layer(*inputs)
    assert _build.LAUNCHES["cross"] == 0      # a CPU call launches nothing
    assert got.shape == (B, d) and got.dtype == torch.float32
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # the inputs are left as they are: the result is a new tensor
    for t, a in zip(inputs, arrays):
        np.testing.assert_array_equal(t.numpy(), a)


def test_cross_layer_ref_contracts_on_w_dim_1():
    """``xl W^T``: an asymmetric W tells the two contractions apart."""
    x0 = torch.ones(1, 2)
    xl = torch.tensor([[1.0, 0.0]])
    W = torch.tensor([[0.0, 0.0], [5.0, 0.0]])
    # (xl W^T)[j] = sum_k xl[k] W[j, k] = W[j, 0] -> [0, 5]
    got = ref.cross_layer_ref(x0, xl, W, torch.zeros(2))
    np.testing.assert_array_equal(got.numpy(), [[1.0, 5.0]])


def test_cross_layer_refuses_other_devices():
    x = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.cross_layer(x, x, torch.zeros(3, 3, device="meta"),
                        torch.zeros(3, device="meta"))


# ---- the tensor route's arithmetic: 3xTF32 -------------------------------

def _tf32_rna_numpy(a):
    """Round-to-nearest-away TF32 on the float32 bits, in numpy."""
    b = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    mag = ((b & 0x7FFFFFFF) + 0x1000) & 0xFFFFE000
    return (mag | (b & 0x80000000)).astype(np.uint32).view(np.float32)


def test_tf32_split_rounds_to_nearest_and_holds_x_to_2_pow_minus_21():
    _, xl, W, _ = _inputs(64, 429)
    for a in (xl, W):
        x = torch.from_numpy(a)
        hi, lo = ref.tf32_split(x)
        for part in (hi, lo):      # TF32: the 13 low mantissa bits clear
            assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
        np.testing.assert_array_equal(hi.numpy(), _tf32_rna_numpy(a))
        np.testing.assert_array_equal(
            lo.numpy(), _tf32_rna_numpy(a - hi.numpy()))
        err = (hi.double() + lo.double() - x.double()).abs()
        assert bool((err <= 2.0**-21 * x.double().abs()).all())


def test_3xtf32_holds_the_contract_and_1xtf32_does_not():
    """lo.hi + hi.lo + hi.hi of the split operands, summed in f32, is
    within the kernel's 2e-5 of the f32 plain version; hi.hi alone (one
    TF32 product) is not, by far: the split is what the route needs."""
    x0, xl, W, bias = (torch.from_numpy(a) for a in _inputs(64, 429))
    want = ref.cross_layer_ref(x0, xl, W, bias)
    ah, al = ref.tf32_split(xl)
    bh, bl = ref.tf32_split(W)
    three = x0 * (al @ bh.T + ah @ bl.T + ah @ bh.T + bias) + xl
    torch.testing.assert_close(three, want, rtol=2e-5, atol=2e-5)
    one = x0 * (ah @ bh.T + bias) + xl
    over = ((one - want).abs() / (2e-5 + 2e-5 * want.abs())).max()
    assert float(over) > 10


@pytest.mark.parametrize("d", [16, 37, 429])
def test_cross_split_ref_is_hi_then_lo_tiles_in_the_128_byte_swizzle(d):
    rng = np.random.default_rng(d)
    W = torch.from_numpy(rng.normal(size=(d, d)).astype(np.float32))
    words = ref.cross_split_ref(W)
    assert words.dtype == torch.int32
    assert words.numel() == ops.split_words(d)
    tiles, steps = -(-d // ops.TC_BN), -(-d // ops.TC_BK)
    blocks = words.view(torch.float32).view(tiles, steps, 2, ops.TC_BN,
                                            ops.TC_BK)
    pad = torch.zeros(tiles * ops.TC_BN, steps * ops.TC_BK)
    pad[:d, :d] = W
    r = torch.arange(ops.TC_BN)[:, None]
    k = torch.arange(ops.TC_BK)[None, :]
    chunk = ((k // 4) ^ (r % 8)) * 4 + k % 4   # where (r, k) sits in row r
    for t in range(tiles):
        for s in range(steps):
            tile = pad[t * ops.TC_BN:(t + 1) * ops.TC_BN,
                       s * ops.TC_BK:(s + 1) * ops.TC_BK]
            for p, want in enumerate(ref.tf32_split(tile)):
                got = torch.gather(blocks[t, s, p], 1,
                                   chunk.expand(ops.TC_BN, ops.TC_BK))
                assert torch.equal(got, want)


@pytest.mark.parametrize("B,d,want", [
    (262144, 429, ops.TENSOR),    # serve_bulk: 4096 x 3 tiles
    (512, 429, ops.SIMT),         # serve_p99: 24 tiles, 264 block slots
    (5000, 429, ops.SIMT),        # 237 tiles
    (5632, 429, ops.TENSOR),      # 88 x 3 = 264: every slot once
    (16, 16, ops.SIMT),
    (64 * 65536, 429, ops.SIMT),  # past the grid's row tiles
])
def test_route_at_the_path_shapes(B, d, want):
    assert ops.route(B, d, 132) == want
