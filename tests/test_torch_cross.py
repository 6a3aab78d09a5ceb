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
