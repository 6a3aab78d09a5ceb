"""The port's M-free rank-1 update (``repro_torch.kernels.rank1``) against
the reference's Pallas kernel in interpret mode, on the CPU."""
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
