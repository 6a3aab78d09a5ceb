"""The port's flash plain versions against the reference on the CPU: the
same numpy inputs go through ``repro``'s ``flash_attention_pallas`` (in
interpret mode, as its own tests run it), its ``mha_ref`` and its
``chunked_attention``, and through the port's ``mha_ref`` and
``flash_ops.attention`` (whose CPU route is ``chunked_attention``).

Tolerances: against the Pallas kernel 2e-3 abs/rel, the reference's own
tolerance for it (tests/test_kernels.py); between the two dense oracles
and the two chunked scans, both f32 sums of at most a few hundred terms in
the same order of chunks, 1e-5; bf16 5e-2, the reference's bf16 tolerance.
The CUDA kernel itself is held to the same plain version by
``chip_smoke.py`` on the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash import ops as jflash_ops  # noqa: E402
from repro.kernels.flash.ref import mha_ref as jmha_ref  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash import ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402

# the reference's test_flash_kernel cases
CASES = [
    (1, 2, 2, 128, 128, 64, True, 0),      # MHA causal
    (2, 4, 2, 256, 256, 64, True, 0),      # GQA causal
    (1, 8, 1, 128, 128, 32, False, 0),     # MQA bidirectional
    (2, 4, 4, 64, 256, 64, True, 192),     # chunked decode tail
]
IDS = ["mha_causal", "gqa_causal", "mqa_bidir", "decode_tail"]


def _qkv(B, Hq, Hkv, Sq, Skv, Dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, Sq, Dh)).astype(dtype),
            rng.normal(size=(B, Hkv, Skv, Dh)).astype(dtype),
            rng.normal(size=(B, Hkv, Skv, Dh)).astype(dtype))


def _pallas(q, k, v, causal, off, dtype=jnp.float32):
    return np.asarray(jflash_ops.attention(
        *(jnp.asarray(a, dtype) for a in (q, k, v)), causal=causal,
        q_offset=off, use_pallas=True, block_q=64, block_k=64,
        interpret=True).astype(jnp.float32))


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,Dh,causal,off", CASES, ids=IDS)
def test_mha_ref_matches_reference(B, Hq, Hkv, Sq, Skv, Dh, causal, off):
    q, k, v = _qkv(B, Hq, Hkv, Sq, Skv, Dh, Sq + Skv)
    want = np.asarray(jmha_ref(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=causal, q_offset=off))
    got = ref.mha_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                      causal=causal, q_offset=off)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _pallas(q, k, v, causal, off),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,Dh,causal,off", CASES, ids=IDS)
def test_attention_cpu_route_matches_pallas_interpret(B, Hq, Hkv, Sq, Skv,
                                                      Dh, causal, off):
    """Chunks of 64 keys: the scan takes several chunks on every case."""
    q, k, v = _qkv(B, Hq, Hkv, Sq, Skv, Dh, Sq + Skv)
    _build.reset_launches()
    got = flash_ops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, q_offset=off, chunk=64)
    assert _build.LAUNCHES["flash"] == 0
    assert got.dtype == torch.float32 and got.shape == (B, Hq, Sq, Dh)
    np.testing.assert_allclose(got.numpy(), _pallas(q, k, v, causal, off),
                               rtol=2e-3, atol=2e-3)
    want = np.asarray(jmha_ref(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=causal, q_offset=off))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


def test_attention_cpu_route_bf16():
    """The reference's bf16 case: bf16 in, bf16 out, within 5e-2 of the
    Pallas kernel on the same bf16 inputs."""
    q, k, v = _qkv(1, 2, 2, 128, 128, 64, 0)
    as_bf16 = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = flash_ops.attention(*as_bf16, causal=True, chunk=64)
    assert got.dtype == torch.bfloat16
    # both sides see the same bf16-rounded inputs
    q, k, v = (t.float().numpy() for t in as_bf16)
    want = _pallas(q, k, v, True, 0, jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("Sq,Skv,off,kv_len,causal,chunk", [
    (1, 64, 40, 41, True, 16),         # decode: one query, cache valid to 41
    (5, 48, 9, 14, True, 16),          # a prompt written at 9 of 48 slots
    (6, 32, 0, 5, False, 8),           # bidirectional, padded keys
])
def test_attention_kv_len_matches_reference_chunked(Sq, Skv, off, kv_len,
                                                    causal, chunk):
    q, k, v = _qkv(2, 4, 2, Sq, Skv, 16, Sq * Skv)
    kw = dict(causal=causal, q_offset=off, kv_len=kv_len, chunk=chunk)
    want = np.asarray(jattention.chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v)), **kw))
    got = flash_ops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_chunked_attention_moved_and_re_exported():
    """``chunked_attention`` lives with the flash plain versions; the
    models' module re-exports the same function."""
    assert attention.chunked_attention is ref.chunked_attention


def test_attention_refuses_devices_other_than_cpu_and_cuda():
    q = torch.empty(1, 2, 4, 32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_ops.attention(q, q, q, causal=True)
