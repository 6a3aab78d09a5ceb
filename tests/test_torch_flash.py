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


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,Dh,causal,off,kv_len,split", [
    (2, 8, 2, 1, 96, 16, True, 40, 41, 16),    # splits past 41 see no key
    (1, 4, 1, 1, 64, 16, True, 9, 10, 32),     # kv_len below one split
    (1, 4, 1, 3, 32, 16, True, -2, None, 8),   # rows before the first key
    (2, 8, 1, 1, 80, 32, True, 70, 71, 16),    # group 8 (MQA)
    (2, 8, 2, 2, 64, 16, True, 30, 32, 16),    # Sq 2 at group 4
    (1, 4, 1, 4, 48, 16, True, 20, 24, 16),    # Sq 4 at group 4: 16 rows
    (1, 4, 2, 3, 40, 16, False, 0, 33, 16),    # bidirectional, ragged split
], ids=["empty_split", "kv_below_split", "negative_offset", "mqa_group8",
        "sq2_group4", "sq4_group4", "bidir"])
def test_split_kv_merge_matches_chunked_attention(B, Hq, Hkv, Sq, Skv, Dh,
                                                  causal, off, kv_len,
                                                  split):
    """The split-KV variant's per-split partials merged by log-sum-exp
    give ``chunked_attention``'s result within 1e-5 (f32 sums of at most a
    hundred terms, merged in another order); a row with no valid key
    comes out exactly 0."""
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(B, Hq, Hkv, Sq, Skv, Dh, Skv + split))
    kw = dict(causal=causal, q_offset=off, kv_len=kv_len)
    got = ref.split_kv_attention(q, k, v, split=split, **kw)
    want = ref.chunked_attention(q, k, v, chunk=Skv, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    if off < 0:
        assert bool((got[:, :, :-off] == 0).all())


def test_n_splits_fill_the_card_in_one_wave():
    """The split-KV variant's split count: at the LM decode shape (B 8,
    Hkv 8, 2113 keys, 132 multiprocessors) 4 splits, 256 blocks, two a
    multiprocessor; never a split under 128 keys, never fewer than one."""
    assert flash_ops.n_splits(8, 8, 2113, 132) == 4
    assert flash_ops.n_splits(2, 2, 41, 132) == 1
    assert flash_ops.n_splits(64, 32, 4096, 132) == 1
    assert flash_ops.n_splits(1, 1, 100000, 132) == 264


def test_chunked_attention_moved_and_re_exported():
    """``chunked_attention`` lives with the flash plain versions; the
    models' module re-exports the same function."""
    assert attention.chunked_attention is ref.chunked_attention


def test_attention_refuses_devices_other_than_cpu_and_cuda():
    q = torch.empty(1, 2, 4, 32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_ops.attention(q, q, q, causal=True)
