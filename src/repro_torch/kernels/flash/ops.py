"""Device dispatch for blocked GQA attention: ``chunked_attention`` for
CPU tensors, the flash kernel (``csrc/flash.cu``) for CUDA tensors.

The kernel computes what ``chunked_attention`` computes, whatever the
chunk: the chunk only sets the plain version's scan.  It takes f32 or
bf16, Dh of 32, 64, 128 or 256, contiguous 16-byte-aligned tensors in
``repro``'s [B, H, S, Dh] layout, and raises on anything else; nothing
falls back to the plain version on the card."""
from __future__ import annotations

import torch

from .. import _build
from .ref import chunked_attention

HEAD_DIMS = (32, 64, 128, 256)


def attention(
    q: torch.Tensor,        # [B, Hq, Sq, Dh]
    k: torch.Tensor,        # [B, Hkv, Skv, Dh]
    v: torch.Tensor,        # [B, Hkv, Skv, Dh]
    *,
    causal: bool,
    q_offset: int = 0,      # position of q's first row
    kv_len: int | None = None,   # valid keys (the cache's filled prefix)
    chunk: int = 1024,
) -> torch.Tensor:
    """Softmax attention of each q head over kv head ``h // group``, keys
    masked past ``kv_len`` and, when causal, past the query's absolute
    position; [B, Hq, Sq, Dh] in q's dtype.  A row with no valid key is
    0."""
    dev = q.device
    if dev.type == "cpu":
        return chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 kv_len=kv_len, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"attention runs on cpu or cuda, not {dev}")
    B, Hq, Sq, Dh = q.shape
    _, Hkv, Skv, _ = k.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the flash kernel takes f32 or bf16, not {q.dtype}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes Dh in {HEAD_DIMS}, not {Dh}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} q heads do not share {Hkv} kv heads")
    args = [_build.check(q, "q", q.dtype, (B, Hq, Sq, Dh), dev),
            _build.check(k, "k", q.dtype, (B, Hkv, Skv, Dh), dev),
            _build.check(v, "v", q.dtype, (B, Hkv, Skv, Dh), dev)]
    if any(p % 16 for p in args):
        raise ValueError("the flash kernel needs 16-byte-aligned tensors")
    out = torch.empty_like(q)
    if out.numel():
        kv = Skv if kv_len is None else min(int(kv_len), Skv)
        _build.launch("flash", *args, out.data_ptr(), B, Hq, Hkv, Sq, Skv,
                      Dh, int(q_offset), kv, int(causal),
                      int(q.dtype == torch.bfloat16), Dh ** -0.5)
    return out
