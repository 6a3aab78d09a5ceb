"""Device dispatch for blocked GQA attention: ``chunked_attention`` for
CPU tensors, the flash kernel (``csrc/flash.cu``) for CUDA tensors.

The kernel computes what ``chunked_attention`` computes, whatever the
chunk: the chunk only sets the plain version's scan.  It takes f32 or
bf16, Dh of 32, 64, 128 or 256, contiguous 16-byte-aligned tensors in
``repro``'s [B, H, S, Dh] layout, and raises on anything else; nothing
falls back to the plain version on the card.

Its split-KV decode variant (bf16, at most 16 q rows a (batch, kv head),
Dh <= 128) cuts the keys into splits; this wrapper picks their number
(``n_splits``) and allocates the f32 workspace of the splits' partials,
since the kernel allocates nothing.  One call counts one launch, though
that variant runs two CUDA kernels (the splits, then their merge).

Gradients: where grad mode is on and an input requires grad, the call
goes through an autograd Function whose forward is the same dispatch
and whose backward is ``torch.autograd.grad`` of ``chunked_attention``,
recomputed on the saved q, k and v, on either device: ``repro`` has no
backward kernel and differentiates ``chunked_attention`` itself.  Only
then are q, k and v saved."""
from __future__ import annotations

import torch

from .. import _build
from .ref import chunked_attention

HEAD_DIMS = (32, 64, 128, 256)
SPLIT_ROWS = 16          # the split-KV variant's most rows a (b, kv head)
SPLIT_MIN_KEYS = 128     # fewest keys worth a split of their own
SPLIT_PER_SM = 2         # split blocks a multiprocessor holds at once


def n_splits(B: int, Hkv: int, kv: int, n_sm: int) -> int:
    """Splits of the keys ``[0, kv)`` for the split-KV variant: as many
    blocks (splits x B x Hkv) as the card holds at once, ``SPLIT_PER_SM``
    a multiprocessor, so all run in one wave, and no split under
    ``SPLIT_MIN_KEYS`` keys (4 at the LM decode shape: B 8, Hkv 8, 2113
    keys, 132 multiprocessors, 256 blocks)."""
    want = SPLIT_PER_SM * n_sm // max(B * Hkv, 1)
    return max(1, min(want, -(-kv // SPLIT_MIN_KEYS)))


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
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, chunk=chunk)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, kw)
    return _forward(q, k, v, **kw)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kw):
        ctx.kw = kw
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, **kw)

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = chunked_attention(*qkv, **ctx.kw)
            dq, dk, dv = torch.autograd.grad(out, qkv, dout)
        return dq, dk, dv, None


def _forward(q, k, v, *, causal, q_offset, kv_len, chunk):
    """The kernel for CUDA tensors, ``chunked_attention`` for CPU ones."""
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
        bf16 = q.dtype == torch.bfloat16
        rows = Hq // Hkv * Sq
        splits, ws, ws_bytes = 0, 0, 0
        if bf16 and rows <= SPLIT_ROWS and Dh <= 128:
            splits = n_splits(B, Hkv, kv, _build.sm_count(dev.index or 0))
            # freed when this returns: the caching allocator hands it out
            # again only in this stream's order, after the kernel
            part = torch.empty(B * Hkv * splits * rows * (Dh + 2),
                               dtype=torch.float32, device=dev)
            ws, ws_bytes = part.data_ptr(), 4 * part.numel()
        _build.launch("flash", *args, out.data_ptr(), ws, ws_bytes, B, Hq,
                      Hkv, Sq, Skv, Dh, int(q_offset), kv, int(causal),
                      int(bf16), splits, Dh ** -0.5)
    return out
