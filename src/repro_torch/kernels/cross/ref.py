"""Plain PyTorch versions of the DCN-v2 cross layer (``csrc/cross.cu``)
and of the W split its tensor route reads."""
from __future__ import annotations

import torch


def cross_layer_ref(
    x0: torch.Tensor,     # [B, d] base features
    xl: torch.Tensor,     # [B, d] current layer input
    W: torch.Tensor,      # [d, d]
    bias: torch.Tensor,   # [d]
) -> torch.Tensor:
    """x_{l+1} = x0 * (xl W^T + bias) + xl   (DCN-v2, arXiv:2008.13535)."""
    return x0 * (xl @ W.T + bias) + xl


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: on the int32 view, add half of the 13
    dropped bits' weight to the magnitude and clear them."""
    bits = x.float().contiguous().view(torch.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000
    return ((bits & ~0x7FFFFFFF) | (mag & ~0x1FFF)).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = tf32_rna(x), lo = tf32_rna(x - hi); x - hi is exact,
    and hi + lo holds x to 2^-21 of |x|."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def cross_split_ref(W: torch.Tensor, bn: int = 144,
                    bk: int = 32) -> torch.Tensor:
    """The tensor route's W split (``cross_split_launch``) as int32 words:
    for each tile of ``bn`` rows of W and stage of ``bk`` columns (zeros
    past d), hi then lo, each [bn, bk] in the 128-byte swizzle (row r's
    16-byte chunk c at chunk c ^ (r % 8))."""
    d = W.shape[0]
    tiles, steps = -(-d // bn), -(-d // bk)
    pad = torch.zeros(tiles * bn, steps * bk, dtype=torch.float32,
                      device=W.device)
    pad[:d, :d] = W
    hi, lo = tf32_split(pad)
    r = torch.arange(bn, device=W.device)[:, None]
    k = torch.arange(bk, device=W.device)[None, :]
    col = ((k // 4) ^ (r % 8)) * 4 + k % 4     # where (r, k) sits in row r
    blocks = []
    for t in range(tiles):
        for s in range(steps):
            for part in (hi, lo):
                tile = part[t * bn:(t + 1) * bn, s * bk:(s + 1) * bk]
                out = torch.empty_like(tile)
                out.scatter_(1, col.expand(bn, bk), tile)
                blocks.append(out.reshape(-1))
    return torch.cat(blocks).view(torch.int32)
