"""Plain PyTorch version of the stage-2 graph engine over the bit-packed
adjacency (``csrc/prune.cu`` and ``csrc/cc_hop.cu``).

Layout, the reference's bit for bit: adjacency row ``i`` is
``W = ceil(n_cols / 32)`` 32-bit words, LSB-first within a word, so

    edge (i, j)  <->  bit ``j % 32`` of ``packed[i, j // 32]``.

The words are held as int32 (torch has no uint32 shifts on the CPU): bit
31 is the sign bit, a full word is -1, and a bit is read as
``(w >> b) & 1`` (the arithmetic shift is harmless once masked).  Words
are built with OR, never with a sum, because bit 31 is negative.  Bits at
columns ``>= n_cols`` are always 0; pruning only clears bits.

Prune and CC hop are row-blocked so the ``[n, n]`` distance matrix never
exists at once; the feature dim is the only contracted axis, so blocking
changes no per-element arithmetic.
"""
from __future__ import annotations

import torch

# Label sentinel for "no neighbour": larger than any user id yet far from
# int32 overflow under min().
BIG_LABEL = 2**30


def packed_words(n_cols: int) -> int:
    """Number of 32-bit words per adjacency row."""
    return (n_cols + 31) // 32


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int32, device=device)


def pack_bits(dense: torch.Tensor, n_words: int | None = None) -> torch.Tensor:
    """[..., C] bool -> [..., W] int32 (LSB-first; W >= ceil(C/32))."""
    C = dense.shape[-1]
    W = packed_words(C) if n_words is None else n_words
    pad = W * 32 - C
    if pad:
        dense = torch.nn.functional.pad(dense, (0, pad))
    r = dense.reshape(*dense.shape[:-1], W, 32).to(torch.int32)
    r = r << _shifts(dense.device)
    word = torch.zeros(r.shape[:-1], dtype=torch.int32, device=dense.device)
    for b in range(32):
        word |= r[..., b]
    return word


def unpack_bits(packed: torch.Tensor, n_cols: int) -> torch.Tensor:
    """[..., W] int32 -> [..., n_cols] bool (inverse of ``pack_bits``)."""
    bits = (packed[..., :, None] >> _shifts(packed.device)) & 1
    flat = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 32)
    return flat[..., :n_cols].bool()


def init_packed_adj(n_rows: int, n_cols: int, n_words: int | None = None,
                    row_offset: int = 0, device=None) -> torch.Tensor:
    """Fully-connected packed adjacency minus self edges, [n_rows, W] i32.

    Full words below ``n_cols`` are -1 (all 32 bits), the boundary word
    keeps its low ``n_cols % 32`` bits, and row ``i`` clears bit
    ``row_offset + i`` (its own column in a sharded row layout).
    """
    W = packed_words(n_cols) if n_words is None else n_words
    rem = (n_cols - 32 * torch.arange(W, dtype=torch.int64,
                                      device=device)).clamp(0, 32)
    word = ((1 << rem) - 1).to(torch.int32)        # 2**32 - 1 wraps to -1
    adj = word.expand(n_rows, W).clone()
    i = torch.arange(n_rows, dtype=torch.int64, device=device) + row_offset
    live = i < min(n_cols, W * 32)
    rows, col = torch.nonzero(live)[:, 0], i[live]
    adj[rows, col // 32] &= ~(1 << (col % 32)).to(torch.int32)
    return adj


def pad_rows(a: torch.Tensor, n_pad: int, fill=0) -> torch.Tensor:
    """Pad the leading axis to ``n_pad`` with ``fill`` (no-op if aligned)."""
    if a.shape[0] == n_pad:
        return a
    out = torch.full((n_pad, *a.shape[1:]), fill, dtype=a.dtype,
                     device=a.device)
    out[: a.shape[0]] = a
    return out


def prune_packed_ref(
    packed: torch.Tensor,   # [R, W] int32
    v_i: torch.Tensor,      # [R, d] row-side user vectors
    cb_i: torch.Tensor,     # [R] f32 confidence widths (cb_width(occ_i))
    v_j: torch.Tensor,      # [C, d] column-side user vectors (C <= W*32)
    cb_j: torch.Tensor,     # [C] f32
    gamma: float,
    *,
    row_block: int = 256,
) -> torch.Tensor:
    """``packed`` AND the CLUB keep-mask ``dist < gamma (cb_i + cb_j)``,
    with ``dist = sqrt(max(|v_i|^2 + |v_j|^2 - 2 v_i.v_j, 0))``."""
    R, W = packed.shape
    C = W * 32
    v_j = pad_rows(v_j.float(), C)
    cb_j = pad_rows(cb_j.float(), C)
    sq_j = torch.sum(v_j * v_j, dim=-1)
    v_i, cb_i = v_i.float(), cb_i.float()
    out = torch.empty_like(packed)
    for r0 in range(0, R, row_block):
        vb, cbb = v_i[r0:r0 + row_block], cb_i[r0:r0 + row_block]
        d2 = (torch.sum(vb * vb, dim=-1)[:, None] + sq_j[None, :]
              - 2.0 * (vb @ v_j.T))
        dist = torch.sqrt(torch.clamp_min(d2, 0.0))
        keep = dist < gamma * (cbb[:, None] + cb_j[None, :])
        out[r0:r0 + row_block] = packed[r0:r0 + row_block] & pack_bits(keep, W)
    return out


def cc_hop_packed_ref(
    packed: torch.Tensor,        # [R, W] int32
    labels_self: torch.Tensor,   # [R] i32 current labels of the rows
    labels_j: torch.Tensor,      # [C] i32 current labels of the columns
    *,
    row_block: int = 256,
) -> torch.Tensor:
    """One min-label hop: ``min(labels_self, min over set bits of labels_j)``.

    The pointer-doubling shortcut (``l[l]``) stays with the caller.
    """
    R, W = packed.shape
    C = W * 32
    lj = pad_rows(labels_j.to(torch.int32), C, fill=BIG_LABEL)
    big = torch.tensor(BIG_LABEL, dtype=torch.int32, device=packed.device)
    out = torch.empty(R, dtype=torch.int32, device=packed.device)
    for r0 in range(0, R, row_block):
        bits = unpack_bits(packed[r0:r0 + row_block], C)
        neigh = torch.where(bits, lj[None, :], big)
        out[r0:r0 + row_block] = torch.minimum(
            labels_self[r0:r0 + row_block].to(torch.int32),
            neigh.min(dim=1).values)
    return out
