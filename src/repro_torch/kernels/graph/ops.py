"""Device dispatch for the stage-2 graph engine: plain versions for CPU
tensors, the CUDA kernels (``csrc/prune.cu``, ``csrc/cc_hop.cu``) for
CUDA tensors.  Callers hold the packed adjacency at its logical shape
``[n_rows, ceil(n_cols/32)]`` int32 (or a view of its rows); the kernels
mask their own ragged edges, so nothing is padded."""
from __future__ import annotations

import torch

from .. import _build
from .ref import (BIG_LABEL, cc_hop_packed_ref, init_packed_adj, pack_bits,
                  packed_words, prune_packed_ref, unpack_bits)

__all__ = [
    "BIG_LABEL", "init_packed_adj", "pack_bits", "packed_words",
    "unpack_bits", "prune_packed", "cc_hop_packed", "cc_hop_geometry",
    "warp_tile_bits",
]

# csrc/prune.cu's tiles: a block owns ROWS_PER_BLOCK rows by
# WORDS_PER_BLOCK words; each of its warps ROWS_PER_WARP of the rows.
# Where each warp's words hold at most SPARSE_MAX set bits the warps walk
# them; otherwise every warp of the block computes every pair of its tile
# (SPARSE_MAX <= SPARSE_CAP, the kernel's room for listed bits).  192:
# chip_smoke.py phase 6 times both branches forced on graphs with the
# same set bits in every warp tile; the walk, in rounds of 32 bits, wins
# through 192 (6 rounds) and loses from 208 (7).
ROWS_PER_BLOCK = 128
ROWS_PER_WARP = 16
WORDS_PER_BLOCK = 4
SPARSE_CAP = 256
SPARSE_MAX = 192

# csrc/cc_hop.cu: a warp a row at a time, CC_WARPS warps a block, at most
# CC_BLOCKS_PER_SM blocks an SM (its launch bounds) in a persistent grid.
# A word with more than CC_DENSE_MIN set bits takes the select over all of
# its 32 labels instead of a walk of its bits.  20: chip_smoke.py phase 6
# times the threshold forced to each of 0 ... 32 on the graph of the main
# path's first stage 2 (23% of its bits set) at its first two hops; 16 to
# 28 read within 1.5% of each other, lower ones slower.
CC_WARPS = 28
CC_BLOCKS_PER_SM = 1
CC_DENSE_MIN = 20


def cc_hop_geometry(R: int, W: int, ptr: int, sms: int) -> tuple[int, int]:
    """(words a load, blocks) of ``cc_hop_launch`` for ``R`` rows of ``W``
    words at address ``ptr`` on a card of ``sms`` SMs.  The loads are the
    widest of 4, 2 and 1 words that divides ``W`` and to whose bytes
    ``ptr`` is aligned, so that every row starts on a load; a row view
    off a 16-byte boundary takes narrower loads, not another kernel.  The
    grid holds a warp for each row up to CC_BLOCKS_PER_SM blocks an SM,
    whose warps then stride over the rows."""
    vec = next(v for v in (4, 2, 1) if W % v == 0 and ptr % (4 * v) == 0)
    return vec, max(1, min(-(-R // CC_WARPS), CC_BLOCKS_PER_SM * sms))


def prune_work_floats(R: int, W: int, d: int) -> int:
    """Floats of the kernel's scratch: both vector sets transposed and
    their squared norms, rows padded to a block's rows and columns to a
    block's 32 WORDS_PER_BLOCK columns."""
    Rp = -(-R // ROWS_PER_BLOCK) * ROWS_PER_BLOCK
    Cp = -(-W // WORDS_PER_BLOCK) * 32 * WORDS_PER_BLOCK
    return (d + 1) * (Rp + Cp)


def warp_tile_bits(packed: torch.Tensor) -> torch.Tensor:
    """Set bits in each warp's tile of the kernel (ROWS_PER_WARP rows by
    WORDS_PER_BLOCK words), [ceil(R / ROWS_PER_WARP), ceil(W /
    WORDS_PER_BLOCK)] int64.  A block walks its tiles' bits only where
    none of its warps' tiles holds more than SPARSE_MAX."""
    x = packed.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    bits = (x * 0x01010101) >> 24 & 0xFF
    R, W = packed.shape
    pr, pw = -R % ROWS_PER_WARP, -W % WORDS_PER_BLOCK
    bits = torch.nn.functional.pad(bits, (0, pw, 0, pr))
    return bits.reshape((R + pr) // ROWS_PER_WARP, ROWS_PER_WARP,
                        (W + pw) // WORDS_PER_BLOCK,
                        WORDS_PER_BLOCK).sum((1, 3))


def prune_packed(
    packed: torch.Tensor,   # [R, W] int32
    v_i: torch.Tensor,      # [R, d] f32
    cb_i: torch.Tensor,     # [R] f32 confidence widths
    v_j: torch.Tensor,      # [C, d] f32, C <= 32 W
    cb_j: torch.Tensor,     # [C] f32
    gamma: float,
) -> torch.Tensor:
    """packed & (dist(v_i, v_j) < gamma (cb_i + cb_j)), a new [R, W]."""
    dev = packed.device
    if dev.type == "cpu":
        return prune_packed_ref(packed, v_i, cb_i, v_j, cb_j, gamma)
    if dev.type != "cuda":
        raise ValueError(f"prune_packed runs on cpu or cuda, not {dev}")
    R, W = packed.shape
    C, d = v_j.shape
    if C > 32 * W:
        raise ValueError(f"{C} columns do not fit in {W} words")
    args = [
        _build.check(packed, "packed", torch.int32, (R, W), dev),
        _build.check(v_i, "v_i", torch.float32, (R, d), dev),
        _build.check(cb_i, "cb_i", torch.float32, (R,), dev),
        _build.check(v_j, "v_j", torch.float32, (C, d), dev),
        _build.check(cb_j, "cb_j", torch.float32, (C,), dev),
    ]
    out = torch.empty_like(packed)
    if R and W:
        work = torch.empty(prune_work_floats(R, W, d), dtype=torch.float32,
                           device=dev)
        _build.launch("prune", *args, float(gamma), R, W, C, d,
                      SPARSE_MAX, work.data_ptr(), out.data_ptr())
    return out


def cc_hop_packed(
    packed: torch.Tensor,        # [R, W] int32
    labels_self: torch.Tensor,   # [R] i32
    labels_j: torch.Tensor,      # [C] i32, C <= 32 W
) -> torch.Tensor:
    """min(labels_self, neighbour-min of labels_j over set bits), [R] i32."""
    dev = packed.device
    if dev.type == "cpu":
        return cc_hop_packed_ref(packed, labels_self, labels_j)
    if dev.type != "cuda":
        raise ValueError(f"cc_hop_packed runs on cpu or cuda, not {dev}")
    R, W = packed.shape
    C = labels_j.shape[0]
    if C > 32 * W:
        raise ValueError(f"{C} columns do not fit in {W} words")
    args = [
        _build.check(packed, "packed", torch.int32, (R, W), dev),
        _build.check(labels_self, "labels_self", torch.int32, (R,), dev),
        _build.check(labels_j, "labels_j", torch.int32, (C,), dev),
    ]
    out = torch.empty(R, dtype=torch.int32, device=dev)
    if R:
        vec, blocks = cc_hop_geometry(R, W, packed.data_ptr(),
                                      _build.sm_count(dev.index or 0))
        _build.launch("cc_hop", *args, R, W, C, vec, blocks, CC_DENSE_MIN,
                      out.data_ptr())
    return out
