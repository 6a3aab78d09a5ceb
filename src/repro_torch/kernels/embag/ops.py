"""Device dispatch for EmbeddingBag: the plain version for CPU tensors,
the CUDA kernel (``csrc/embag.cu``) for CUDA tensors."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from .ref import embedding_bag_ref

WARPS_PER_BLOCK = 4     # 512 bags make 128 blocks on the H100's 132 SMs


class Geometry(NamedTuple):
    """The kernel's launch: ``vec`` floats a chunk (4: 16-byte loads, or
    1), ``g`` chunk lanes in each of ``s`` slot groups of a warp (g s =
    32), a warp per bag, ``warps`` bags a block, ``blocks`` blocks."""
    vec: int
    g: int
    s: int
    warps: int
    blocks: int


def launch_geometry(D: int, B: int, aligned: bool) -> Geometry:
    """Geometry of ``B`` bags over a table of width ``D``; ``aligned``:
    the table starts on a 16-byte boundary.  16-byte chunks where ``D`` is
    a multiple of 4 and the table is aligned, 4-byte ones otherwise; ``g``
    is the least power of two that covers the chunks, at most 32 (past 32
    chunks a lane takes chunks c, c + 32, ... in turn)."""
    vec = 4 if D % 4 == 0 and aligned else 1
    chunks = D // vec
    g = 1
    while g < chunks and g < 32:
        g *= 2
    return Geometry(vec, g, 32 // g, WARPS_PER_BLOCK,
                    -(-B // WARPS_PER_BLOCK))


def embedding_bag(
    table: torch.Tensor,              # [V, D] f32
    idx: torch.Tensor,                # [B, L] i32
    wt: torch.Tensor | None = None,   # [B, L] f32
) -> torch.Tensor:
    """Weighted bag sum ``out[b] = sum_l wt[b,l] table[idx[b,l]]`` [B, D]
    f32, ids under jnp's gather rule (``ref.wrap_ids``).  ``wt=None``
    means a plain sum (all-ones weights); a 0-weight slot is a pad, and
    the kernel does not read its row."""
    if wt is None:
        wt = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    dev = table.device
    if dev.type == "cpu":
        return embedding_bag_ref(table, idx, wt)
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag runs on cpu or cuda, not {dev}")
    V, D = table.shape
    B, L = idx.shape
    if V < 1:
        raise ValueError("embedding_bag needs a table of at least one row")
    args = [
        _build.check(table, "table", torch.float32, (V, D), dev),
        _build.check(idx, "idx", torch.int32, (B, L), dev),
        _build.check(wt, "wt", torch.float32, (B, L), dev),
    ]
    out = torch.empty(B, D, dtype=torch.float32, device=dev)
    if B and D:
        geo = launch_geometry(D, B, table.data_ptr() % 16 == 0)
        _build.launch("embedding_bag", *args, out.data_ptr(), V, D, B, L,
                      geo.vec, geo.g, geo.warps)
    return out
