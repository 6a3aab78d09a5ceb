"""Device dispatch for EmbeddingBag: the plain version for CPU tensors,
the CUDA kernel (``csrc/embag.cu``) for CUDA tensors."""
from __future__ import annotations

import torch

from .. import _build
from .ref import embedding_bag_ref


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
        _build.launch("embedding_bag", *args, out.data_ptr(), V, D, B, L)
    return out
