"""Plain PyTorch version of EmbeddingBag (``csrc/embag.cu``): gather and
weighted reduce, ``out[b] = sum_l wt[b,l] table[idx[b,l]]``.

Ids follow the JAX package's gather rule (``repro`` indexes with jnp),
which :func:`wrap_ids` reproduces: a negative id is wrapped once
(``id + V``), then every id is clamped to ``[0, V - 1]``.  So on a
5-row table the ids ``[-1, 5, 7, -6, -9]`` read rows ``[4, 4, 4, 0, 0]``,
where torch's own indexing would raise.
"""
from __future__ import annotations

import torch


def wrap_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int64 row ids under jnp's gather rule for an ``n``-row table."""
    ids = ids.long()
    return torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)


def embedding_bag_ref(
    table: torch.Tensor,  # [V, D]
    idx: torch.Tensor,    # [B, L] int (pad slots may point anywhere)
    wt: torch.Tensor,     # [B, L] f32 (0 for pad slots)
) -> torch.Tensor:
    """out [B, D] = sum_l wt[b,l] * table[idx[b,l]]."""
    rows = table[wrap_ids(idx, table.shape[0])]     # [B, L, D]
    return torch.einsum("bld,bl->bd", rows, wt)
