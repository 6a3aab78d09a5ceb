"""Embedding tables and EmbeddingBag for the recsys models
(``repro.models.recsys.embedding``).

``lookup`` is plain row indexing, as in ``repro``; ``bag_lookup`` is the
multi-hot bag sum and goes through the EmbeddingBag kernel
(``kernels/embag``) for CUDA tensors.  Both follow jnp's gather rule for
ids out of range (``kernels.embag.ref.wrap_ids``): a negative id wraps
once, then ids clamp to the table, where torch indexing would raise.
"""
from __future__ import annotations

import torch

from ...kernels.embag import ops as embag_ops
from ...kernels.embag.ref import wrap_ids


def init_table(gen: torch.Generator, vocab: int, dim: int) -> torch.Tensor:
    """[vocab, dim] ~ N(0, 1) * dim^-1/2 on the generator's device."""
    return torch.randn(vocab, dim, generator=gen,
                       device=gen.device) * dim ** -0.5


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain row gather: ids [...], table [V, D] -> [..., D]."""
    return table[wrap_ids(ids, table.shape[0])]


def draw_negatives(gen: torch.Generator, n: int, n_items: int, device):
    """``n`` shared uniform negatives in ``[0, n_items)`` from ``gen`` (the
    sampled-softmax losses' draw, where ``repro`` takes a PRNG key), on
    ``device``."""
    return torch.randint(0, n_items, (n,), generator=gen,
                         device=gen.device).to(device)


def bag_lookup(table, ids, weights=None):
    """Multi-hot bag sum: ids [B, L] i32 -> [B, D] (0-weight = pad)."""
    return embag_ops.embedding_bag(table, ids, weights)
