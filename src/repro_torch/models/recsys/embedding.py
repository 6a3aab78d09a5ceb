"""Embedding tables and EmbeddingBag for the recsys models
(``repro.models.recsys.embedding``).

``lookup`` is plain row indexing, as in ``repro``; ``bag_lookup`` is the
multi-hot bag sum and goes through the EmbeddingBag kernel
(``kernels/embag``) for CUDA tensors.  Both follow jnp's gather rule for
ids out of range (``kernels.embag.ref.wrap_ids``): a negative id wraps
once, then ids clamp to the table, where torch indexing would raise.

On a rank of a tensor-parallel mesh (``ax``, ``distributed.spmd.Axes``;
the recsys cells of ``launch.steps``) a table is the rank's rows of
``table_specs``' split over "model" (DTensor's: ``ceil(V / model)`` rows
a rank, the last ones fewer): ``lookup_rows`` looks up the ids the rank
holds, zeroes the others and sums the rows over "model", a row-parallel
lookup whose gradient is each rank's own rows'.  A model carries its
axes as ``model.ax`` (one rank unless a cell sets it).
"""
from __future__ import annotations

import torch

from ...distributed import spmd
from ...distributed.sharding import P
from ...kernels.embag import ops as embag_ops
from ...kernels.embag.ref import wrap_ids


def init_table(gen: torch.Generator, vocab: int, dim: int) -> torch.Tensor:
    """[vocab, dim] ~ N(0, 1) * dim^-1/2 on the generator's device."""
    return torch.randn(vocab, dim, generator=gen,
                       device=gen.device) * dim ** -0.5


def table_specs() -> P:
    """Tables are row-sharded over "model"."""
    return P("model", None)


def lookup_rows(rows_of, ids, vocab: int, held: int,
                ax: spmd.Axes = spmd.ONE_RANK):
    """``rows_of(i)`` for ``ids`` [...] wrapped on a ``vocab``-row table;
    on a rank of ``ax``, whose ``held`` rows start at ``r ceil(vocab /
    model)``, the rows it holds (others zero) summed over "model"."""
    ids = wrap_ids(ids, vocab)
    if ax.m == 1:
        return rows_of(ids)
    local = ids.long() - ax.r * -(-vocab // ax.m)
    ok = (local >= 0) & (local < held)
    rows = rows_of(local.clamp(0, held - 1))
    return spmd.leave(rows.masked_fill(~ok[..., None], 0), ax.model)


def lookup(table: torch.Tensor, ids: torch.Tensor,
           ax: spmd.Axes = spmd.ONE_RANK, vocab: int | None = None):
    """Plain row gather: ids [...], table [V, D] -> [..., D]; on a rank of
    ``ax``, ``table`` holds its rows of a ``vocab``-row table."""
    return lookup_rows(lambda i: table[i], ids, vocab or table.shape[0],
                       table.shape[0], ax)


def item_rows(model, ids):
    """Rows of ``model.item_embed`` (``cfg.n_items`` rows) for ``ids``,
    row-parallel over ``model.ax``."""
    return lookup(model.item_embed, ids, model.ax, model.cfg.n_items)


def draw_negatives(gen: torch.Generator, n: int, n_items: int, device):
    """``n`` shared uniform negatives in ``[0, n_items)`` from ``gen`` (the
    sampled-softmax losses' draw, where ``repro`` takes a PRNG key), on
    ``device``."""
    return torch.randint(0, n_items, (n,), generator=gen,
                         device=gen.device).to(device)


def bag_lookup(table, ids, weights=None):
    """Multi-hot bag sum: ids [B, L] i32 -> [B, D] (0-weight = pad)."""
    return embag_ops.embedding_bag(table, ids, weights)
