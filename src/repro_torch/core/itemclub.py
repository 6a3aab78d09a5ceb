"""Item-side CLUB clustering over the ``Catalog`` and the tile-aligned
layout the cluster-pruned retrieval path serves from
(``repro.core.itemclub``).

  1. ``ItemStats``: per-slot serve counts and reward sums, folded from
     served feedback (:func:`observe_served`).  Items cluster on
     ``concat(normalize(emb), beta * rhat)``: geometry plus the learned
     mean reward.
  2. :func:`build_clusters`: CLUB edge pruning and connected components
     over a bounded ANCHOR set, through the stage-2 graph engine (packed
     adjacency, the prune and cc_hop kernels on the card), then every slot
     takes its nearest anchor's label (chunked, so the ``[capacity, A]``
     distances never exist at once).
  3. The layout: ``perm`` (position -> slot id) sorts live slots by label,
     dead slots last, with sorted copies of the serving bank and per-tile
     summaries (centroid, radius, max norm, live count) for
     ``kernels.topk.ref.tile_bounds``, a true upper bound, so pruning is
     exact.  Features and summaries are taken on the DEQUANTIZED bank
     (``catalog.dequantize``), the values the kernels score; a bf16 or
     int8 bank's radius and max norm are widened by the quantization
     bound, and the sorted copies keep the stored dtype and scales.

Epoch contract: the tables are stamped with the catalog epoch they were
built from; ``serve`` falls back to the unpruned stream when the epochs
differ, and :func:`refresh_clusters` rebuilds lazily.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..runtime import stages
from ..runtime.collectives import NullCollectives
from .backend import BackendConfig
from .catalog import dequantize


class ItemStats(NamedTuple):
    """Per-slot learned reward statistics (slot-indexed like the banks)."""

    occ: torch.Tensor    # [capacity] i32 times the slot's item was served
    rsum: torch.Tensor   # [capacity] f32 summed realized reward


class ItemClusters(NamedTuple):
    """Epoch-stamped item clusters + the sorted layout the pruned
    retrieval kernel streams."""

    epoch: int                 # catalog epoch the tables describe
    labels: torch.Tensor       # [capacity] i32 cluster label per slot
    perm: torch.Tensor         # [capacity] i32 position -> slot id
    emb_sorted: torch.Tensor   # [capacity, d] serving bank emb[perm]
    live_sorted: torch.Tensor  # [capacity] f32 serving bank live[perm]
    scale_sorted: torch.Tensor  # [capacity] f32 serving bank scale[perm]
    tile_mu: torch.Tensor      # [T, d] live-item centroid per tile
    tile_r: torch.Tensor       # [T] max live |x - mu| per tile
    tile_xn: torch.Tensor      # [T] max live |x| per tile
    tile_n: torch.Tensor       # [T] i32 live items per tile
    n_clusters: torch.Tensor   # [] distinct anchor labels

    @property
    def tile_items(self) -> int:
        return self.perm.shape[0] // self.tile_mu.shape[0]


class RetrievalMetrics(NamedTuple):
    """Per-transaction pruned-retrieval telemetry."""

    tiles_skipped: int    # tile visits skipped
    tiles_total: int      # tile visits possible
    pruned_active: int    # 1 = pruned path ran, 0 = stale table, fell back

    def skip_ratio(self) -> float:
        return float(self.tiles_skipped) / max(1.0, float(self.tiles_total))


# ---------------------------------------------------------------------------
# learned per-item reward statistics
# ---------------------------------------------------------------------------


def init_stats(capacity: int, device=None) -> ItemStats:
    """Zero statistics on ``device`` (default cuda)."""
    dev = resolve_device(device)
    return ItemStats(
        occ=torch.zeros(capacity, dtype=torch.int32, device=dev),
        rsum=torch.zeros(capacity, dtype=torch.float32, device=dev))


def observe_served(stats: ItemStats, item_ids: torch.Tensor,
                   rewards: torch.Tensor,
                   valid: torch.Tensor | None = None) -> ItemStats:
    """Fold one served batch: ``item_ids [B]`` global slot ids (< 0 =
    padding) and ``rewards [B]``; duplicates fold like sequential serves."""
    cap = stats.occ.shape[0]
    ok = (item_ids >= 0) & (item_ids < cap)
    if valid is not None:
        ok = ok & valid
    tgt = item_ids[ok].long()
    return ItemStats(
        occ=stats.occ.index_add(0, tgt, torch.ones_like(tgt,
                                                        dtype=torch.int32)),
        rsum=stats.rsum.index_add(0, tgt, rewards[ok].float()))


def reset_new_slots(stats: ItemStats, catalog) -> ItemStats:
    """Zero the statistics of slots whose item arrived at the CURRENT
    epoch (call after a ``publish``)."""
    fresh = catalog.serving.born == catalog.epoch
    return ItemStats(occ=torch.where(fresh, 0, stats.occ),
                     rsum=torch.where(fresh, 0.0, stats.rsum))


# ---------------------------------------------------------------------------
# CLUB clustering over anchors + nearest-anchor assignment
# ---------------------------------------------------------------------------


def _item_features(emb, stats: ItemStats, beta: float) -> torch.Tensor:
    """[capacity, d + 1]: unit embedding ++ beta * rsum / (1 + occ)."""
    nrm = torch.clamp_min(torch.linalg.norm(emb, dim=-1, keepdim=True), 1e-9)
    rhat = stats.rsum / (1.0 + stats.occ.float())
    return torch.cat([emb / nrm, beta * rhat[:, None]], dim=1)


def _nearest_anchor(z, z_a, chunk: int = 4096) -> torch.Tensor:
    """argmin_a |z_i - z_a| per row (first anchor on ties), chunked."""
    a2 = torch.sum(z_a * z_a, dim=1)
    out = []
    for r0 in range(0, z.shape[0], chunk):
        zb = z[r0:r0 + chunk]
        d2 = torch.sum(zb * zb, dim=1)[:, None] - 2.0 * (zb @ z_a.T) + a2[None]
        out.append(torch.argmin(d2, dim=1))
    return torch.cat(out)


def build_clusters(catalog, stats: ItemStats | None = None, *,
                   tile_items: int = 512, n_anchors: int = 512,
                   gamma: float = 0.5, beta: float = 1.0) -> ItemClusters:
    """Cluster the SERVING bank and lay it out tile-aligned.

    Anchors are the first ``n_anchors`` live slots in id order (every
    slot when ``capacity <= n_anchors``); edge (i, j) survives iff
    ``|z_i - z_j| < gamma (cb(occ_i) + cb(occ_j))``; components come from
    the stage-2 CC loop; every slot then takes its nearest anchor's label.
    Dead slots sort after every label.  ``capacity % tile_items == 0``."""
    bank = catalog.serving
    cap = catalog.capacity
    dev = bank.emb.device
    if cap % tile_items:
        raise ValueError(f"capacity {cap} % tile_items {tile_items} != 0")
    if stats is None:
        stats = init_stats(cap, device=dev)

    # features, tile summaries and bounds on the dequantized bank: the
    # f32 values the kernels score (an f32 bank as it is)
    emb_f = dequantize(bank)
    z = _item_features(emb_f, stats, beta)
    by_live = torch.argsort(-bank.live, stable=True)
    A = min(n_anchors, cap)
    anchor_ids = by_live[:A]
    z_a = z[anchor_ids].contiguous()
    occ_a = stats.occ[anchor_ids].contiguous()

    gb = BackendConfig.create().graph(A, A)
    adj = gb.prune_rows(gb.init_adj(device=dev), z_a, occ_a, z_a, occ_a,
                        gamma)
    anchor_labels = stages.connected_components(NullCollectives(), gb, adj,
                                                A, 0, A)
    labels = anchor_labels[_nearest_anchor(z, z_a)]
    n_clusters = torch.sum(torch.bincount(anchor_labels.long(),
                                          minlength=A) > 0)

    # dead slots take label A, past every anchor label, so a stable sort
    # pools them in the trailing tiles
    sort_key = torch.where(bank.live > 0, labels, A)
    perm = torch.argsort(sort_key, stable=True)
    emb_sorted = bank.emb[perm].contiguous()     # the stored dtype
    live_sorted = bank.live[perm].contiguous()
    scale_sorted = bank.scale[perm].contiguous()

    T = cap // tile_items
    et = emb_f[perm].reshape(T, tile_items, -1)
    lt = live_sorted.reshape(T, tile_items)
    cnt = torch.sum(lt, dim=1)
    mu = (torch.sum(et * lt[..., None], dim=1)
          / torch.clamp_min(cnt, 1.0)[:, None])
    dist = torch.linalg.norm(et - mu[:, None, :], dim=-1)
    tile_r = torch.amax(torch.where(lt > 0, dist, 0.0), dim=1)
    tile_xn = torch.amax(
        torch.where(lt > 0, torch.linalg.norm(et, dim=-1), 0.0), dim=1)
    # quantized banks: widen the radius and max norm by the per-tile
    # quantization bound, so the bounds hold against the dequantized rows
    # (int8: sqrt(d) / 2 of the largest live scale; bf16: 8 mantissa bits)
    if bank.emb.dtype == torch.int8:
        st = scale_sorted.reshape(T, tile_items)
        half_sqrt_d = 0.5 * float(torch.tensor(float(bank.emb.shape[1]))
                                  .sqrt())        # f32 sqrt, as repro's
        qeps = half_sqrt_d * torch.amax(torch.where(lt > 0, st, 0.0), dim=1)
        tile_r, tile_xn = tile_r + qeps, tile_xn + qeps
    elif bank.emb.dtype == torch.bfloat16:
        qeps = tile_xn * 2.0 ** -8
        tile_r, tile_xn = tile_r + qeps, tile_xn + qeps
    return ItemClusters(
        epoch=catalog.epoch, labels=labels.to(torch.int32),
        perm=perm.to(torch.int32), emb_sorted=emb_sorted,
        live_sorted=live_sorted, scale_sorted=scale_sorted,
        tile_mu=mu.contiguous(),
        tile_r=tile_r.contiguous(), tile_xn=tile_xn.contiguous(),
        tile_n=cnt.to(torch.int32), n_clusters=n_clusters)


def is_fresh(clusters: ItemClusters, catalog) -> bool:
    """Do the tables still describe the serving bank?"""
    return int(clusters.epoch) == int(catalog.epoch)


def refresh_clusters(clusters: ItemClusters, catalog,
                     stats: ItemStats | None = None, *,
                     force: bool = False, **build_kw) -> ItemClusters:
    """Lazy rebuild: a no-op while the epoch matches unless ``force``;
    keyword args go to :func:`build_clusters`."""
    if not force and is_fresh(clusters, catalog):
        return clusters
    build_kw.setdefault("tile_items", clusters.tile_items)
    return build_clusters(catalog, stats, **build_kw)


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------


def shard_slice(clusters: ItemClusters, shard: int, n_local: int):
    """Shard ``shard``'s piece of the sorted stream: positions ``[shard *
    n_local, ...)`` and their whole tiles.  Returns ``(emb, live, ids,
    scale, tile_mu, tile_r, tile_xn, tile_n)``, ``ids`` the GLOBAL slot ids, so
    the shards' shortlists merge bit-equal to one stream's (selection is
    by value).  Raises unless ``tile_items`` divides ``n_local``."""
    tile = clusters.tile_items
    if n_local % tile:
        raise ValueError(
            f"shard slice {n_local} % tile_items {tile} != 0: build "
            "clusters with tile_items dividing capacity // n_shards")
    T_local = n_local // tile
    rows = slice(shard * n_local, (shard + 1) * n_local)
    tiles = slice(shard * T_local, (shard + 1) * T_local)
    return (clusters.emb_sorted[rows], clusters.live_sorted[rows],
            clusters.perm[rows], clusters.scale_sorted[rows],
            clusters.tile_mu[tiles],
            clusters.tile_r[tiles], clusters.tile_xn[tiles],
            clusters.tile_n[tiles])
