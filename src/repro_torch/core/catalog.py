"""The persistent item catalog the retrieval engine serves against,
epoch-numbered and DOUBLE-BUFFERED for live churn (``repro.core.catalog``).

A :class:`Catalog` holds TWO slot banks of item embeddings with liveness
masks.  ``active`` is the serving bank; the other is the shadow staging
area.  :func:`add_items` / :func:`retire_items` stage into the shadow bank
only; :func:`publish` flips ``active`` and bumps ``epoch``.  The port runs
eagerly, so a mutator returns a new record and the flip happens in one
call: no reader ever sees a half-published bank.

Slots, not items, are the unit of storage: retiring clears a slot's
``live`` bit, adding claims the lowest dead shadow slot, so every array
keeps its shape through churn.  ``born[bank, slot]`` is the epoch from
which the slot's current item serves (staged adds are stamped
``epoch + 1``), which lets ``serve`` tell a re-claimed slot from the item
a stale decision chose.

``active`` and ``epoch`` are Python ints (host-side control values);
the banks are tensors on the catalog's device.

Item sharding: a rank of an item-sharded session holds its slice of the
slot axis of both banks (:func:`item_shard`; :func:`specs` is the split,
``repro``'s ``specs``).  Each transaction takes the ranks' ``col``
(``runtime.collectives``; one process by default) and, on a rank's
slice, returns that rank's slice of what it returns on the global
catalog: ids and slot ids are global, counts are summed over the ranks,
and :func:`add_items` gathers the shadow ``live`` mask so that the slot
allocation is the global one.

Precision (``core.backend.Precision``): banks may store embeddings in
bf16 or int8 instead of f32.  ``emb`` carries that dtype and a per-slot
f32 ``scale`` rides along (1.0 except under int8, where the dequantized
row is ``emb.float() * scale``, :func:`dequantize`).  :func:`make_catalog`
shares one scale per ``scale_block`` contiguous slots; churn-added rows
get their own.  Every mutator and publish moves ``scale`` like the other
slot arrays, so scales survive publishes and slot reclaim bit-exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..runtime.collectives import NullCollectives
from .backend import Precision, resolve_precision

_NULL = NullCollectives()


class Bank(NamedTuple):
    """One bank's view, what the retrieval kernels consume."""

    emb: torch.Tensor    # [capacity, d] f32/bf16/int8 (dead slots: zeros)
    live: torch.Tensor   # [capacity] f32 liveness (1 = servable)
    born: torch.Tensor   # [capacity] i32 epoch the resident item arrived
    scale: torch.Tensor  # [capacity] f32 int8 dequant scale (1.0 otherwise)


class Catalog(NamedTuple):
    emb: torch.Tensor    # [2, capacity, d] per-bank embeddings (bank dtype)
    live: torch.Tensor   # [2, capacity] f32 per-bank liveness
    born: torch.Tensor   # [2, capacity] i32 per-bank arrival epoch
    scale: torch.Tensor  # [2, capacity] f32 per-bank dequant scales
    active: int          # which bank serves (0/1)
    epoch: int           # publish counter

    @property
    def capacity(self) -> int:
        return self.live.shape[1]

    @property
    def d(self) -> int:
        return self.emb.shape[2]

    def _bank(self, b: int) -> Bank:
        return Bank(emb=self.emb[b], live=self.live[b], born=self.born[b],
                    scale=self.scale[b])

    @property
    def serving(self) -> Bank:
        """The active bank: the only state serving reads."""
        return self._bank(self.active)

    @property
    def staged(self) -> Bank:
        """The shadow bank, where churn accumulates until :func:`publish`."""
        return self._bank(1 - self.active)

    def n_live(self, col=_NULL) -> int:
        """Servable items of the ACTIVE bank (over the ranks of ``col``)."""
        return int(col.psum(self.live[self.active].sum()))


def _quantize_rows(emb: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 rows -> int8 codes under per-row ``scale`` (maxabs / 127):
    ``round(clip(emb / scale, -127, 127))``, halves to even."""
    q = torch.round(torch.clamp(emb / scale[:, None], -127.0, 127.0))
    return q.to(torch.int8)


def _row_scales(emb32: torch.Tensor) -> torch.Tensor:
    """One int8 scale per row: its maxabs (floored at 1e-8) / 127, taken
    as a multiply by the f32 reciprocal of 127, which is what ``repro``'s
    jitted ``add_items`` computes (XLA folds a division by a constant into
    that multiply), so churn-added scales stay bit-equal to its."""
    return torch.clamp_min(emb32.abs().amax(dim=1), 1e-8) * (1.0 / 127.0)


def dequantize(bank: Bank) -> torch.Tensor:
    """The f32 embeddings the scores are taken on: f32 banks as they are
    (bit-exact), bf16 widened, int8 codes times their slot's scale."""
    e = bank.emb.float()
    if bank.emb.dtype == torch.int8:
        e = e * bank.scale[:, None]
    return e


def make_catalog(emb: torch.Tensor, capacity: int | None = None, *,
                 precision: Precision | str | None = None) -> Catalog:
    """Catalog over ``emb [N, d]`` (all live, born at epoch 0) with
    ``capacity - N`` spare dead slots.  Both banks start identical.

    ``precision`` (through :func:`~repro_torch.core.backend.resolve_precision`:
    the argument, ``REPRO_PRECISION``, f32) picks the banks' dtype; int8
    quantizes with one scale per ``scale_block`` contiguous slots, each
    block's maxabs / 127, floored at 1e-8 so all-dead blocks stay
    finite."""
    prec = resolve_precision(precision)
    N, d = emb.shape
    capacity = N if capacity is None else capacity
    if capacity < N:
        raise ValueError(f"capacity {capacity} < {N} items")
    dev = emb.device
    full = torch.zeros(capacity, d, dtype=torch.float32, device=dev)
    full[:N] = emb
    dt = prec.torch_catalog
    if dt == torch.int8:
        sb = min(prec.scale_block, capacity)
        gid = torch.arange(capacity, device=dev) // sb
        rowmax = full.abs().amax(dim=1)
        gmax = torch.zeros(-(-capacity // sb), dtype=torch.float32,
                           device=dev).scatter_reduce(0, gid, rowmax, "amax")
        scale = torch.clamp_min(gmax, 1e-8)[gid] / 127.0
        full = _quantize_rows(full, scale)
    else:
        full = full.to(dt)
        scale = torch.ones(capacity, dtype=torch.float32, device=dev)
    live = torch.zeros(capacity, dtype=torch.float32, device=dev)
    live[:N] = 1.0
    return Catalog(
        emb=torch.stack([full, full]), live=torch.stack([live, live]),
        born=torch.zeros(2, capacity, dtype=torch.int32, device=dev),
        scale=torch.stack([scale, scale]), active=0, epoch=0)


def item_shard(cat: Catalog, shard: int, n_shards: int) -> Catalog:
    """Shard ``shard``'s slice of the slot axis of both banks, for an
    item-sharded session (``repro`` places it with ``device_put`` and
    ``catalog.specs``): slots ``[shard * capacity / n_shards, ...)``, the
    bank flip and epoch as they are.  Raises unless ``n_shards`` divides
    the capacity."""
    if cat.capacity % n_shards:
        raise ValueError(f"capacity {cat.capacity} does not divide evenly "
                         f"over {n_shards} shards")
    size = cat.capacity // n_shards
    sl = slice(shard * size, (shard + 1) * size)
    return cat._replace(emb=cat.emb[:, sl].contiguous(),
                        live=cat.live[:, sl].contiguous(),
                        born=cat.born[:, sl].contiguous(),
                        scale=cat.scale[:, sl].contiguous())


def specs() -> Catalog:
    """The split of an item-sharded catalog (``serve.policies.shard_rows``):
    the banks on their slot axis, the flip and the epoch replicated."""
    return Catalog(emb=1, live=1, born=1, scale=1, active=None, epoch=None)


def random_catalog(generator: torch.Generator, n_items: int, d: int,
                   capacity: int | None = None, device=None, *,
                   precision: Precision | str | None = None) -> Catalog:
    """Unit-norm random embeddings drawn from ``generator`` (on
    ``device``, default cuda), stored under ``precision``."""
    dev = resolve_device(device)
    e = torch.randn(n_items, d, generator=generator, device=dev)
    e = e / torch.linalg.norm(e, dim=-1, keepdim=True)
    return make_catalog(e, capacity=capacity, precision=precision)


def _with_bank(cat: Catalog, b: int, emb, live, born, scale) -> Catalog:
    E, L, Bn, Sc = (cat.emb.clone(), cat.live.clone(), cat.born.clone(),
                    cat.scale.clone())
    E[b], L[b], Bn[b], Sc[b] = emb, live, born, scale
    return cat._replace(emb=E, live=L, born=Bn, scale=Sc)


def _slot_range(cat: Catalog, col) -> tuple[int, int]:
    """(first global slot, slots) of this rank's slice."""
    return col.axis_index() * cat.capacity, cat.capacity


def retire_items(cat: Catalog, ids: torch.Tensor, col=_NULL
                 ) -> tuple[Catalog, int]:
    """STAGE the retirement of ``ids`` (global slot ids) into the shadow
    bank; returns ``(catalog, n_retired)``, the shadow slots that went
    live -> dead over all ranks.  Negative, out-of-range, duplicate and
    already-dead ids are no-ops."""
    shadow = 1 - cat.active
    live_s = cat.live[shadow]
    row0, n = _slot_range(cat, col)
    loc = ids - row0
    ok = (loc >= 0) & (loc < n)
    new_live = live_s.clone()
    new_live[loc[ok].long()] = 0.0
    n_retired = int(col.psum((live_s - new_live).sum()))
    L = cat.live.clone()
    L[shadow] = new_live
    return cat._replace(live=L), n_retired


def add_items(cat: Catalog, emb_new: torch.Tensor, col=_NULL
              ) -> tuple[Catalog, torch.Tensor, int]:
    """STAGE ``emb_new [m, d]`` into the lowest dead SHADOW slots; returns
    ``(catalog, slot_ids [m] i32, n_added)``, slot ids global and the
    same on every rank.  Staged items are stamped ``born = epoch + 1``.
    When fewer than ``m`` slots are free the first rows claim them in
    ascending slot order and the overflow gets slot -1: live items are
    never overwritten.  Each rank writes the rows that land in its
    slice."""
    m = emb_new.shape[0]
    shadow = 1 - cat.active
    emb_s, live_s, born_s, scale_s = (cat.emb[shadow], cat.live[shadow],
                                      cat.born[shadow], cat.scale[shadow])
    # dead slots first, ascending global id (a stable sort of the 0/1 mask)
    live_g = col.all_gather(live_s)
    order = torch.argsort(live_g, stable=True)
    n_free = live_g.shape[0] - int(live_g.sum())
    n_added = min(m, n_free)
    slots = order[:n_added]
    emb32 = emb_new[:n_added].float()
    if emb_s.dtype == torch.int8:
        # churn-added rows get their own scales: the scale_block groups
        # are a property of the initial layout only
        sc = _row_scales(emb32)
        codes = _quantize_rows(emb32, sc)
    else:
        sc = torch.ones(n_added, dtype=torch.float32, device=emb_s.device)
        codes = emb32.to(emb_s.dtype)
    row0, n = _slot_range(cat, col)
    loc = slots - row0
    mine = (loc >= 0) & (loc < n)
    loc = loc[mine]
    emb2, live2, born2, scale2 = (emb_s.clone(), live_s.clone(),
                                  born_s.clone(), scale_s.clone())
    emb2[loc] = codes[mine]
    live2[loc] = 1.0
    born2[loc] = cat.epoch + 1
    scale2[loc] = sc[mine]
    out = torch.full((m,), -1, dtype=torch.int32, device=emb_s.device)
    out[:n_added] = slots.to(torch.int32)
    return _with_bank(cat, shadow, emb2, live2, born2, scale2), out, n_added


def staged_churn(cat: Catalog, col=_NULL) -> int:
    """Slots whose staged state differs from the serving state, over all
    ranks."""
    a, s = cat.active, 1 - cat.active
    diff = ((cat.live[a] != cat.live[s]) | (cat.born[a] != cat.born[s])
            | (cat.scale[a] != cat.scale[s])
            | torch.any(cat.emb[a] != cat.emb[s], dim=-1))
    return int(col.psum(diff.sum()))


def publish(cat: Catalog) -> Catalog:
    """Flip the staged bank live: the shadow becomes the serving bank,
    ``epoch`` bumps, and the retiring bank is re-seeded as a copy of the
    newly published one (the next staging starts from what serves)."""
    new_active = 1 - cat.active
    cat = _with_bank(cat, cat.active, cat.emb[new_active],
                     cat.live[new_active], cat.born[new_active],
                     cat.scale[new_active])
    return cat._replace(active=new_active, epoch=cat.epoch + 1)


def torn_publish(cat: Catalog, keep_mask: torch.Tensor, col=_NULL
                 ) -> Catalog:
    """FAULT INJECTION ONLY: a publish where only ``keep_mask`` (over the
    global slots) slots' staged changes land (the rest revert to the
    serving state) before the flip; the epoch still bumps."""
    shadow, a = 1 - cat.active, cat.active
    row0, n = _slot_range(cat, col)
    keep = keep_mask[row0:row0 + n].bool()
    cat = _with_bank(
        cat, shadow,
        torch.where(keep[:, None], cat.emb[shadow], cat.emb[a]),
        torch.where(keep, cat.live[shadow], cat.live[a]),
        torch.where(keep, cat.born[shadow], cat.born[a]),
        torch.where(keep, cat.scale[shadow], cat.scale[a]))
    return publish(cat)
