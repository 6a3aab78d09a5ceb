"""The pending-decision ring buffer: recommend now, fold feedback later
(``repro.serve.pending``).

``recommend`` on a buffer-enabled session issues choices AND enqueues one
decision per valid request, ``(uid, choice, chosen context, decision id,
deadline, catalog epoch)``, into a fixed-capacity ring; ``observe_delayed``
folds feedback matched by decision id whenever it arrives.

  * slot ``decision_id % capacity`` holds the decision; ids are a
    monotone counter, so a batch of ``B <= capacity`` ids lands on
    distinct slots.
  * ``x`` is the chosen context row the fold needs, so a delayed fold
    equals the synchronous one.
  * the ``clock`` ticks once per issue; a decision issued at clock ``c``
    with TTL ``t`` survives ``t`` later issues, then expires (counted).
  * enqueuing onto a slot still holding an unexpired decision evicts it
    (``dropped``).
  * a matched slot is freed, so a second delivery counts ``unmatched``;
    duplicates inside one feedback batch fold only their first copy.
  * with a staleness mask from the serving layer, matched feedback whose
    item churned since issue is quarantined (``stale``), never folded.

Every issued decision resolves exactly once:

    issued == matched + in_flight + expired + dropped + stale

The port updates nothing in place: each function returns a new buffer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device


class PendingBuffer(NamedTuple):
    uid: torch.Tensor        # [C] i32 user id of the decision (-1 = free)
    choice: torch.Tensor     # [C] i32 chosen slate slot / global item id
    x: torch.Tensor          # [C, d] f32 chosen context (the fold digest)
    decision: torch.Tensor   # [C] i32 resident decision id (-1 = free)
    deadline: torch.Tensor   # [C] i32 last clock at which feedback folds
    epoch: torch.Tensor      # [C] i32 catalog epoch the decision issued at
    next_id: torch.Tensor    # [] i32 monotone decision-id counter
    clock: torch.Tensor      # [] i32 issue-transaction counter
    issued: torch.Tensor     # [] i32 VALID decisions enqueued
    expired: torch.Tensor    # [] i32 decisions dropped on TTL
    dropped: torch.Tensor    # [] i32 decisions evicted by backpressure
    matched: torch.Tensor    # [] i32 feedback entries folded
    unmatched: torch.Tensor  # [] i32 feedback with no resident decision
    stale: torch.Tensor      # [] i32 feedback quarantined (item churned)

    @property
    def capacity(self) -> int:
        return self.uid.shape[0]


def init(capacity: int, d: int, device=None) -> PendingBuffer:
    """An empty ring on ``device`` (default cuda)."""
    if capacity <= 0:
        raise ValueError(f"pending capacity must be positive, got {capacity}")
    device = resolve_device(device)

    def z():
        return torch.zeros((), dtype=torch.int32, device=device)

    def free():
        return torch.full((capacity,), -1, dtype=torch.int32, device=device)

    return PendingBuffer(
        uid=free(), choice=free(),
        x=torch.zeros(capacity, d, dtype=torch.float32, device=device),
        decision=free(),
        deadline=torch.zeros(capacity, dtype=torch.int32, device=device),
        epoch=torch.zeros(capacity, dtype=torch.int32, device=device),
        next_id=z(), clock=z(), issued=z(), expired=z(), dropped=z(),
        matched=z(), unmatched=z(), stale=z())


def clear(p: PendingBuffer) -> PendingBuffer:
    """Free every slot but keep ``next_id``/``clock``/counters, so
    feedback issued before the clear can never alias a later decision."""
    return p._replace(uid=torch.full_like(p.uid, -1),
                      decision=torch.full_like(p.decision, -1))


def in_flight(p: PendingBuffer) -> torch.Tensor:
    return torch.sum((p.uid >= 0).to(torch.int32))


def _count(mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(mask.to(torch.int32))


def _put(a: torch.Tensor, slots: torch.Tensor, vals) -> torch.Tensor:
    out = a.clone()
    out[slots] = vals
    return out


def issue(p: PendingBuffer, uids: torch.Tensor, choices: torch.Tensor,
          x: torch.Tensor, valid: torch.Tensor, ttl: int,
          epoch: int = 0) -> tuple[PendingBuffer, torch.Tensor]:
    """Tick the clock, expire overdue decisions, enqueue the batch.
    Returns ``(buffer, decision_ids [B] i32)``; padding requests consume
    an id but are not enqueued and return -1.  ``epoch`` is the catalog
    epoch of the batch (0 on the slate path)."""
    B = uids.shape[0]
    C = p.uid.shape[0]
    clock = p.clock + 1
    overdue = (p.uid >= 0) & (p.deadline < clock)
    p = p._replace(
        uid=torch.where(overdue, -1, p.uid),
        decision=torch.where(overdue, -1, p.decision),
        clock=clock, expired=p.expired + _count(overdue))
    ids = p.next_id + torch.arange(B, dtype=torch.int32, device=uids.device)
    slot = torch.remainder(ids, C).long()
    evict = valid & (p.uid[slot] >= 0)
    tgt = slot[valid]
    return p._replace(
        uid=_put(p.uid, tgt, uids[valid].to(torch.int32)),
        choice=_put(p.choice, tgt, choices[valid].to(torch.int32)),
        x=_put(p.x, tgt, x[valid]),
        decision=_put(p.decision, tgt, ids[valid]),
        deadline=_put(p.deadline, tgt, (clock + ttl).to(torch.int32)),
        epoch=_put(p.epoch, tgt, epoch),
        next_id=p.next_id + B,
        issued=p.issued + _count(valid),
        dropped=p.dropped + _count(evict),
    ), torch.where(valid, ids, -1)


def match(p: PendingBuffer, ids: torch.Tensor,
          stale: torch.Tensor | None = None
          ) -> tuple[PendingBuffer, torch.Tensor, torch.Tensor]:
    """Match a feedback batch by decision id and free the matched slots.
    Returns ``(buffer, uids [B] i32, x [B, d])``; entries that matched
    nothing (expired, already folded, duplicated in the batch, id -1) and
    ``stale``-masked hits come back with uid -1, which folds as padding."""
    C = p.uid.shape[0]
    if stale is None:
        stale = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    slot = torch.remainder(torch.where(ids >= 0, ids, 0), C).long()
    resident = (ids >= 0) & (p.decision[slot] == ids)
    eq = (ids[:, None] == ids[None, :]) & (ids >= 0)[:, None]
    first = torch.sum(torch.tril(eq, diagonal=-1), dim=1) == 0
    hit = resident & first
    fold = hit & ~stale
    uids = torch.where(fold, p.uid[slot], -1)
    x = p.x[slot]
    freed = slot[hit]
    p = p._replace(
        uid=_put(p.uid, freed, -1),
        decision=_put(p.decision, freed, -1),
        matched=p.matched + _count(fold),
        stale=p.stale + _count(hit & stale),
        unmatched=p.unmatched + _count((ids >= 0) & ~hit))
    return p, uids, x


def conservation_gap(p: PendingBuffer) -> int:
    """issued - (matched + in_flight + expired + dropped + stale); zero
    iff every issued decision is accounted for exactly once."""
    resolved = p.matched + in_flight(p) + p.expired + p.dropped + p.stale
    return int(p.issued - resolved)


def stats(p: PendingBuffer) -> dict[str, float]:
    """Host-side counter snapshot."""
    cap = p.capacity
    flight = int(in_flight(p))
    return {
        "capacity": cap, "in_flight": flight, "occupancy": flight / cap,
        "clock": int(p.clock), "issued": int(p.issued),
        "matched": int(p.matched), "unmatched": int(p.unmatched),
        "expired": int(p.expired), "dropped": int(p.dropped),
        "stale": int(p.stale),
    }
