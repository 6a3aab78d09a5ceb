"""Streaming serving guardrails with checkpoint rollback
(``repro.serve.guardrails``).

A bandit in production can be poisoned without a sound: corrupted
rewards bend the LinUCB statistics, a stalled shard serves a stale
shortlist, a wedged feedback pipeline fills the pending ring, and bad
statistics spread through the cluster graph at the next stage 2.  The
guardrails watch cheap streaming signals, declare a breach when one
crosses its bound, and ROLL BACK to the last healthy snapshot of a
``train.checkpoint.CheckpointManager``; the session then resumes with
the choices it made before the breach (choices are a pure function of
policy state and inputs).

Monitors (EMA-smoothed host floats):

  ctr          realized reward per interaction: floor ``ctr_floor``,
               armed after ``warmup`` interactions
  recall       shortlist recall against the direct oracle shortlist
               (:func:`shortlist_recall`, 1.0 on healthy two-stage
               serving): floor ``recall_floor``
  occupancy    the pending ring's in-flight share: ceiling
               ``occupancy_ceiling``
  latency      seconds per transaction, the session's card synchronised
               before each clock read: ceiling ``latency_ceiling_s``
  churn        share of catalog capacity changed per publish: ceiling
               ``churn_ceiling``, tested on the RAW per-publish sample
               (one oversized swap is the hazard); ``ema_churn`` is
               telemetry

State machine: HEALTHY --breach--> ROLLBACK (restore the latest
snapshot, pending ring cleared with the id counter kept monotone,
monitors reset) --``cooldown`` transactions--> HEALTHY.  While healthy,
a snapshot is taken every ``snapshot_every`` transactions.

A wrapper created with ``catalog=`` tracks the serving catalog: every
snapshot saves the ``{"state", "catalog"}`` pair (the epoch lives inside
the catalog) and a rollback restores both, so restored statistics never
serve against a catalog they have not seen.  Churn goes through
``stage_churn``/``publish``, which also feed the churn monitor.  A
state-only snapshot goes through ``OnlineBandit.save``/``restore``, which
check the precision tag.

Over a sharded session (``OnlineBandit.sharded``, its catalog this
rank's item slice) a snapshot holds the global arrays (the state's rows
and the catalog's slots gathered over the ranks, rank 0 writing, as
``repro``'s global arrays), and a rollback restores them and takes this
rank's slices again; churn counts and the recall probe run over the
ranks.

Everything is functional: :class:`Guarded` methods return a new wrapper;
``events`` is an append-only tuple of ``("snapshot", tx, step)`` and
``("rollback", tx, breaches, restored_step)`` records.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, NamedTuple

import torch

from ..core import catalog as catalog_mod
from ..core.backend import BackendConfig
from . import policies as pol
from . import session as session_mod


class GuardrailConfig(NamedTuple):
    """Bounds and smoothing of the monitors.  The defaults disarm every
    monitor (infinite bounds): set only what you watch."""

    ctr_floor: float = -math.inf
    recall_floor: float = -math.inf
    occupancy_ceiling: float = math.inf
    latency_ceiling_s: float = math.inf
    churn_ceiling: float = math.inf   # capacity fraction per publish
    warmup: int = 64            # interactions before ctr/recall arm
    ema: float = 0.9            # per-sample EMA decay
    snapshot_every: int = 4     # healthy transactions between snapshots
    cooldown: int = 2           # transactions disarmed after a rollback


@dataclasses.dataclass(frozen=True)
class GuardrailState:
    """EMA values and arming counters.  ``breaches`` names the monitors
    that crossed their bound on the LAST admitted sample."""

    ema_ctr: float | None = None
    ema_recall: float | None = None
    ema_occupancy: float | None = None
    ema_latency_s: float | None = None
    ema_churn: float | None = None
    ema_tiles_skipped: float | None = None
    interactions: int = 0
    cooldown_left: int = 0
    breaches: tuple = ()
    rollbacks: int = 0


def _ema(old: float | None, new: float, decay: float) -> float:
    return float(new) if old is None else decay * old + (1 - decay) * new


def update(cfg: GuardrailConfig, gs: GuardrailState, *,
           ctr: float | None = None, recall: float | None = None,
           occupancy: float | None = None,
           latency_s: float | None = None,
           churn: float | None = None,
           tiles_skipped: float | None = None,
           interactions: int = 0) -> GuardrailState:
    """Fold one transaction's samples and re-evaluate every monitor.
    Rate monitors (ctr, recall) arm after ``warmup`` interactions;
    resource monitors (occupancy, latency, churn) arm at once; all are
    disarmed during a rollback cooldown.  ``tiles_skipped`` (the pruned
    retrieval's skip ratio) is telemetry only."""
    ema_ctr = gs.ema_ctr if ctr is None else _ema(gs.ema_ctr, ctr, cfg.ema)
    ema_recall = (gs.ema_recall if recall is None
                  else _ema(gs.ema_recall, recall, cfg.ema))
    ema_occ = (gs.ema_occupancy if occupancy is None
               else _ema(gs.ema_occupancy, occupancy, cfg.ema))
    ema_lat = (gs.ema_latency_s if latency_s is None
               else _ema(gs.ema_latency_s, latency_s, cfg.ema))
    ema_churn = (gs.ema_churn if churn is None
                 else _ema(gs.ema_churn, churn, cfg.ema))
    ema_tiles = (gs.ema_tiles_skipped if tiles_skipped is None
                 else _ema(gs.ema_tiles_skipped, tiles_skipped, cfg.ema))
    seen = gs.interactions + int(interactions)
    cooldown_left = max(0, gs.cooldown_left - 1)

    breaches = []
    if cooldown_left == 0:
        if seen >= cfg.warmup:
            if ema_ctr is not None and ema_ctr < cfg.ctr_floor:
                breaches.append("ctr_floor")
            if ema_recall is not None and ema_recall < cfg.recall_floor:
                breaches.append("recall_floor")
        if ema_occ is not None and ema_occ > cfg.occupancy_ceiling:
            breaches.append("occupancy_ceiling")
        if ema_lat is not None and ema_lat > cfg.latency_ceiling_s:
            breaches.append("latency_ceiling")
        if churn is not None and churn > cfg.churn_ceiling:
            breaches.append("churn_ceiling")
    return dataclasses.replace(
        gs, ema_ctr=ema_ctr, ema_recall=ema_recall, ema_occupancy=ema_occ,
        ema_latency_s=ema_lat, ema_churn=ema_churn,
        ema_tiles_skipped=ema_tiles, interactions=seen,
        cooldown_left=cooldown_left, breaches=tuple(breaches))


def post_rollback_state(cfg: GuardrailConfig,
                        gs: GuardrailState) -> GuardrailState:
    """The monitors after a breach: EMAs reset, the lifetime interaction
    and rollback counters carried, the cooldown armed.  Shared by
    :class:`Guarded` and the per-arm disabling of ``serve.experiments``."""
    return dataclasses.replace(
        GuardrailState(), interactions=gs.interactions,
        cooldown_left=cfg.cooldown, rollbacks=gs.rollbacks + 1)


def session_device(session) -> torch.device:
    return session.policy.occ_of(session.state).device


def clock(session) -> float:
    """``time.perf_counter()`` after the session's card has finished its
    queued work, so that a latency sample is the transaction's time on
    the card."""
    dev = session_device(session)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def shortlist_recall(session, catalog, user_ids, served_items, *,
                     k_short: int = 64) -> float:
    """Share of the valid requests whose SERVED item is in a fresh direct
    (unpruned) shortlist over the whole catalog.  ``session`` must be the
    state the items were chosen FROM (the pre-transaction session).
    Healthy serving is exact, so this is 1.0; a drop means the serving
    path left its own statistics.  On a sharded session ``catalog`` is
    this rank's item slice: the request rows are replicated, each slice
    shortlisted and the lists merged, as serving does.  An int8 bank's
    oracle scores the dequantized rows (its per-slot scales passed in),
    as the serving shortlist does; ``repro``'s ranks the raw codes."""
    policy = session.policy
    rb = BackendConfig.create().retrieval(k_short)
    w, minv_eff, occ, _, _, valid = session_mod._request_rows(
        policy, session.col, session.state, user_ids)
    _, oracle_ids = session_mod._direct_shortlist(
        rb, session.col, w, minv_eff, occ, catalog, policy.cfg.hyper.alpha)
    hit = torch.any(oracle_ids == served_items[:, None], dim=1)
    n_valid = torch.clamp_min(torch.sum(valid.to(torch.int32)), 1)
    return float(torch.sum((hit & valid).to(torch.float32)) / n_valid)


def _occupancy(session) -> float | None:
    if session.pending is None:
        return None
    return float(torch.mean((session.pending.uid >= 0).to(torch.float32)))


# ---------------------------------------------------------------------------
# the guarded session wrapper
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Guarded:
    """An ``OnlineBandit``, its monitors and its rollback anchor.

    Every serving call admits its samples; a breach restores the latest
    snapshot from ``ckpt`` (and clears the pending ring) before the next
    call runs.  With ``catalog`` the wrapper owns the serving catalog
    and snapshots and restores it with the state; the catalog calls then
    default to it.  Over a sharded session the snapshots are the global
    arrays and ``catalog`` is this rank's item slice."""

    session: Any
    ckpt: Any
    cfg: GuardrailConfig
    gs: GuardrailState = GuardrailState()
    tx: int = 0
    last_snapshot: int = 0
    events: tuple = ()
    catalog: Any = None

    @classmethod
    def create(cls, session, ckpt, cfg: GuardrailConfig,
               catalog=None) -> "Guarded":
        """Wrap ``session`` and take snapshot 0 at once, so that a
        rollback target always exists.  ``catalog`` makes the snapshots
        the (state, catalog, epoch) triple."""
        g = cls(session=session, ckpt=ckpt, cfg=cfg, catalog=catalog)
        g._save_snapshot(session, catalog, 0)
        return dataclasses.replace(g, events=(("snapshot", 0, 0),))

    # -- (state, catalog) snapshots ----------------------------------------
    def _save_snapshot(self, session, catalog, step):
        if catalog is None:
            session.save(self.ckpt, step)
        else:
            col = session.col
            self.ckpt.save({"state": session.global_state(),
                            "catalog": pol.gather_rows(
                                catalog, col, catalog_mod.specs())},
                           step, col=col)

    def _rollback(self, session, catalog):
        """(session, catalog, step) from the latest loadable snapshot."""
        if catalog is None:
            restored, step = session.restore(self.ckpt)
            return restored, None, step
        like = {"state": session.state, "catalog": catalog}
        payload, step = self.ckpt.restore_latest(like)
        if payload is None:     # empty directory: keep what we have
            return session, catalog, None
        return (dataclasses.replace(
                    session, state=session.local_state(payload["state"])),
                pol.shard_rows(payload["catalog"], session.col,
                               catalog_mod.specs()), step)

    # -- admission ---------------------------------------------------------
    def _admit(self, session, **sample) -> "Guarded":
        gs = update(self.cfg, self.gs, **sample)
        tx = self.tx + 1
        if gs.breaches:
            restored, cat, step = self._rollback(session, self.catalog)
            restored = session_mod.reset_pending(restored)
            fresh = post_rollback_state(self.cfg, gs)
            return dataclasses.replace(
                self, session=restored, catalog=cat, gs=fresh, tx=tx,
                events=self.events
                + (("rollback", tx, gs.breaches, step),))
        g = dataclasses.replace(self, session=session, gs=gs, tx=tx)
        # never snapshot during cooldown: a just-restored session may have
        # re-folded bad samples before the fresh EMA can trip again
        if (gs.cooldown_left == 0
                and tx - g.last_snapshot >= self.cfg.snapshot_every):
            self._save_snapshot(session, g.catalog, tx)
            g = dataclasses.replace(
                g, last_snapshot=tx,
                events=g.events + (("snapshot", tx, tx),))
        return g

    @property
    def tripped(self) -> bool:
        return bool(self.gs.breaches)

    # -- guarded transactions ----------------------------------------------
    def step(self, key, user_ids, contexts, reward_fn):
        t0 = clock(self.session)
        sess, choices, m = session_mod.step(self.session, key, user_ids,
                                            contexts, reward_fn)
        dt = clock(sess) - t0
        n = max(1, int(m.interactions))
        g = self._admit(sess, ctr=float(m.reward) / n, latency_s=dt,
                        occupancy=_occupancy(sess),
                        interactions=int(m.interactions))
        return g, choices, m

    def _catalog_or_tracked(self, catalog):
        cat = catalog if catalog is not None else self.catalog
        if cat is None:
            raise ValueError("no catalog: pass one explicitly or create "
                             "the Guarded wrapper with catalog=")
        return cat

    def step_catalog(self, key, user_ids, catalog=None, reward_fn=None, *,
                     k_short: int = 64, probe_recall: bool = False,
                     clusters=None):
        """A guarded ``serve.step_catalog``.  ``clusters`` routes it
        through the cluster-pruned shortlist (its skip ratio feeds
        ``ema_tiles_skipped``; the return gains the
        ``RetrievalMetrics``); ``probe_recall`` holds the served items
        against the fresh unpruned oracle shortlist of the
        pre-transaction state."""
        cat = self._catalog_or_tracked(catalog)
        t0 = clock(self.session)
        out = session_mod.step_catalog(self.session, key, user_ids, cat,
                                       reward_fn, k_short=k_short,
                                       clusters=clusters)
        sess, items, m = out[:3]
        rmet = out[3] if clusters is not None else None
        dt = clock(sess) - t0
        n = max(1, int(m.interactions))
        recall = (shortlist_recall(self.session, cat, user_ids, items,
                                   k_short=k_short)
                  if probe_recall else None)
        g = self if self.catalog is None else dataclasses.replace(
            self, catalog=cat)
        g = g._admit(sess, ctr=float(m.reward) / n, latency_s=dt,
                     occupancy=_occupancy(sess), recall=recall,
                     tiles_skipped=(None if rmet is None
                                    else rmet.skip_ratio()),
                     interactions=int(m.interactions))
        return (g,) + tuple(out[1:])

    def recommend(self, user_ids, contexts):
        """Issue on a buffer-enabled session (latency and occupancy are
        admitted here; the CTR arrives with the delayed feedback)."""
        t0 = clock(self.session)
        sess, choices, ids = session_mod.recommend(self.session, user_ids,
                                                   contexts)
        dt = clock(sess) - t0
        g = self._admit(sess, latency_s=dt, occupancy=_occupancy(sess))
        return g, choices, ids

    def recommend_catalog(self, user_ids, catalog=None, *,
                          k_short: int = 64, clusters=None):
        """Issue against the (tracked) catalog: ``(guarded, item_ids,
        decision_ids, slots, ctx)``, plus a ``RetrievalMetrics`` with
        ``clusters``."""
        cat = self._catalog_or_tracked(catalog)
        t0 = clock(self.session)
        out = session_mod.recommend_catalog(self.session, user_ids, cat,
                                            k_short=k_short,
                                            clusters=clusters)
        sess = out[0]
        rmet = out[5] if clusters is not None else None
        dt = clock(sess) - t0
        g = self if self.catalog is None else dataclasses.replace(
            self, catalog=cat)
        g = g._admit(sess, latency_s=dt, occupancy=_occupancy(sess),
                     tiles_skipped=(None if rmet is None
                                    else rmet.skip_ratio()))
        return (g,) + tuple(out[1:])

    def observe_delayed(self, decision_ids, rewards):
        """The delayed fold; with a tracked catalog, feedback for churned
        items is quarantined against the CURRENT epoch."""
        sess = session_mod.observe_delayed(self.session, decision_ids,
                                           rewards, catalog=self.catalog)
        got = decision_ids >= 0
        delivered = int(torch.sum(got.to(torch.int32)))
        ctr = float(torch.sum(torch.where(got, rewards, 0.0))) / max(
            1, delivered)
        return self._admit(sess, ctr=ctr, occupancy=_occupancy(sess),
                           interactions=delivered)

    def observe_recall(self, recall: float) -> "Guarded":
        """Feed an externally computed recall probe."""
        return self._admit(self.session, recall=recall)

    # -- guarded catalog churn ---------------------------------------------
    def stage_churn(self, *, add=None, retire=None):
        """Stage churn into the tracked catalog's shadow bank (serving is
        untouched until :meth:`publish`): ``retire`` [m] global item ids,
        ``add`` [m, d] embeddings.  Returns ``(guarded, slot_ids)`` (None without
        ``add``)."""
        cat = self._catalog_or_tracked(None)
        col = self.session.col
        slots = None
        if retire is not None:
            cat, _ = catalog_mod.retire_items(cat, retire, col)
        if add is not None:
            cat, slots, _ = catalog_mod.add_items(cat, add, col)
        return dataclasses.replace(self, catalog=cat), slots

    def publish(self, keep_mask=None) -> "Guarded":
        """Publish the staged epoch and admit the churn sample (share of
        capacity changed): a ``churn_ceiling`` breach rolls state AND
        catalog back.  ``keep_mask`` is fault injection only, a torn
        publish (``core.catalog.torn_publish``)."""
        cat = self._catalog_or_tracked(None)
        col = self.session.col
        churn = (float(catalog_mod.staged_churn(cat, col))
                 / (cat.capacity * col.n_shards))
        if keep_mask is None:
            cat = catalog_mod.publish(cat)
        else:
            cat = catalog_mod.torn_publish(cat, keep_mask, col)
        g = dataclasses.replace(self, catalog=cat)
        return g._admit(g.session, churn=churn)
