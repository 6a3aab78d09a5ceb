"""Seeded fault injection for the delayed-feedback loop
(``repro.serve.faults``).

Drives a buffer-enabled session through the request/feedback split under
the failures a real feedback pipeline has:

  p_delay / max_delay   feedback arrives 1..max_delay rounds late
  p_loss                feedback never arrives (its slot TTL-expires)
  p_dup                 feedback delivered twice (the second copy is a
                        counted no-op)
  p_flip / flip_after   reward sign-flip from a given round: the
                        poisoning the guardrails exist for
  stall_every / stall_rounds
                        every k-th round the feedback shard stalls for
                        ``stall_rounds`` rounds, then the backlog floods in

Catalog churn (:func:`run_faulted_catalog`, serving against a
double-buffered ``core.catalog.Catalog`` with the quarantine live):

  churn_every / churn_add / churn_retire
                        every k-th round stage ``churn_add`` fresh items
                        (in the env's planted regions) and
                        ``churn_retire`` random live retirements, then
                        publish a new epoch
  swap_stall_rounds     every publish lands this many rounds late
  p_torn                P(a publish is torn): only a random half of the
                        staged slots land (``core.catalog.torn_publish``)
  flash_crowd_at / flash_crowd_size
                        one burst of arrivals in the hottest region
  mass_retire_at        retire every item of the hottest region

Two random streams, kept apart: the traffic (users, contexts, Bernoulli
uniforms, churn items) comes from a :class:`TrafficStream`, and the
fault draws from NumPy ``default_rng(spec.seed)``, draw for draw as in
``repro``, so a faulted run and its clean control (``FaultSpec()``) see
the same traffic and any gap is the faults'.

Issue-time accounting: ``expected``/``best``/``rand`` are scored when
the decision is made, the delivered (possibly flipped) reward is what
the learner folds, and ``report.reward`` is the true realized reward.

Pass a ``guardrails.Guarded`` wrapper instead of a bare session and every
transaction goes through its monitors.  ``python -m
repro_torch.launch.faultrun`` is the CLI.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core import catalog as catalog_mod
from ..core import env as bandit_env
from ..core import env_ops
from . import guardrails as guardrails_mod
from . import pending as pending_mod
from . import session as session_mod


class FaultSpec(NamedTuple):
    seed: int = 0
    p_delay: float = 0.0
    max_delay: int = 4
    p_loss: float = 0.0
    p_dup: float = 0.0
    p_flip: float = 0.0
    flip_after: int = 0
    stall_every: int = 0
    stall_rounds: int = 2
    # -- catalog churn faults (run_faulted_catalog only) --
    churn_every: int = 0        # publish cadence in rounds; 0 = no churn
    churn_add: int = 0          # fresh items staged per churn event
    churn_retire: int = 0       # random live retirements per churn event
    swap_stall_rounds: int = 0  # publishes land this many rounds late
    p_torn: float = 0.0         # P(publish is torn/partial)
    flash_crowd_at: int = -1    # round of a hot-region arrival burst
    flash_crowd_size: int = 0
    mass_retire_at: int = -1    # round the hot region retires wholesale


class FaultReport(NamedTuple):
    rounds: int
    interactions: int       # valid decisions issued
    reward: float           # TRUE realized reward sum (pre-corruption)
    expected: float         # sum E[r | choice] at issue
    best: float             # sum max_k E[r | k] at issue
    rand_reward: float      # sum of the RAN baseline at issue
    regret: float           # best - expected, summed
    delivered: int          # feedback entries handed to observe_delayed
    tx_per_s: float         # recommend + observe transactions per second
    pending: dict           # final pending-buffer counters (incl. stale)
    events: tuple           # guardrail events (() for a bare session)
    publishes: int = 0      # catalog epochs published (churn runs)
    items_added: int = 0    # items staged in across the run
    items_retired: int = 0  # items staged out across the run


class Tape(NamedTuple):
    """Recorded traffic for :class:`TrafficStream`: per round ``users [R,
    B]``, Bernoulli ``uniforms [R, B]`` and, for slate traffic, ``contexts
    [R, B, K, d]``; ``churn`` maps a churn draw's step to its ``[m, d]``
    item embeddings."""

    users: torch.Tensor
    uniforms: torch.Tensor
    contexts: torch.Tensor | None = None
    churn: dict | None = None


class TrafficStream:
    """The seeded traffic of clean controls, faulted runs and every
    experiment arm (``serve.experiments``): two streams built with the
    same ``key`` see the same users, contexts and reward uniforms.

    Round ``i`` owns the hash steps ``4 i .. 4 i + 2`` as (users,
    contexts, reward uniforms), ``repro``'s lattice of fold-in indices;
    catalog traffic draws no contexts and takes ``4 i, 4 i + 1`` as
    (users, uniforms).  Each value is the splitmix counter hash of
    ``core.env_ops`` keyed by (key, step, slot), computed on ``device``
(default ``cuda``; it raises without a card unless given ``"cpu"``).
    Churn items come from ``core.env.sample_churn_items`` with a
    generator seeded from (seed, step).  Given a :class:`Tape` the stream
    serves the recorded traffic instead (the parity tests replay
    ``repro``'s draws through it)."""

    def __init__(self, key: int, batch: int, n_users: int, *,
                 K: int | None = None, d: int | None = None, device=None,
                 tape: Tape | None = None):
        self.key = int(key)
        self.batch = int(batch)
        self.n_users = int(n_users)
        self.K = K
        self.d = d
        self.device = resolve_device(device)
        self.tape = tape

    def _bits(self, step: int, n: int) -> torch.Tensor:
        return env_ops.traffic_bits(self.key, step, n, self.device)

    def _users(self, step: int) -> torch.Tensor:
        return env_ops.bits_to_ints(self._bits(step, self.batch),
                                    self.n_users).to(torch.int32)

    def _uniforms(self, step: int) -> torch.Tensor:
        return env_ops.bits_to_uniforms(self._bits(step, self.batch))

    def slate_batch(self, i: int):
        """(users [B] i32, contexts [B, K, d], reward uniforms [B])."""
        if self.tape is not None:
            t = self.tape
            return t.users[i], t.contexts[i], t.uniforms[i]
        B, K, d = self.batch, self.K, self.d
        ctx = env_ops.bits_to_normals(self._bits(4 * i + 1, B * K * d))
        return (self._users(4 * i), ctx.view(B, K, d) / math.sqrt(d),
                self._uniforms(4 * i + 2))

    def catalog_batch(self, i: int):
        """(users [B] i32, reward uniforms [B]): the contexts are the
        served shortlist's."""
        if self.tape is not None:
            return self.tape.users[i], self.tape.uniforms[i]
        return self._users(4 * i), self._uniforms(4 * i + 1)

    def churn_items(self, env, seed: int, step: int, m: int,
                    region: int | None = None) -> torch.Tensor:
        """``m`` fresh item embeddings in ``env``'s planted regions (all
        in ``region`` when given), drawn at (seed, step)."""
        if self.tape is not None:
            return self.tape.churn[step]
        dev = env.region_centroids.device
        g = torch.Generator(device=dev).manual_seed(
            env_ops.churn_seed(seed, step))
        return bandit_env.sample_churn_items(env, g, m, region=region)[0]


class Harness:
    """The delivery queue, its fault draws and the run's totals, shared
    by :func:`run_faulted`, :func:`run_faulted_catalog` and
    ``serve.experiments.run_experiment``.  ``fold(ids, rewards)`` applies
    one feedback batch."""

    def __init__(self, spec: FaultSpec, batch: int, device):
        self.spec, self.batch, self.device = spec, batch, device
        self.rng = np.random.default_rng(spec.seed)
        self.queue: list[list] = []     # [due_round, decision_id, reward]
        self.stalled_until = -1
        self.tot = dict(interactions=0, reward=0.0, expected=0.0, best=0.0,
                        rand=0.0, delivered=0)
        self.n_tx = 0

    def account(self, ids_np, realized, expected, best, rand):
        """Issue-time totals of the valid decisions; host copies back."""
        r_np = realized.cpu().numpy().astype(np.float32)
        valid = ids_np >= 0
        t = self.tot
        t["interactions"] += int(valid.sum())
        t["reward"] += float(np.where(valid, r_np, 0).sum())
        t["expected"] += float(np.where(valid, expected.cpu().numpy(),
                                        0).sum())
        t["best"] += float(np.where(valid, best.cpu().numpy(), 0).sum())
        t["rand"] += float(np.where(valid, rand.cpu().numpy(), 0).sum())
        return r_np

    def draw_faults(self, i: int, r_np: np.ndarray):
        """This round's fault draws, in ``repro``'s order: ``(delivered
        rewards, lost, lag, dup)``."""
        spec, rng, B = self.spec, self.rng, self.batch
        flip = (i >= spec.flip_after) & (rng.random(B) < spec.p_flip)
        r_del = np.where(flip, -r_np, r_np)
        lost = rng.random(B) < spec.p_loss
        delayed = rng.random(B) < spec.p_delay
        lag = np.where(delayed, rng.integers(1, spec.max_delay + 1, B), 0)
        dup = rng.random(B) < spec.p_dup
        return r_del, lost, lag, dup

    def enqueue(self, i, ids_np, valid, r_del, lost, lag, dup):
        spec, rng = self.spec, self.rng
        for b in np.nonzero(valid & ~lost)[0]:
            self.queue.append([i + int(lag[b]), int(ids_np[b]),
                               float(r_del[b])])
            if dup[b]:
                extra = int(rng.integers(0, spec.max_delay + 1))
                self.queue.append([i + int(lag[b]) + extra, int(ids_np[b]),
                                   float(r_del[b])])

    def issue(self, i, ids_np, realized, expected, best, rand):
        """Account one issued batch, draw its faults, queue its
        feedback."""
        r_np = self.account(ids_np, realized, expected, best, rand)
        r_del, lost, lag, dup = self.draw_faults(i, r_np)
        self.enqueue(i, ids_np, ids_np >= 0, r_del, lost, lag, dup)

    def round_end(self, i, fold):
        spec = self.spec
        if spec.stall_every and (i + 1) % spec.stall_every == 0:
            self.stalled_until = i + spec.stall_rounds
        if i >= self.stalled_until:
            self.deliver(i, fold)

    def deliver(self, now, fold):
        due = [e for e in self.queue if e[0] <= now]
        self.queue = [e for e in self.queue if e[0] > now]
        B = self.batch
        for lo in range(0, len(due), B):
            chunk = due[lo:lo + B]
            ids = np.full((B,), -1, np.int32)
            rs = np.zeros((B,), np.float32)
            ids[:len(chunk)] = [e[1] for e in chunk]
            rs[:len(chunk)] = [e[2] for e in chunk]
            fold(torch.from_numpy(ids).to(self.device),
                 torch.from_numpy(rs).to(self.device))
            self.n_tx += 1
            self.tot["delivered"] += len(chunk)

    def drain(self, fold):
        if self.queue:
            self.deliver(max(e[0] for e in self.queue), fold)

    def report(self, rounds, dt, pending, events, **extra) -> FaultReport:
        t = self.tot
        return FaultReport(
            rounds=rounds, interactions=t["interactions"], reward=t["reward"],
            expected=t["expected"], best=t["best"], rand_reward=t["rand"],
            regret=t["best"] - t["expected"], delivered=t["delivered"],
            tx_per_s=self.n_tx / max(dt, 1e-9), pending=pending,
            events=events, **extra)


def _inner(session):
    return session.session if isinstance(
        session, guardrails_mod.Guarded) else session


def run_faulted(session, theta, rounds: int, spec: FaultSpec, *,
                batch: int = 32, key: int = 0, drain: bool = True,
                stream: TrafficStream | None = None):
    """``rounds`` of issue -> fault-mangled delivery -> delayed fold.

    ``session`` is a buffer-enabled ``OnlineBandit`` or a
    ``guardrails.Guarded`` around one; ``theta [n_users, d]`` defines the
    Bernoulli environment.  ``stream`` defaults to ``TrafficStream(key,
    ...)`` on the session's device.  Returns ``(session, FaultReport)``
    with the session in its final state (the type passed in)."""
    guarded = isinstance(session, guardrails_mod.Guarded)
    inner = _inner(session)
    if inner.pending is None:
        raise ValueError("run_faulted needs a buffer-enabled session "
                         "(create with pending_capacity > 0)")
    cfg = inner.policy.cfg
    dev = guardrails_mod.session_device(inner)
    if stream is None:
        stream = TrafficStream(key, batch, cfg.n_users,
                               K=cfg.hyper.n_candidates, d=cfg.d,
                               device=dev)
    h = Harness(spec, batch, dev)

    def fold(ids, rs):
        nonlocal session
        session = (session.observe_delayed(ids, rs) if guarded
                   else session_mod.observe_delayed(session, ids, rs))

    t0 = guardrails_mod.clock(inner)
    for i in range(rounds):
        users, ctx, uniforms = stream.slate_batch(i)
        if guarded:
            session, choices, ids = session.recommend(users, ctx)
        else:
            session, choices, ids = session_mod.recommend(session, users,
                                                          ctx)
        h.n_tx += 1
        out = bandit_env.step_rewards(uniforms, theta[users.long()], ctx,
                                      choices)
        h.issue(i, ids.cpu().numpy(), *out)
        h.round_end(i, fold)
    if drain:                       # flush the tail after traffic stops
        h.drain(fold)
    dt = guardrails_mod.clock(_inner(session)) - t0
    return session, h.report(
        rounds, dt, session_mod.pending_stats(_inner(session)),
        session.events if guarded else ())


def run_faulted_catalog(session, env, rounds: int, spec: FaultSpec, *,
                        catalog=None, k_short: int = 16, batch: int = 32,
                        key: int = 0, drain: bool = True,
                        assert_conservation: bool = False,
                        stream: TrafficStream | None = None):
    """Catalog serving under LIVE CHURN and the delivery faults.

    ``session`` is a buffer-enabled ``OnlineBandit`` (pass ``catalog``)
    or a ``guardrails.Guarded`` created WITH a tracked catalog.  ``env``
    is a ``core.env.CatalogEnv``: churn items come from its planted
    regions, the flash crowd targets its hottest region, and rewards
    score the served shortlist.  Delivery folds through
    ``observe_delayed(..., catalog=current)``, so feedback for churned
    items is quarantined (``stale``); with ``assert_conservation`` the
    identity issued == matched + in_flight + expired + dropped + stale is
    checked after every delivery.  Returns ``(session, FaultReport)``."""
    guarded = isinstance(session, guardrails_mod.Guarded)
    if guarded:
        if session.catalog is None:
            raise ValueError("run_faulted_catalog needs the Guarded "
                             "wrapper to track the catalog: create it "
                             "with Guarded.create(..., catalog=cat)")
        catalog = session.catalog
    elif catalog is None:
        raise ValueError("run_faulted_catalog needs a catalog")
    inner = _inner(session)
    if inner.pending is None:
        raise ValueError("run_faulted_catalog needs a buffer-enabled "
                         "session (create with pending_capacity > 0)")
    cfg = inner.policy.cfg
    dev = guardrails_mod.session_device(inner)
    theta = env.theta
    n_regions = env.region_centroids.shape[1]
    hot = int(np.bincount(env.item_region.cpu().numpy(),
                          minlength=n_regions).argmax())
    if stream is None:
        stream = TrafficStream(key, batch, cfg.n_users, device=dev)
    churn_key = spec.seed + 0x5EED
    h = Harness(spec, batch, dev)
    rng = h.rng
    publish_due: list[int] = []     # rounds at which a publish lands
    n_pub = n_added = n_retired = 0

    def current_cat():
        return session.catalog if guarded else catalog

    def fold(ids, rs):
        nonlocal session
        if guarded:
            session = session.observe_delayed(ids, rs)
        else:
            session = session_mod.observe_delayed(session, ids, rs,
                                                  catalog=current_cat())
        if assert_conservation:
            p = _inner(session).pending
            gap = pending_mod.conservation_gap(p)
            if gap != 0:
                raise AssertionError(
                    f"conservation identity violated: gap {gap} with "
                    f"{pending_mod.stats(p)}")

    def stage(add=None, retire=None):
        nonlocal session, catalog, n_added, n_retired
        if guarded:
            session, _ = session.stage_churn(add=add, retire=retire)
        else:
            if retire is not None:
                catalog, _ = catalog_mod.retire_items(catalog, retire)
            if add is not None:
                catalog, _, _ = catalog_mod.add_items(catalog, add)
        if retire is not None:
            n_retired += int(retire.shape[0])
        if add is not None:
            n_added += int(add.shape[0])

    def do_publish():
        nonlocal session, catalog, n_pub
        cat = current_cat()
        torn = rng.random() < spec.p_torn
        keep = (torch.from_numpy(rng.random(cat.capacity) < 0.5).to(dev)
                if torn else None)
        if guarded:
            session = session.publish(keep_mask=keep)
        elif keep is None:
            catalog = catalog_mod.publish(catalog)
        else:
            catalog = catalog_mod.torn_publish(catalog, keep)
        n_pub += 1

    t0 = guardrails_mod.clock(inner)
    for i in range(rounds):
        users, uniforms = stream.catalog_batch(i)
        if guarded:
            session, items, ids, slots, ctx = session.recommend_catalog(
                users, k_short=k_short)
        else:
            session, items, ids, slots, ctx = session_mod.recommend_catalog(
                session, users, current_cat(), k_short=k_short)
        h.n_tx += 1
        out = bandit_env.step_rewards(uniforms, theta[users.long()], ctx,
                                      slots)
        h.issue(i, ids.cpu().numpy(), *out)

        # churn events: staged into the shadow bank, published later
        staged = False
        if i == spec.flash_crowd_at and spec.flash_crowd_size > 0:
            stage(add=stream.churn_items(env, churn_key, 2 * i,
                                         spec.flash_crowd_size, region=hot))
            staged = True
        if i == spec.mass_retire_at:
            stage(retire=torch.from_numpy(
                bandit_env.region_item_ids(env, hot)).to(dev))
            staged = True
        if spec.churn_every and (i + 1) % spec.churn_every == 0:
            if spec.churn_retire > 0:
                live_ids = np.nonzero(
                    current_cat().serving.live.cpu().numpy() > 0)[0]
                m = min(spec.churn_retire, len(live_ids))
                if m > 0:
                    stage(retire=torch.from_numpy(rng.choice(
                        live_ids, size=m, replace=False).astype(
                            np.int32)).to(dev))
            if spec.churn_add > 0:
                stage(add=stream.churn_items(env, churn_key, 2 * i + 1,
                                             spec.churn_add))
            staged = True
        if staged:
            publish_due.append(i + spec.swap_stall_rounds)
        while publish_due and publish_due[0] <= i:
            publish_due.pop(0)
            do_publish()
        h.round_end(i, fold)

    while publish_due:                  # land stalled swaps before drain
        publish_due.pop(0)
        do_publish()
    if drain:
        h.drain(fold)
    dt = guardrails_mod.clock(_inner(session)) - t0
    return session, h.report(
        rounds, dt, session_mod.pending_stats(_inner(session)),
        session.events if guarded else (), publishes=n_pub,
        items_added=n_added, items_retired=n_retired)
