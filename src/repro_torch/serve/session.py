"""``OnlineBandit``: policy-pluggable online serving sessions on the stage
engine, single host (``repro.serve.session``).

One serving transaction per request batch:

    session, choices, metrics = serve.step(
        session, key, user_ids, contexts, reward_fn)

scores with the policy's mixed statistics, chooses through the fused
``InteractBackend.choose``, draws the reward, folds the feedback
duplicate-safely and runs the refresh schedule.  ``recommend`` (no state
change) and ``observe`` (fold + refresh) are its two halves.  The port
runs eagerly: each call is a sequence of kernel launches and torch ops,
and the refresh budget is checked on the host.

``key`` is whatever the caller's ``reward_fn(key, user_ids, contexts,
choice)`` needs to draw the reward (a step id, a tape index); the
session only passes it through.  ``reward_fn`` returns realized rewards
``[B]`` or ``(realized, expected, best, rand)`` (``core.env.step_rewards``).

Duplicate-user batches are exact: a batch is folded by occurrence rank
(item i's rank = how many earlier items carry the same user id), one
fused masked rank-1 pass per rank, so every pass updates distinct users.

Catalog serving: ``step_catalog``/``recommend_catalog`` shortlist each
user's ``k_short`` highest-UCB live items of a ``core.catalog.Catalog``
through the streaming top-K engine and rank the shortlist with the fused
choose.  With ``clusters`` (``core.itemclub.ItemClusters``) the shortlist
is cluster-pruned, bit-equal to the unpruned one; a table whose epoch is
not the catalog's falls back to the unpruned stream.

Delayed feedback: a session created with ``pending_capacity > 0`` issues
decisions into ``serve.pending`` on ``recommend``/``recommend_catalog``
and ``observe_delayed`` folds feedback matched by decision id, with the
churn quarantine when given the current catalog.

Padding: rows with ``uid < 0`` or ``uid >= n_users`` are no-ops (choice
0 / item -1, no state change, decision id -1).  Sessions are immutable:
every call returns a new session and leaves its input as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .. import resolve_device
from ..core import itemclub
from ..core.backend import BackendConfig
from ..core.types import BanditHyper, Metrics
from . import pending as pending_mod
from . import policies as pol

_ENGINE = BackendConfig.create().interact()


def embed_candidates(item_embed: torch.Tensor, cand_ids: torch.Tensor):
    """Model item embeddings -> unit-norm bandit contexts [B, K, d]."""
    e = item_embed[cand_ids.long()]
    return e / torch.clamp_min(torch.linalg.norm(e, dim=-1, keepdim=True),
                               1e-9)


# ---------------------------------------------------------------------------
# the transaction body
# ---------------------------------------------------------------------------


def _occurrence_ranks(user_ids: torch.Tensor) -> torch.Tensor:
    """rank[i] = number of earlier batch items with the same user id."""
    eq = user_ids[:, None] == user_ids[None, :]
    return torch.sum(torch.tril(eq, diagonal=-1), dim=1).to(torch.int32)


def _normalize_rewards(out):
    if isinstance(out, (tuple, list)):
        return tuple(out)
    z = torch.zeros_like(out)
    return out, z, z, z


def _request_masks(policy, user_ids):
    """(idx, valid): clamped row index per request and its validity."""
    n = policy.cfg.n_users
    valid = (user_ids >= 0) & (user_ids < n)
    return torch.clamp(user_ids, 0, n - 1).long(), valid


def _choose(policy, state, user_ids, contexts):
    idx, valid = _request_masks(policy, user_ids)
    w, minv_eff, occ_rows = policy.gather_score(state, idx)
    x, choice = _ENGINE.choose(w, minv_eff, contexts, occ_rows,
                               policy.cfg.hyper.alpha)
    choice = torch.where(valid, choice, 0)
    x = torch.where(valid[:, None], x, 0.0)
    return choice, x, idx, valid


def _fold_feedback(policy, state, idx, valid, user_ids, x, realized):
    """One fused masked pass per occurrence rank (a distinct-user batch
    takes exactly one)."""
    if not user_ids.numel():
        return state
    ranks = _occurrence_ranks(user_ids)
    n_passes = int(torch.max(torch.where(valid, ranks, -1))) + 1
    for k in range(n_passes):
        state = policy.apply_pass(state, idx, x, realized,
                                  valid & (ranks == k), _ENGINE)
    return state


def _schedule_refresh(policy, state, n_new):
    """Count the batch's interactions; refresh once the budget is spent."""
    state = state._replace(since_refresh=state.since_refresh + n_new)
    every = policy.cfg.refresh_every
    if policy.has_refresh and every > 0 and int(state.since_refresh) >= every:
        state = policy.refresh(state)._replace(
            since_refresh=torch.zeros_like(state.since_refresh))
    return state


def _apply_feedback(policy, state, idx, valid, user_ids, x, rewards):
    realized, expected, best, rand = rewards
    state = _fold_feedback(policy, state, idx, valid, user_ids, x, realized)
    n_new = torch.sum(valid.to(torch.int32))
    state = _schedule_refresh(policy, state, n_new)
    vm = valid.to(realized.dtype)
    return state, Metrics(reward=torch.sum(realized * vm),
                          regret=torch.sum((best - expected) * vm),
                          rand_reward=torch.sum(rand * vm),
                          interactions=n_new)


# ---------------------------------------------------------------------------
# catalog-scale retrieval: shortlist -> fused choose
# ---------------------------------------------------------------------------


def _catalog_choose(policy, rb, state, user_ids, catalog, clusters=None):
    """Shortlist each request user's ``K_short`` best live items, then
    rank the shortlist with the fused choose.  Invalid requests score with
    zero statistics (as the reference's masked psum leaves them) and
    return item -1.  Underfull shortlist slots are filled with the user's
    top entry, so the filler never outranks a real candidate."""
    idx, valid = _request_masks(policy, user_ids)
    w, minv_eff, occ_rows = policy.gather_score(state, idx)
    w = torch.where(valid[:, None], w, 0.0)
    minv_eff = torch.where(valid[:, None, None], minv_eff, 0.0)
    occ_rows = torch.where(valid, occ_rows, 0)
    alpha = policy.cfg.hyper.alpha

    bank = catalog.serving
    rmet = None
    if clusters is None:
        sc, ids = rb.shortlist(w, minv_eff, occ_rows, bank.emb, bank.live,
                               alpha)
    elif itemclub.is_fresh(clusters, catalog):
        sc, ids, skipped, total = rb.shortlist_pruned(
            w, minv_eff, occ_rows, clusters.emb_sorted, clusters.live_sorted,
            clusters.perm, clusters.tile_mu, clusters.tile_r,
            clusters.tile_xn, clusters.tile_n, alpha)
        rmet = itemclub.RetrievalMetrics(skipped, total, 1)
    else:   # a publish landed after the last rebuild: stale bounds
        sc, ids = rb.shortlist(w, minv_eff, occ_rows, bank.emb, bank.live,
                               alpha)
        rmet = itemclub.RetrievalMetrics(0, 0, 0)
    # one shard: the shortlist is already in (score desc, id asc) order
    top_i = torch.where(torch.isfinite(sc), ids, ids[:, :1])
    ok = (top_i >= 0) & (top_i < catalog.capacity)
    rows = bank.emb[torch.clamp(top_i, 0, catalog.capacity - 1).long()]
    ctx = torch.where(ok[..., None], rows, 0.0).contiguous()
    x, slot = _ENGINE.choose(w, minv_eff, ctx, occ_rows, alpha)
    item = torch.take_along_dim(top_i, slot.long()[:, None], dim=1)[:, 0]
    item = torch.where(valid, item, -1)
    return item, slot, ctx, x, idx, valid, rmet


# ---------------------------------------------------------------------------
# the churn quarantine of delayed feedback
# ---------------------------------------------------------------------------


def _stale_mask(pend, decision_ids, catalog):
    """Feedback for a decision issued at epoch ``e`` folds iff the
    published epoch is at most ``e + 1`` AND its item is still live in the
    active bank with ``born <= e``."""
    C = pend.uid.shape[0]
    slot = torch.remainder(torch.where(decision_ids >= 0, decision_ids, 0),
                           C).long()
    item = pend.choice[slot]
    e_issue = pend.epoch[slot]
    bank = catalog.serving
    in_range = (item >= 0) & (item < catalog.capacity)
    li = torch.clamp(item, 0, catalog.capacity - 1).long()
    item_ok = in_range & (bank.live[li] > 0) & (bank.born[li] <= e_issue)
    fresh = (catalog.epoch - e_issue) <= 1
    return ~(item_ok & fresh)


# ---------------------------------------------------------------------------
# the session object + functional API
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OnlineBandit:
    """One serving session: a policy, its state, and optionally a pending
    buffer.  Immutable: the functions below return a new session."""

    policy: Any
    state: Any
    pending: Any = None     # PendingBuffer, or None = synchronous-only
    ttl: int = 0            # pending TTL in issue transactions

    @classmethod
    def create(cls, n_users: int, d: int, hyper: BanditHyper, *,
               policy: str = "distclub", refresh_every: int = 0,
               pending_capacity: int = 0, pending_ttl: int = 64,
               seed: int = 0, device=None) -> "OnlineBandit":
        """Single-host session on ``device`` (default cuda; raises without
        a card unless ``device="cpu"``).  ``refresh_every`` is the
        interaction budget between refreshes (<= 0: only ``refresh``);
        ``pending_capacity > 0`` enables delayed feedback, where a
        decision survives ``pending_ttl`` later issues; ``seed`` keys a
        randomized refresh (dccb's gossip peers)."""
        dev = resolve_device(device)
        cfg = pol.make_cfg(n_users, d, hyper, refresh_every=refresh_every,
                           seed=seed)
        p = pol.get_policy(policy, cfg)
        pend = (pending_mod.init(pending_capacity, d, device=dev)
                if pending_capacity > 0 else None)
        return cls(policy=p, state=p.init(dev), pending=pend,
                   ttl=int(pending_ttl))

    @classmethod
    def from_offline(cls, state, hyper: BanditHyper, *,
                     refresh_every: int = 0, pending_capacity: int = 0,
                     pending_ttl: int = 64) -> "OnlineBandit":
        """A distclub session warm-started from an offline
        ``core.distclub.run`` state, on that state's device."""
        n, d = state.lin.b.shape
        cfg = pol.make_cfg(n, d, hyper, refresh_every=refresh_every)
        pend = (pending_mod.init(pending_capacity, d,
                                 device=state.lin.b.device)
                if pending_capacity > 0 else None)
        return cls(policy=pol.get_policy("distclub", cfg),
                   state=pol.from_distclub_state(state), pending=pend,
                   ttl=int(pending_ttl))

    def step(self, key, user_ids, contexts, reward_fn):
        return step(self, key, user_ids, contexts, reward_fn)

    def recommend(self, user_ids, contexts):
        return recommend(self, user_ids, contexts)

    def observe(self, user_ids, contexts, choices, rewards):
        return observe(self, user_ids, contexts, choices, rewards)

    def step_catalog(self, key, user_ids, catalog, reward_fn, *,
                     k_short: int = 64, clusters=None):
        return step_catalog(self, key, user_ids, catalog, reward_fn,
                            k_short=k_short, clusters=clusters)

    def recommend_catalog(self, user_ids, catalog, *, k_short: int = 64,
                          clusters=None):
        return recommend_catalog(self, user_ids, catalog, k_short=k_short,
                                 clusters=clusters)

    def observe_delayed(self, decision_ids, rewards, catalog=None):
        return observe_delayed(self, decision_ids, rewards, catalog=catalog)

    def reset_pending(self):
        return reset_pending(self)

    def refresh(self):
        return refresh(self)


def step(session: OnlineBandit, key, user_ids, contexts,
         reward_fn: Callable):
    """One serving transaction over a caller-supplied slate ``contexts
    [B, K, d]``: ``(session, choices [B] i32, metrics)``."""
    choice, x, idx, valid = _choose(session.policy, session.state, user_ids,
                                    contexts)
    rewards = _normalize_rewards(reward_fn(key, user_ids, contexts, choice))
    state, metrics = _apply_feedback(session.policy, session.state, idx,
                                     valid, user_ids, x, rewards)
    return dataclasses.replace(session, state=state), choice, metrics


def _pending_guard(session: OnlineBandit, B: int):
    cap = session.pending.uid.shape[0]
    if B > cap:
        raise ValueError(
            f"pending capacity {cap} < batch width {B}: a batch of "
            "consecutive decision ids must land on distinct ring slots")


def recommend(session: OnlineBandit, user_ids, contexts):
    """The request half: ``choices [B]`` on a synchronous session; on a
    buffer-enabled one it ISSUES and returns ``(session, choices,
    decision_ids)`` (padding requests get id -1)."""
    choice, x, _, valid = _choose(session.policy, session.state, user_ids,
                                  contexts)
    if session.pending is None:
        return choice
    _pending_guard(session, user_ids.shape[0])
    pend, ids = pending_mod.issue(session.pending, user_ids, choice, x,
                                  valid, session.ttl)
    return dataclasses.replace(session, pending=pend), choice, ids


def observe(session: OnlineBandit, user_ids, contexts, choices, rewards):
    """The feedback half: fold a batch of (possibly duplicate-user)
    rewards and run the refresh schedule."""
    idx, valid = _request_masks(session.policy, user_ids)
    x = torch.take_along_dim(contexts, choices.long()[:, None, None],
                             dim=1)[:, 0]
    state = _fold_feedback(session.policy, session.state, idx, valid,
                           user_ids, x, rewards)
    state = _schedule_refresh(session.policy, state,
                              torch.sum(valid.to(torch.int32)))
    return dataclasses.replace(session, state=state)


def step_catalog(session: OnlineBandit, key, user_ids, catalog,
                 reward_fn: Callable, *, k_short: int = 64, clusters=None):
    """One serving transaction against a persistent catalog: the slate is
    each user's ``k_short`` shortlist.  ``reward_fn(key, user_ids, ctx,
    slot)`` sees the ``[B, k_short, d]`` shortlist and the chosen slot.
    Returns ``(session, item_ids [B] global slot ids, metrics)``, plus a
    ``RetrievalMetrics`` when ``clusters`` is given."""
    rb = BackendConfig.create().retrieval(k_short)
    item, slot, ctx, x, idx, valid, rmet = _catalog_choose(
        session.policy, rb, session.state, user_ids, catalog, clusters)
    rewards = _normalize_rewards(reward_fn(key, user_ids, ctx, slot))
    state, metrics = _apply_feedback(session.policy, session.state, idx,
                                     valid, user_ids, x, rewards)
    session = dataclasses.replace(session, state=state)
    if clusters is None:
        return session, item, metrics
    return session, item, metrics, rmet


def recommend_catalog(session: OnlineBandit, user_ids, catalog, *,
                      k_short: int = 64, clusters=None):
    """The request half against a catalog.  Synchronous session:
    ``(item_ids, slots, contexts)``; feed ``(user_ids, contexts, slots,
    rewards)`` to :func:`observe`.  Buffer-enabled: ``(session, item_ids,
    decision_ids, slots, contexts)``.  ``clusters`` appends a
    ``RetrievalMetrics``."""
    rb = BackendConfig.create().retrieval(k_short)
    item, slot, ctx, x, _, valid, rmet = _catalog_choose(
        session.policy, rb, session.state, user_ids, catalog, clusters)
    tail = () if clusters is None else (rmet,)
    if session.pending is None:
        return (item, slot, ctx) + tail
    _pending_guard(session, user_ids.shape[0])
    pend, ids = pending_mod.issue(session.pending, user_ids, item, x, valid,
                                  session.ttl, epoch=catalog.epoch)
    return (dataclasses.replace(session, pending=pend), item, ids, slot,
            ctx) + tail


def observe_delayed(session: OnlineBandit, decision_ids, rewards,
                    catalog=None):
    """Fold delayed feedback matched by decision id (exact under
    out-of-order and duplicate delivery; TTL-expired feedback drops).
    With the CURRENT ``catalog``, feedback whose item churned since issue
    is quarantined (counted ``stale``).  Read counters with
    :func:`pending_stats`."""
    if session.pending is None:
        raise ValueError("observe_delayed needs a buffer-enabled session: "
                         "create it with pending_capacity > 0")
    stale = (None if catalog is None
             else _stale_mask(session.pending, decision_ids, catalog))
    pend, uids, x = pending_mod.match(session.pending, decision_ids,
                                      stale=stale)
    idx, valid = _request_masks(session.policy, uids)
    state = _fold_feedback(session.policy, session.state, idx, valid, uids,
                           x, rewards)
    state = _schedule_refresh(session.policy, state,
                              torch.sum(valid.to(torch.int32)))
    return dataclasses.replace(session, state=state, pending=pend)


def reset_pending(session: OnlineBandit) -> OnlineBandit:
    """Free every pending slot but keep the id counter monotone."""
    if session.pending is None:
        return session
    return dataclasses.replace(session,
                               pending=pending_mod.clear(session.pending))


def pending_stats(session: OnlineBandit) -> dict[str, float]:
    """Host-side pending counters; empty on a synchronous session."""
    if session.pending is None:
        return {}
    return pending_mod.stats(session.pending)


def refresh(session: OnlineBandit) -> OnlineBandit:
    """Force one refresh now (stage 2 for the clustered policies, a no-op
    for linucb) and reset the budget."""
    state = session.policy.refresh(session.state)
    return dataclasses.replace(session, state=state._replace(
        since_refresh=torch.zeros_like(state.since_refresh)))
