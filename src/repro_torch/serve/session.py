"""``OnlineBandit``: policy-pluggable online serving sessions on the stage
engine (``repro.serve.session``).

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

Sharding: ``OnlineBandit.sharded(col, ...)`` is one rank's share of a
session whose users are split over the ranks of ``col``
(``runtime.collectives.DistCollectives``) in rank order.  Every rank
sees the whole request batch; each scores and folds the users it owns,
and the per-request results (choice and chosen context) are summed over
the ranks, non-owners contributing zeros.  Against a catalog each rank
holds its item slice (``core.catalog.item_shard``): the owners' request
rows are replicated by psum, each rank shortlists its own slice
(unpruned, or its piece of the sorted stream, ``itemclub.shard_slice``),
the ``[S, B, K_short]`` lists are all-gathered and merged with
``select_topk``, the kernel's own selection routine, and the chosen
shortlist rows are summed from their owners; the merged shortlist is
the one-process shortlist, bit for bit.  The clustered policies'
refresh is stage 2 over ``col``, the code path of
``distributed.distclub_shard``.  The distclub, club and linucb policies
have sharded sessions; dccb is single-host only, as in ``repro``.  The
pending ring, where there is one, is replicated: every rank issues the
psum-combined choices (or items) and chosen contexts, so every rank
holds the same ring, and ``observe_delayed`` matches on every rank,
folds the rows the rank owns and runs the refresh over ``col``.  With
the current catalog, the churn quarantine resolves each decision's item
on the rank whose slice holds it and combines the verdicts by psum.

Precision: ``create``, ``sharded`` and ``from_offline`` take a
``precision`` (``core.backend.Precision``, a preset name, or None for
``REPRO_PRECISION`` / f32).  Under bf16 the clustered and linucb states
keep ``Minv`` in bf16 (``rank1_update_inv_bf16`` folds feedback), and a
catalog may hold bf16 or int8 banks (``core.catalog.make_catalog(...,
precision=)``): the shortlist dequantizes on chip, and the gathered
shortlist rows are dequantized before the choose, so the choose and the
caller's ``reward_fn`` always see f32.

Checkpointing: ``session.save(ckpt, step)`` / ``session.restore(ckpt)``
round-trip the policy state through ``train.checkpoint.CheckpointManager``
with the session's precision tag beside it; ``restore`` refuses a
checkpoint written under another precision.  A restarted session resumes
with the same subsequent choices.  A sharded session saves its global
arrays (its rows gathered over the ranks; rank 0 writes), the same files
as a one-process save of the same state, and a restore takes the
restoring session's own slice, so a session restarted on another number
of ranks, one included, resumes from the same bytes.

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
from ..kernels.topk.ref import nan_rows, select_topk
from ..runtime.collectives import NullCollectives
from . import pending as pending_mod
from . import policies as pol

_ENGINE = BackendConfig.create().interact()
_NULL = NullCollectives()

# the precision policy is checkpointed as a small i32 tag (dtype codes and
# scale block), so that restore can refuse a snapshot written under
# another one (``repro.serve.session``'s tag, code for code)
_PREC_NAMES = ("f32", "bf16", "int8")


def _precision_tag(prec, device=None) -> torch.Tensor:
    return torch.tensor([_PREC_NAMES.index(prec.state_dtype),
                         _PREC_NAMES.index(prec.catalog_dtype),
                         _PREC_NAMES.index(prec.accum_dtype),
                         prec.scale_block], dtype=torch.int32, device=device)


def _decode_precision_tag(codes) -> str:
    def name(c):
        return _PREC_NAMES[c] if 0 <= c < len(_PREC_NAMES) else f"?{c}"

    return (f"Precision(state={name(codes[0])}, catalog={name(codes[1])}, "
            f"accum={name(codes[2])}, scale_block={codes[3]})")


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


def _request_masks(policy, col, state, user_ids):
    """(idx, own, valid): this rank's row per request (clamped), whether
    this rank owns the request's user, and whether the request is a user
    at all (on one process ``own == valid``)."""
    n = policy.cfg.n_users
    n_local = policy.occ_of(state).shape[0]
    valid = (user_ids >= 0) & (user_ids < n)
    local = user_ids - col.axis_index() * n_local
    own = valid & (local >= 0) & (local < n_local)
    return torch.clamp(local, 0, n_local - 1).long(), own, valid


def _choose(policy, col, state, user_ids, contexts):
    """Score + fused choose; each request's result comes from the rank
    that owns its user."""
    idx, own, valid = _request_masks(policy, col, state, user_ids)
    w, minv_eff, occ_rows = policy.gather_score(state, idx)
    x, choice = _ENGINE.choose(w, minv_eff, contexts, occ_rows,
                               policy.cfg.hyper.alpha)
    choice = col.psum(torch.where(own, choice, 0))
    x = col.psum(torch.where(own[:, None], x, 0.0))
    return choice, x, idx, own, valid


def _fold_feedback(policy, state, idx, own, valid, user_ids, x, realized):
    """One fused masked pass per occurrence rank over the owned rows (a
    distinct-user batch takes exactly one)."""
    if not user_ids.numel():
        return state
    ranks = _occurrence_ranks(user_ids)
    n_passes = int(torch.max(torch.where(valid, ranks, -1))) + 1
    for k in range(n_passes):
        state = policy.apply_pass(state, idx, x, realized,
                                  own & (ranks == k), _ENGINE)
    return state


def _schedule_refresh(policy, col, state, n_new):
    """Count the batch's interactions; refresh once the budget is spent.
    The counter stays i32, ``repro``'s dtype (a torch sum of i32 is
    i64)."""
    state = state._replace(since_refresh=state.since_refresh
                           + n_new.to(state.since_refresh.dtype))
    every = policy.cfg.refresh_every
    if policy.has_refresh and every > 0 and int(state.since_refresh) >= every:
        state = policy.refresh(state, col)._replace(
            since_refresh=torch.zeros_like(state.since_refresh))
    return state


def _apply_feedback(policy, col, state, idx, own, valid, user_ids, x,
                    rewards):
    realized, expected, best, rand = rewards
    state = _fold_feedback(policy, state, idx, own, valid, user_ids, x,
                           realized)
    n_new = torch.sum(valid.to(torch.int32))
    state = _schedule_refresh(policy, col, state, n_new)
    vm = valid.to(realized.dtype)
    return state, Metrics(reward=torch.sum(realized * vm),
                          regret=torch.sum((best - expected) * vm),
                          rand_reward=torch.sum(rand * vm),
                          interactions=n_new)


# ---------------------------------------------------------------------------
# catalog-scale retrieval: shortlist -> fused choose
# ---------------------------------------------------------------------------


def _psum_counts(col, device, *counts):
    """Host ints summed over the ranks."""
    if col.n_shards == 1:
        return counts
    return col.psum(torch.tensor(counts, dtype=torch.int64,
                                 device=device)).tolist()


def _request_rows(policy, col, state, user_ids):
    """``(w, minv_eff, occ, idx, own, valid)``: each request's scoring
    rows on every rank (exactly one rank owns each valid user, and the
    others add zeros), with :func:`_request_masks`' masks.  Invalid
    requests score with zero statistics."""
    idx, own, valid = _request_masks(policy, col, state, user_ids)
    w, minv_eff, occ_rows = policy.gather_score(state, idx)
    w = col.psum(torch.where(own[:, None], w, 0.0))
    minv_eff = col.psum(torch.where(own[:, None, None], minv_eff, 0.0))
    occ_rows = col.psum(torch.where(own, occ_rows, 0))
    return w, minv_eff, occ_rows, idx, own, valid


def _merge_shortlists(col, sc, ids):
    """The ranks' ``[B, k]`` shortlists merged into the one-process
    shortlist with the kernel's own selection routine.  One rank's list
    is already in (score desc, id asc) order, so its merge only takes
    ``select_topk``'s NaN fixed point: a user with a NaN score gets id
    ``INT_MAX`` in every slot, as ``repro``'s merge gives it."""
    if col.n_shards == 1:
        return nan_rows(sc, ids)
    B, k = sc.shape
    sc, ids = (col.all_gather(t).view(-1, B, k).transpose(0, 1)
               .reshape(B, -1) for t in (sc, ids))
    return select_topk(sc, ids, k)


def _direct_shortlist(rb, col, w, minv_eff, occ_rows, catalog, alpha):
    """The unpruned shortlist of replicated request rows over the whole
    catalog: each rank streams its slice (``catalog``), the lists are
    merged.  ``(scores, global slot ids)``, each ``[B, k_short]``."""
    bank = catalog.serving
    quantized = bank.emb.dtype == torch.int8
    sc, ids = rb.shortlist(w, minv_eff, occ_rows, bank.emb, bank.live,
                           alpha, col.axis_index() * catalog.capacity,
                           scales=bank.scale if quantized else None)
    return _merge_shortlists(col, sc, ids)


def _catalog_choose(policy, rb, col, state, user_ids, catalog, clusters=None):
    """Shortlist each request user's ``K_short`` best live items, then
    rank the shortlist with the fused choose.  Invalid requests score with
    zero statistics and return item -1.  Underfull shortlist slots are
    filled with the user's top entry, so the filler never outranks a real
    candidate.  ``catalog`` is this rank's item slice."""
    w, minv_eff, occ_rows, idx, own, valid = _request_rows(
        policy, col, state, user_ids)
    alpha = policy.cfg.hyper.alpha

    bank = catalog.serving
    n_items = catalog.capacity
    row0_items = col.axis_index() * n_items
    # int8 banks ship their per-slot scales into the kernels; f32 and bf16
    # banks need none
    quantized = bank.emb.dtype == torch.int8
    if clusters is not None and itemclub.is_fresh(clusters, catalog):
        emb_s, live_s, ids_s, scale_s, *tabs = itemclub.shard_slice(
            clusters, col.axis_index(), n_items)
        sc, ids, skipped, total = rb.shortlist_pruned(
            w, minv_eff, occ_rows, emb_s, live_s, ids_s, *tabs, alpha,
            scales_sorted=scale_s if quantized else None)
        rmet = itemclub.RetrievalMetrics(
            *_psum_counts(col, w.device, skipped, total), 1)
        sc, ids = _merge_shortlists(col, sc, ids)
    else:   # unpruned, or a publish landed after the last rebuild
        sc, ids = _direct_shortlist(rb, col, w, minv_eff, occ_rows, catalog,
                                   alpha)
        rmet = (None if clusters is None
                else itemclub.RetrievalMetrics(0, 0, 0))
    top_i = torch.where(torch.isfinite(sc), ids, ids[:, :1])
    loc = top_i - row0_items
    ok = (loc >= 0) & (loc < n_items)
    g = torch.clamp(loc, 0, n_items - 1).long()
    # dequantize the gathered shortlist rows before the psum: the slate the
    # choose (and the reward_fn) sees is always f32
    rows = bank.emb[g].float()
    if quantized:
        rows = rows * bank.scale[g][..., None]
    ctx = col.psum(torch.where(ok[..., None], rows, 0.0)).contiguous()
    x, slot = _ENGINE.choose(w, minv_eff, ctx, occ_rows, alpha)
    item = torch.take_along_dim(top_i, slot.long()[:, None], dim=1)[:, 0]
    item = torch.where(valid, item, -1)
    return item, slot, ctx, x, idx, own, valid, rmet


# ---------------------------------------------------------------------------
# the churn quarantine of delayed feedback
# ---------------------------------------------------------------------------


def _stale_mask(col, pend, decision_ids, catalog):
    """Feedback for a decision issued at epoch ``e`` folds iff the
    published epoch is at most ``e + 1`` AND its item is still live in the
    active bank with ``born <= e``.  The item is resolved on the rank
    whose slice holds it and the verdicts are combined by psum."""
    C = pend.uid.shape[0]
    slot = torch.remainder(torch.where(decision_ids >= 0, decision_ids, 0),
                           C).long()
    item = pend.choice[slot]
    e_issue = pend.epoch[slot]
    bank = catalog.serving
    n_local = catalog.capacity
    loc = item - col.axis_index() * n_local
    in_range = (loc >= 0) & (loc < n_local)
    li = torch.clamp(loc, 0, n_local - 1).long()
    ok_here = in_range & (bank.live[li] > 0) & (bank.born[li] <= e_issue)
    item_ok = col.psum(ok_here.to(torch.int32)) > 0
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
    col: Any = _NULL        # the ranks the users are split over

    @classmethod
    def create(cls, n_users: int, d: int, hyper: BanditHyper, *,
               policy: str = "distclub", refresh_every: int = 0,
               pending_capacity: int = 0, pending_ttl: int = 64,
               seed: int = 0, precision=None,
               device=None) -> "OnlineBandit":
        """Single-host session on ``device`` (default cuda; raises without
        a card unless ``device="cpu"``).  ``refresh_every`` is the
        interaction budget between refreshes (<= 0: only ``refresh``);
        ``pending_capacity > 0`` enables delayed feedback, where a
        decision survives ``pending_ttl`` later issues; ``seed`` keys a
        randomized refresh (dccb's gossip peers); ``precision`` (a
        ``Precision``, a preset name, or None: ``REPRO_PRECISION``, f32)
        picks the state dtype, and checkpoints record it."""
        dev = resolve_device(device)
        cfg = pol.make_cfg(n_users, d, hyper, refresh_every=refresh_every,
                           seed=seed, precision=precision)
        p = pol.get_policy(policy, cfg)
        pend = (pending_mod.init(pending_capacity, d, device=dev)
                if pending_capacity > 0 else None)
        return cls(policy=p, state=p.init(dev), pending=pend,
                   ttl=int(pending_ttl))

    @classmethod
    def sharded(cls, col, n_users: int, d: int, hyper: BanditHyper, *,
                policy: str = "distclub", refresh_every: int = 0,
                pending_capacity: int = 0, pending_ttl: int = 64,
                precision=None, device=None) -> "OnlineBandit":
        """This rank's share of a session whose ``n_users`` users are split
        over the ranks of ``col`` in rank order, on ``device`` (default
        cuda; raises without a card unless ``device="cpu"``; under nccl
        the rank's own card).  Raises unless the ranks divide
        ``n_users``.  ``policy`` is distclub, club or linucb (dccb raises
        ``NotImplementedError``: it is single-host only).
        ``pending_capacity > 0`` gives it a replicated pending ring for
        delayed feedback."""
        dev = resolve_device(device)
        cfg = pol.make_cfg(n_users, d, hyper, refresh_every=refresh_every,
                           precision=precision)
        p = pol.get_policy(policy, cfg)
        p.state_specs()            # dccb has no sharded state
        pend = (pending_mod.init(pending_capacity, d, device=dev)
                if pending_capacity > 0 else None)
        return cls(policy=p, state=p.init(dev, col), pending=pend,
                   ttl=int(pending_ttl), col=col)

    @classmethod
    def from_offline(cls, state, hyper: BanditHyper, *,
                     refresh_every: int = 0, pending_capacity: int = 0,
                     pending_ttl: int = 64, col=None,
                     precision=None) -> "OnlineBandit":
        """A distclub session warm-started from an offline
        ``core.distclub.run`` state, on that state's device.  With
        ``col``, this rank's share of a sharded session (its users' rows
        of the state; its pending ring, if any, replicated).  The offline
        state is f32; it is cast down to ``precision``'s state dtype (a
        no-op under f32)."""
        n, d = state.lin.b.shape
        cfg = pol.make_cfg(n, d, hyper, refresh_every=refresh_every,
                           precision=precision)
        st = pol.from_distclub_state(state)
        sdt = cfg.precision.torch_state
        st = st._replace(Minv=st.Minv.to(sdt), uMcinv=st.uMcinv.to(sdt))
        pend = (pending_mod.init(pending_capacity, d,
                                 device=state.lin.b.device)
                if pending_capacity > 0 else None)
        p = pol.get_policy("distclub", cfg)
        if col is not None:
            st = pol.shard_rows(st, col, p.state_specs())
        return cls(policy=p, state=st,
                   pending=pend, ttl=int(pending_ttl),
                   col=_NULL if col is None else col)

    # -- checkpointing -----------------------------------------------------
    def _payload(self, state) -> dict:
        return {"prec": _precision_tag(self.policy.cfg.precision),
                "state": state}

    def global_state(self, state=None):
        """The global arrays of ``state`` (default: this session's), a
        state of this session's layout: on a sharded session its rows
        gathered over the ranks, in rank order."""
        state = self.state if state is None else state
        if self.col.n_shards == 1:
            return state
        return pol.gather_rows(state, self.col, self.policy.state_specs())

    def local_state(self, state):
        """This session's slice of a global ``state``."""
        if self.col.n_shards == 1:
            return state
        return pol.shard_rows(state, self.col, self.policy.state_specs())

    def save(self, ckpt, step: int):
        """Snapshot the policy state with the session's precision tag
        (atomic, keep-K: ``train.checkpoint.CheckpointManager``).  A
        sharded session writes its global arrays from rank 0, and every
        rank returns once the checkpoint is in place."""
        return ckpt.save(self._payload(self.global_state()), step,
                         col=self.col)

    def restore(self, ckpt, step: int | None = None):
        """``(session, step)`` restored from ``ckpt`` (the latest loadable
        checkpoint when ``step`` is None; ``(self, None)`` when the
        directory holds none), tensors on this session's device and, on a
        sharded session, its own slice of the saved global arrays,
        whatever the ranks that saved them.  Raises
        ``ValueError`` when the checkpoint was written under another
        ``Precision``: bf16 state must not come back as f32, nor the
        reverse."""
        like = self._payload(self.state)
        if step is None:
            payload, step = ckpt.restore_latest(like)
            if payload is None:
                return self, None
        else:
            payload = ckpt.restore(step, like)
        got = [int(v) for v in payload["prec"].tolist()]
        want = [int(v) for v in like["prec"].tolist()]
        if got != want:
            raise ValueError(
                f"checkpoint precision mismatch: step {step} was saved "
                f"under {_decode_precision_tag(got)} but this session "
                f"runs {_decode_precision_tag(want)} — recreate the "
                "session with the matching precision= (or re-train)")
        return dataclasses.replace(
            self, state=self.local_state(payload["state"])), step

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
    choice, x, idx, own, valid = _choose(session.policy, session.col,
                                         session.state, user_ids, contexts)
    rewards = _normalize_rewards(reward_fn(key, user_ids, contexts, choice))
    state, metrics = _apply_feedback(session.policy, session.col,
                                     session.state, idx, own, valid,
                                     user_ids, x, rewards)
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
    choice, x, _, _, valid = _choose(session.policy, session.col,
                                     session.state, user_ids, contexts)
    if session.pending is None:
        return choice
    _pending_guard(session, user_ids.shape[0])
    pend, ids = pending_mod.issue(session.pending, user_ids, choice, x,
                                  valid, session.ttl)
    return dataclasses.replace(session, pending=pend), choice, ids


def observe(session: OnlineBandit, user_ids, contexts, choices, rewards):
    """The feedback half: fold a batch of (possibly duplicate-user)
    rewards and run the refresh schedule."""
    idx, own, valid = _request_masks(session.policy, session.col,
                                     session.state, user_ids)
    x = torch.take_along_dim(contexts, choices.long()[:, None, None],
                             dim=1)[:, 0]
    state = _fold_feedback(session.policy, session.state, idx, own, valid,
                           user_ids, x, rewards)
    state = _schedule_refresh(session.policy, session.col, state,
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
    item, slot, ctx, x, idx, own, valid, rmet = _catalog_choose(
        session.policy, rb, session.col, session.state, user_ids, catalog,
        clusters)
    rewards = _normalize_rewards(reward_fn(key, user_ids, ctx, slot))
    state, metrics = _apply_feedback(session.policy, session.col,
                                     session.state, idx, own, valid,
                                     user_ids, x, rewards)
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
    if session.pending is not None:
        _pending_guard(session, user_ids.shape[0])
    rb = BackendConfig.create().retrieval(k_short)
    item, slot, ctx, x, _, _, valid, rmet = _catalog_choose(
        session.policy, rb, session.col, session.state, user_ids, catalog,
        clusters)
    tail = () if clusters is None else (rmet,)
    if session.pending is None:
        return (item, slot, ctx) + tail
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
             else _stale_mask(session.col, session.pending, decision_ids,
                              catalog))
    pend, uids, x = pending_mod.match(session.pending, decision_ids,
                                      stale=stale)
    idx, own, valid = _request_masks(session.policy, session.col,
                                     session.state, uids)
    state = _fold_feedback(session.policy, session.state, idx, own, valid,
                           uids, x, rewards)
    state = _schedule_refresh(session.policy, session.col, state,
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
    state = session.policy.refresh(session.state, session.col)
    return dataclasses.replace(session, state=state._replace(
        since_refresh=torch.zeros_like(state.since_refresh)))
