"""Online experiments: sticky traffic splitting over policy arms
(``repro.serve.experiments``).

An :class:`Experiment` runs N arms, each an ``OnlineBandit`` with its
OWN state (any mix of distclub, dccb, club and linucb, or one policy
under different hypers), behind one request stream:

    arms = [serve.OnlineBandit.create(n, d, hyper, policy=p,
                                      pending_capacity=256)
            for p in ("distclub", "dccb", "linucb")]
    exp = experiments.create(arms, selector=experiments.make_selector(3),
                             guard_cfg=GuardrailConfig(ctr_floor=0.3))
    exp, choices, ids = experiments.recommend(exp, user_ids, contexts)
    ...
    exp = experiments.observe_delayed(exp, ids, rewards)

Sticky assignment: each user id hashes (salted lowbias32) to a point of
the unit interval and arm a owns ``[cum_frac[a-1], cum_frac[a])``.  The
hash never changes, so shrinking an arm's share moves exactly the users
whose point falls in the surrendered band.  ``uid < 0`` maps to arm -1
and flows through every arm as padding.

Routing: arm a sees the SAME full-width batch with the requests it does
not own padded to uid -1, runs its own unchanged transaction, and the
per-arm results are merged in request order.  One arm at fraction 1.0
is therefore bit-identical to the plain session.  Decision ids are
arm-encoded, ``global = local * n_arms + arm``, so ``observe_delayed``
routes feedback to each arm's own pending ring.

Thompson-sampling selector: a Beta(alpha, beta) posterior per (context
bucket, arm), success = reward > 0; fractions move only at epoch
boundaries (every ``epoch_rounds`` routing transactions) to the
Monte-Carlo win probabilities, floored at ``floor`` per enabled arm.

Per-arm guardrails (``guard_cfg``): a breaching arm is disabled, its
state rolled back to its last healthy in-memory snapshot (a reference to
an earlier state: the port's sessions never write their input state),
its ring cleared and its traffic re-routed; the last enabled arm is
never disabled.  ``probation_tx > 0`` gives a disabled arm a throttled
comeback.  :func:`save`/:func:`restore` round-trip the whole experiment
through ``train.checkpoint.CheckpointManager``.  :func:`run_experiment`
drives it over ``faults.TrafficStream`` with the fault harness's
delivery faults; ``python -m repro_torch.launch.abrun`` is the CLI.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import env as bandit_env
from . import faults as faults_mod
from . import guardrails as guardrails_mod
from . import session as session_mod

_M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# sticky assignment
# ---------------------------------------------------------------------------


def _hash01(user_ids: torch.Tensor, salt) -> torch.Tensor:
    """uid -> [0, 1), ``repro``'s uint32 lowbias32 mix bit for bit: int64
    arithmetic masked to 32 bits after each multiply (the low 32 bits of a
    wrapped int64 product are the uint32 product's), the top 24 bits
    exact in f32."""
    x = (user_ids.to(torch.int64) & _M32) ^ (int(salt) & _M32)
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _cuts(f: torch.Tensor) -> torch.Tensor:
    """Cumulative cuts with the last set to +inf (the last arm absorbs
    rounding)."""
    cum = torch.cumsum(f, 0)
    cum[-1] = torch.inf
    return cum


def _assign(user_ids, fractions, enabled, salt, scale):
    """arm [B] i32 (-1 = padding).  The primary cut is at the cumulative
    fractions; a request landing on a disabled arm, or outside the
    leading ``scale`` share of a throttled (probation) arm's interval,
    falls through to the cut over the full-scale enabled arms with the
    same hash point, so survivors keep every user they had."""
    h = _hash01(user_ids, salt)
    f = fractions
    cumf = torch.cumsum(f, 0)
    primary = torch.searchsorted(_cuts(f), h, right=True)
    lo = cumf - f
    pos = (h - lo[primary]) / torch.clamp_min(f[primary], 1e-9)
    take = enabled[primary] & ((scale[primary] >= 1.0)
                               | (pos < scale[primary]))
    full = enabled & (scale >= 1.0)
    full = torch.where(torch.any(full), full, enabled)  # all throttled
    f2 = torch.where(full, f, 0.0)
    f2 = f2 / torch.clamp_min(torch.sum(f2), 1e-9)
    secondary = torch.searchsorted(_cuts(f2), h, right=True)
    arm = torch.where(take, primary, secondary).to(torch.int32)
    return torch.where(user_ids >= 0, arm, -1)


def assign_arms(exp_or_uids, fractions=None, enabled=None, salt=0,
                scale=None):
    """Sticky arm per request: ``assign_arms(exp, user_ids)`` or the raw
    form ``assign_arms(user_ids, fractions, enabled, salt[, scale])``."""
    if isinstance(exp_or_uids, Experiment):
        exp, uids = exp_or_uids, fractions
        fractions, enabled, salt = exp.fractions, exp.enabled, exp.salt
        scale = _arm_scales(exp)
    else:
        uids = exp_or_uids
    dev = uids.device

    def vec(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    scale = np.ones(len(fractions)) if scale is None else scale
    return _assign(uids, vec(fractions, torch.float32),
                   vec(enabled, torch.bool), salt,
                   vec(scale, torch.float32))


# ---------------------------------------------------------------------------
# the Thompson-sampling meta-selector
# ---------------------------------------------------------------------------


class TSSelector(NamedTuple):
    """Beta posteriors per (context bucket, arm) and the re-weighting
    policy.  ``bucket_edges`` splits users by lifetime interactions:
    ``(3, 21)`` gives cold_start (< 3) / regular / power_user (> 20);
    ``()`` is one pooled bucket."""

    alpha: Any                  # np [n_buckets, n_arms]
    beta: Any                   # np [n_buckets, n_arms]
    floor: float = 0.05         # minimum enabled-arm traffic fraction
    epoch_rounds: int = 50      # routing transactions between re-weights
    bucket_edges: tuple = ()
    samples: int = 512          # MC draws for the win-probability


def make_selector(n_arms: int, *, floor: float = 0.05,
                  epoch_rounds: int = 50, bucket_edges: tuple = (),
                  samples: int = 512,
                  prior: tuple = (1.0, 1.0)) -> TSSelector:
    """Uniform Beta(1, 1) posteriors over ``len(bucket_edges) + 1``
    buckets."""
    nb = len(bucket_edges) + 1
    return TSSelector(
        alpha=np.full((nb, n_arms), float(prior[0])),
        beta=np.full((nb, n_arms), float(prior[1])),
        floor=float(floor), epoch_rounds=int(epoch_rounds),
        bucket_edges=tuple(bucket_edges), samples=int(samples))


def _buckets_of(sel: TSSelector, counts: np.ndarray) -> np.ndarray:
    if not sel.bucket_edges:
        return np.zeros_like(counts, dtype=np.int64)
    return np.searchsorted(np.asarray(sel.bucket_edges), counts,
                           side="right")


def _posterior_update(sel: TSSelector, buckets, arms, rewards, valid):
    """success = reward > 0 (a click), failure otherwise: a sign-flipped
    delivery counts as a failure, which is what the system observed."""
    a2, b2 = sel.alpha.copy(), sel.beta.copy()
    succ = np.clip(np.asarray(rewards, np.float64), 0.0, 1.0)
    m = np.asarray(valid, bool)
    np.add.at(a2, (buckets[m], arms[m]), succ[m])
    np.add.at(b2, (buckets[m], arms[m]), 1.0 - succ[m])
    return sel._replace(alpha=a2, beta=b2)


def _pooled_update(sel: TSSelector, a: int, reward: float, n: int):
    """The synchronous paths' fold: no per-request rewards reach the host,
    so the arm's successes pool into bucket 0."""
    a2, b2 = sel.alpha.copy(), sel.beta.copy()
    succ = min(max(reward, 0.0), float(n))
    a2[0, a] += succ
    b2[0, a] += n - succ
    return sel._replace(alpha=a2, beta=b2)


def _reweight(sel: TSSelector, enabled, salt: int, epoch: int) -> tuple:
    """Epoch-boundary fractions: per bucket, P(arm is the argmax of one
    posterior draw) by Monte Carlo, buckets pooled by observation count,
    floored at ``sel.floor`` per enabled arm and renormalized; seeded by
    (salt, epoch), so a restored experiment replays the schedule."""
    rng = np.random.default_rng([int(salt) & _M32, int(epoch), 0x7E57])
    en = np.asarray(enabled, bool)
    nb, A = sel.alpha.shape
    wins = np.zeros(A)
    weights = 0.0
    for b in range(nb):
        draws = rng.beta(sel.alpha[b], sel.beta[b], size=(sel.samples, A))
        draws = np.where(en[None, :], draws, -np.inf)
        share = (np.bincount(np.argmax(draws, axis=1), minlength=A)
                 / sel.samples)
        w = float(np.sum(sel.alpha[b] + sel.beta[b])) + 1e-9
        wins += w * share
        weights += w
    p = wins / weights
    p = np.where(en, np.maximum(p, sel.floor), 0.0)
    p = p / p.sum()
    return tuple(float(x) for x in p)


# ---------------------------------------------------------------------------
# the experiment container
# ---------------------------------------------------------------------------

_TOTALS = ("reward", "expected", "best", "rand", "interactions",
           "delivered")


def _zero_totals(n_arms: int) -> dict:
    return {k: np.zeros(n_arms) for k in _TOTALS}


@dataclasses.dataclass(frozen=True)
class Experiment:
    """N arm sessions and the routing state; every transaction returns a
    new Experiment."""

    arms: tuple                 # OnlineBandit per arm
    names: tuple
    fractions: tuple            # configured/selector split over ALL arms
    enabled: tuple              # per-arm bool; disabled = breached
    salt: int
    selector: Any = None        # TSSelector | None
    guard_cfg: Any = None       # guardrails.GuardrailConfig | None
    guards: tuple = ()          # guardrails.GuardrailState per arm
    snapshots: tuple = ()       # per-arm rollback anchor (a state)
    snapshot_every: int = 16    # routing txs between anchor refreshes
    steps: int = 0              # routing transactions so far
    epoch: int = 0              # selector epochs completed
    shares: tuple = ()          # ((step, fractions), ...) over time
    counts: Any = None          # np [n_users] lifetime interaction counts
    totals: Any = None          # per-arm accounting (np [n_arms] each)
    events: tuple = ()          # ("disable", step, name, breaches) etc.
    probation_tx: int = 0       # txs a breached arm sits out; 0 = forever
    probation_fraction: float = 0.25   # throttled share while on probation
    stages: tuple = ()          # per-arm: HEALTHY/BENCHED/PROBATION/PERMANENT
    stage_since: tuple = ()     # step the arm entered its current stage

    @property
    def n_arms(self) -> int:
        return len(self.arms)


# probation life-cycle stages (per arm)
HEALTHY = 0      # serving its full interval
BENCHED = 1      # breached; sitting out the probation window
PROBATION = 2    # re-enabled at probation_fraction of its own interval
PERMANENT = 3    # breached ON probation: never re-enabled


def _arm_scales(exp: Experiment) -> np.ndarray:
    """Per-arm accepted share of its own primary interval (1.0 = all of
    it; 0 for a disabled arm)."""
    st = exp.stages or (HEALTHY,) * exp.n_arms
    return np.array(
        [0.0 if not en
         else (exp.probation_fraction if s == PROBATION else 1.0)
         for en, s in zip(exp.enabled, st)], np.float32)


def create(sessions, *, names=None, fractions=None, salt: int = 0,
           selector: TSSelector | None = None, guard_cfg=None,
           snapshot_every: int = 16, probation_tx: int = 0,
           probation_fraction: float = 0.25) -> Experiment:
    """``sessions`` (each its own ``OnlineBandit``) as experiment arms;
    every arm must share ``(n_users, d)``.  ``fractions`` default to
    uniform.  ``probation_tx > 0`` benches a disabled arm for that many
    routing transactions, then brings it back throttled to
    ``probation_fraction`` of its interval; a clean probation window
    restores it, a breach on probation disables it for good."""
    arms = tuple(sessions)
    if not arms:
        raise ValueError("an experiment needs at least one arm")
    A = len(arms)
    cfg0 = arms[0].policy.cfg
    for s in arms[1:]:
        c = s.policy.cfg
        if (c.n_users, c.d) != (cfg0.n_users, cfg0.d):
            raise ValueError("every arm must share (n_users, d): "
                             f"{(c.n_users, c.d)} vs "
                             f"{(cfg0.n_users, cfg0.d)}")
    if names is None:
        names = []
        for i, s in enumerate(arms):
            n = s.policy.name
            names.append(n if n not in names else f"{n}#{i}")
    names = tuple(names)
    if fractions is None:
        fractions = (1.0 / A,) * A
    fractions = tuple(float(f) for f in fractions)
    if len(fractions) != A or any(f < 0 for f in fractions):
        raise ValueError(f"need {A} non-negative fractions")
    tot = sum(fractions)
    if tot <= 0:
        raise ValueError("fractions sum to zero")
    fractions = tuple(f / tot for f in fractions)
    if selector is not None and selector.alpha.shape[1] != A:
        raise ValueError(f"selector is over {selector.alpha.shape[1]} "
                         f"arms, experiment has {A}")
    if not 0.0 < float(probation_fraction) <= 1.0:
        raise ValueError("probation_fraction must be in (0, 1]")
    return Experiment(
        arms=arms, names=names, fractions=fractions, enabled=(True,) * A,
        salt=int(salt), selector=selector, guard_cfg=guard_cfg,
        guards=(guardrails_mod.GuardrailState(),) * A,
        snapshots=tuple(s.state for s in arms),
        snapshot_every=int(snapshot_every),
        counts=np.zeros(cfg0.n_users, np.int64),
        totals=_zero_totals(A), shares=((0, fractions),),
        probation_tx=int(probation_tx),
        probation_fraction=float(probation_fraction),
        stages=(HEALTHY,) * A, stage_since=(0,) * A)


# ---------------------------------------------------------------------------
# per-arm guardrails: admit -> maybe disable
# ---------------------------------------------------------------------------


def _disable_arm(exp: Experiment, a: int, breaches) -> Experiment:
    """A breached arm: state back to its snapshot, ring cleared, traffic
    re-routed.  The LAST enabled arm is never disabled: the breach is
    recorded and its monitors reset instead."""
    guards = list(exp.guards)
    guards[a] = guardrails_mod.post_rollback_state(exp.guard_cfg, guards[a])
    if sum(exp.enabled) <= 1:
        return dataclasses.replace(
            exp, guards=tuple(guards),
            events=exp.events + (("breach-last-arm", exp.steps,
                                  exp.names[a], breaches),))
    arms = list(exp.arms)
    sess = dataclasses.replace(arms[a], state=exp.snapshots[a])
    arms[a] = session_mod.reset_pending(sess)
    enabled = list(exp.enabled)
    enabled[a] = False
    stages = list(exp.stages or (HEALTHY,) * exp.n_arms)
    since = list(exp.stage_since or (0,) * exp.n_arms)
    on_probation = stages[a] == PROBATION
    stages[a] = (PERMANENT if on_probation or exp.probation_tx <= 0
                 else BENCHED)
    since[a] = exp.steps
    tag = "disable-permanent" if on_probation else "disable"
    return dataclasses.replace(
        exp, arms=tuple(arms), enabled=tuple(enabled), guards=tuple(guards),
        stages=tuple(stages), stage_since=tuple(since),
        events=exp.events + ((tag, exp.steps, exp.names[a], breaches),))


def _admit_arm(exp: Experiment, a: int, **sample) -> Experiment:
    if exp.guard_cfg is None:
        return exp
    gs = guardrails_mod.update(exp.guard_cfg, exp.guards[a], **sample)
    guards = list(exp.guards)
    guards[a] = gs
    exp = dataclasses.replace(exp, guards=tuple(guards))
    if gs.breaches:
        exp = _disable_arm(exp, a, gs.breaches)
    return exp


def _probation_tick(exp: Experiment, steps: int) -> Experiment:
    """A BENCHED arm that has sat out the window comes back THROTTLED; an
    arm clean through a whole probation window is restored."""
    if exp.probation_tx <= 0 or not exp.stages:
        return exp
    stages = list(exp.stages)
    since = list(exp.stage_since)
    enabled = list(exp.enabled)
    events = exp.events
    for a in range(exp.n_arms):
        waited = steps - since[a]
        if stages[a] == BENCHED and waited >= exp.probation_tx:
            enabled[a] = True
            stages[a] = PROBATION
            since[a] = steps
            events = events + (("probation", steps, exp.names[a]),)
        elif stages[a] == PROBATION and waited >= exp.probation_tx:
            stages[a] = HEALTHY
            since[a] = steps
            events = events + (("restore", steps, exp.names[a]),)
    return dataclasses.replace(
        exp, enabled=tuple(enabled), stages=tuple(stages),
        stage_since=tuple(since), events=events)


def _advance(exp: Experiment) -> Experiment:
    """After each routing transaction: the probation life cycle, the
    healthy arms' rollback anchors, and at selector epoch boundaries the
    re-weighted fractions."""
    steps = exp.steps + 1
    exp = dataclasses.replace(exp, steps=steps)
    exp = _probation_tick(exp, steps)
    if (exp.guard_cfg is not None and exp.snapshot_every > 0
            and steps % exp.snapshot_every == 0):
        snaps = tuple(
            arm.state if en and not gs.cooldown_left else snap
            for arm, en, gs, snap in zip(exp.arms, exp.enabled, exp.guards,
                                         exp.snapshots))
        exp = dataclasses.replace(exp, snapshots=snaps)
    sel = exp.selector
    if sel is not None and steps % sel.epoch_rounds == 0:
        fr = _reweight(sel, exp.enabled, exp.salt, exp.epoch)
        exp = dataclasses.replace(
            exp, fractions=fr, epoch=exp.epoch + 1,
            shares=exp.shares + ((steps, fr),))
    return exp


def _note_counts(exp: Experiment, user_ids: np.ndarray) -> Experiment:
    m = (user_ids >= 0) & (user_ids < exp.counts.shape[0])
    c = exp.counts.copy()
    np.add.at(c, user_ids[m], 1)
    return dataclasses.replace(exp, counts=c)


def _fold_totals(exp: Experiment, **per_arm) -> Experiment:
    t = {k: v.copy() for k, v in exp.totals.items()}
    for k, v in per_arm.items():
        t[k] = t[k] + np.asarray(v)
    return dataclasses.replace(exp, totals=t)


# ---------------------------------------------------------------------------
# the routing transactions
# ---------------------------------------------------------------------------


def _routed_sync(exp: Experiment, user_ids, run_arm, empty):
    """The synchronous transactions' partition / merge: ``run_arm(arm,
    masked uids) -> (arm, result [B], metrics)``; the merged result
    starts as ``empty``."""
    arm_of = assign_arms(exp, user_ids)
    arms = list(exp.arms)
    guarded = exp.guard_cfg is not None     # a latency sample syncs
    out = empty
    metrics, samples = [], []
    for a in range(exp.n_arms):
        if not exp.enabled[a]:
            metrics.append(None)
            samples.append(None)
            continue
        mine = arm_of == a
        t0 = guardrails_mod.clock(arms[a]) if guarded else 0.0
        arms[a], res, m = run_arm(arms[a], torch.where(mine, user_ids, -1))
        samples.append(guardrails_mod.clock(arms[a]) - t0 if guarded
                       else None)
        out = torch.where(mine, res, out)
        metrics.append(m)
    exp = dataclasses.replace(exp, arms=tuple(arms))
    exp = _note_counts(exp, torch.where(arm_of >= 0, user_ids, -1)
                       .cpu().numpy())
    per_arm = {k: np.zeros(exp.n_arms) for k in ("reward", "interactions")}
    sel = exp.selector
    for a, m in enumerate(metrics):
        if m is None:
            continue
        n = int(m.interactions)
        per_arm["reward"][a] = float(m.reward)
        per_arm["interactions"][a] = n
        if sel is not None and n > 0:
            sel = _pooled_update(sel, a, float(m.reward), n)
    exp = _fold_totals(dataclasses.replace(exp, selector=sel), **per_arm)
    for a, m in enumerate(metrics):
        if m is None or not guarded:
            continue
        n = int(m.interactions)
        exp = _admit_arm(
            exp, a, ctr=(float(m.reward) / n if n > 0 else None),
            latency_s=samples[a],
            occupancy=guardrails_mod._occupancy(exp.arms[a]),
            interactions=n)
    return _advance(exp), out, tuple(metrics)


def step(exp: Experiment, key, user_ids, contexts, reward_fn):
    """One routed synchronous transaction: each ENABLED arm runs its own
    ``serve.step`` on the masked batch, the choices merge in request
    order.  Returns ``(exp, choices [B], per-arm Metrics or None)``."""
    def run_arm(arm, uids):
        return session_mod.step(arm, key, uids, contexts, reward_fn)

    return _routed_sync(exp, user_ids, run_arm,
                        torch.zeros_like(user_ids, dtype=torch.int32))


def step_catalog(exp: Experiment, key, user_ids, catalog, reward_fn, *,
                 k_short: int = 64, clusters=None):
    """Routed catalog transaction over each arm's ``serve.step_catalog``
    against the SAME catalog.  Returns ``(exp, item_ids [B], metrics)``;
    unrouted rows get -1."""
    def run_arm(arm, uids):
        out = session_mod.step_catalog(arm, key, uids, catalog, reward_fn,
                                       k_short=k_short, clusters=clusters)
        return out[:3]

    return _routed_sync(exp, user_ids, run_arm,
                        torch.full_like(user_ids, -1, dtype=torch.int32))


def recommend(exp: Experiment, user_ids, contexts):
    """The routed request half on buffer-enabled arms: each enabled arm
    issues on its masked batch through its own ring.  Returns ``(exp,
    choices [B], decision_ids [B])``, the ids arm-encoded (``local *
    n_arms + arm``; -1 for padding)."""
    for s in exp.arms:
        if s.pending is None:
            raise ValueError("experiment recommend needs buffer-enabled "
                             "arms (create each with pending_capacity>0)")
    A = exp.n_arms
    arms = list(exp.arms)
    if A == 1 and exp.enabled[0]:
        # the sole arm owns every request and the id encoding is the
        # identity: no mask, no merge
        t0 = guardrails_mod.clock(arms[0]) if exp.guard_cfg else 0.0
        arms[0], choices, ids = session_mod.recommend(arms[0], user_ids,
                                                      contexts)
        exp = dataclasses.replace(exp, arms=tuple(arms))
        if exp.guard_cfg is not None:
            exp = _admit_arm(
                exp, 0, latency_s=guardrails_mod.clock(arms[0]) - t0,
                occupancy=guardrails_mod._occupancy(arms[0]))
        return _advance(exp), choices, ids
    arm_of = assign_arms(exp, user_ids)
    choices = torch.zeros_like(user_ids, dtype=torch.int32)
    gids = torch.full_like(user_ids, -1, dtype=torch.int32)
    guarded = exp.guard_cfg is not None     # a latency sample syncs
    for a in range(A):
        if not exp.enabled[a]:
            continue
        mine = arm_of == a
        t0 = guardrails_mod.clock(arms[a]) if guarded else 0.0
        arms[a], ch, ids = session_mod.recommend(
            arms[a], torch.where(mine, user_ids, -1), contexts)
        choices = torch.where(mine, ch, choices)
        gids = torch.where(mine & (ids >= 0), ids * A + a, gids)
        if guarded:
            exp = _admit_arm(exp, a,
                             latency_s=guardrails_mod.clock(arms[a]) - t0,
                             occupancy=guardrails_mod._occupancy(arms[a]))
    exp = dataclasses.replace(exp, arms=tuple(arms))
    # lifetime counts advance in record_feedback (issue-time accounting)
    return _advance(exp), choices, gids


def observe_delayed(exp: Experiment, decision_ids, rewards):
    """Routed delayed feedback: decode each id's arm and fold its
    sub-batch through that arm's ``serve.observe_delayed``.  Feedback for
    a disabled arm is dropped (its ring was cleared when it was)."""
    gids = decision_ids
    A = exp.n_arms
    if A == 1 and exp.enabled[0]:
        arms = (session_mod.observe_delayed(exp.arms[0], gids, rewards),)
        got = gids >= 0
        n = int(torch.sum(got.to(torch.int32)))
        if exp.guard_cfg is not None and n > 0:
            r = float(torch.sum(torch.where(got, rewards, 0.0)))
            exp = _admit_arm(
                exp, 0, ctr=r / n,
                occupancy=guardrails_mod._occupancy(arms[0]),
                interactions=n)
        exp = dataclasses.replace(exp, arms=arms)
        return _fold_totals(exp, delivered=np.asarray([n], np.float64))
    arm_of = torch.where(gids >= 0, torch.remainder(gids, A), -1)
    local = torch.where(gids >= 0, torch.div(gids, A, rounding_mode="floor"),
                        -1)
    arms = list(exp.arms)
    delivered = np.zeros(A)
    arm_np = arm_of.cpu().numpy()
    for a in range(A):
        if not exp.enabled[a] or not (arm_np == a).any():
            continue
        mine = arm_of == a
        arms[a] = session_mod.observe_delayed(
            arms[a], torch.where(mine, local, -1).to(torch.int32), rewards)
        n = int((arm_np == a).sum())
        delivered[a] = n
        if exp.guard_cfg is not None:
            r = float(torch.sum(torch.where(mine, rewards, 0.0)))
            exp = _admit_arm(
                exp, a, ctr=r / max(1, n),
                occupancy=guardrails_mod._occupancy(arms[a]),
                interactions=n)
    exp = dataclasses.replace(exp, arms=tuple(arms))
    return _fold_totals(exp, delivered=delivered)


def record_feedback(exp: Experiment, user_ids, arms, realized,
                    expected=None, best=None, rand=None,
                    learner_rewards=None) -> Experiment:
    """Issue-time accounting of a routed batch (host arrays): per-arm
    totals, and the selector posteriors with the users' true context
    buckets.  ``learner_rewards`` (default ``realized``) is what will be
    delivered, possibly corrupted, and is what the posterior sees."""
    arms = np.asarray(arms)
    valid = arms >= 0
    r = np.asarray(realized, np.float64)

    def tot(x):
        return np.bincount(arms[valid],
                           weights=np.asarray(x, np.float64)[valid],
                           minlength=exp.n_arms)

    per_arm = {"reward": tot(r),
               "interactions": np.bincount(arms[valid],
                                           minlength=exp.n_arms)}
    for k, v in (("expected", expected), ("best", best), ("rand", rand)):
        if v is not None:
            per_arm[k] = tot(v)
    exp = _fold_totals(exp, **per_arm)
    uids = np.asarray(user_ids)
    if exp.selector is not None:
        lr = r if learner_rewards is None else np.asarray(learner_rewards,
                                                          np.float64)
        n_users = exp.counts.shape[0]
        cnt = np.where((uids >= 0) & (uids < n_users),
                       exp.counts[np.clip(uids, 0, n_users - 1)], 0)
        exp = dataclasses.replace(exp, selector=_posterior_update(
            exp.selector, _buckets_of(exp.selector, cnt), arms, lr, valid))
    return _note_counts(exp, np.where(valid, uids, -1))


# ---------------------------------------------------------------------------
# checkpoint / restore
# ---------------------------------------------------------------------------


def _ckpt_payload(exp: Experiment) -> dict:
    arms = {}
    for i, s in enumerate(exp.arms):
        entry = {"state": s.state, "snap": exp.snapshots[i]}
        if s.pending is not None:
            entry["pending"] = s.pending
        arms[f"arm{i}"] = entry
    sel = ({} if exp.selector is None
           else {"alpha": exp.selector.alpha, "beta": exp.selector.beta})
    meta = {"fractions": np.asarray(exp.fractions, np.float64),
            "enabled": np.asarray(exp.enabled, np.int32),
            "salt": np.asarray(exp.salt, np.int64),
            "steps": np.asarray(exp.steps, np.int64),
            "epoch": np.asarray(exp.epoch, np.int64),
            "counts": exp.counts,
            "stages": np.asarray(exp.stages or (HEALTHY,) * exp.n_arms,
                                 np.int32),
            "stage_since": np.asarray(exp.stage_since or (0,) * exp.n_arms,
                                      np.int64),
            "totals": dict(exp.totals)}
    return {"arms": arms, "selector": sel, "meta": meta}


def save(exp: Experiment, ckpt, step: int):
    """Snapshot the WHOLE experiment (arm states, pending rings, rollback
    anchors, selector posteriors, salt and fractions) as one atomic
    checkpoint entry.  Single-host arms."""
    return ckpt.save(_ckpt_payload(exp), step)


def restore(exp: Experiment, ckpt, step: int | None = None):
    """``(experiment, step)`` from ``ckpt`` (the latest when ``step`` is
    None; ``(exp, None)`` on an empty directory).  Routing and every
    arm's state and ring resume exactly; guardrail EMAs restart."""
    like = _ckpt_payload(exp)
    if step is None:
        payload, step = ckpt.restore_latest(like)
        if payload is None:
            return exp, None
    else:
        payload = ckpt.restore(step, like)
    arms, snaps = [], []
    for i, s in enumerate(exp.arms):
        entry = payload["arms"][f"arm{i}"]
        kw = {"state": entry["state"]}
        if s.pending is not None:
            kw["pending"] = entry["pending"]
        arms.append(dataclasses.replace(s, **kw))
        snaps.append(entry["snap"])
    sel = exp.selector
    if sel is not None:
        sel = sel._replace(alpha=np.asarray(payload["selector"]["alpha"]),
                           beta=np.asarray(payload["selector"]["beta"]))
    meta = payload["meta"]
    fractions = tuple(float(f) for f in np.asarray(meta["fractions"]))
    restored = dataclasses.replace(
        exp, arms=tuple(arms), snapshots=tuple(snaps), selector=sel,
        fractions=fractions,
        enabled=tuple(bool(e) for e in np.asarray(meta["enabled"])),
        salt=int(meta["salt"]), steps=int(meta["steps"]),
        epoch=int(meta["epoch"]), counts=np.asarray(meta["counts"]),
        stages=tuple(int(s) for s in np.asarray(meta["stages"])),
        stage_since=tuple(int(s) for s in np.asarray(meta["stage_since"])),
        totals={k: np.asarray(v) for k, v in meta["totals"].items()},
        guards=(guardrails_mod.GuardrailState(),) * exp.n_arms,
        shares=((int(meta["steps"]), fractions),))
    return restored, step


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


class ExperimentReport(NamedTuple):
    rounds: int
    names: tuple
    enabled: tuple
    fractions: tuple            # final traffic split
    reward: tuple               # per-arm realized reward (issue-time)
    expected: tuple
    best: tuple
    rand_reward: tuple
    regret: tuple               # per-arm best - expected
    interactions: tuple
    delivered: tuple
    matched_ratio: tuple        # per-arm pending matched / issued
    shares: tuple               # ((step, fractions), ...) over time
    leader: str                 # highest reward-rate enabled arm
    runner_up: str
    z_leading_pair: float       # sequential two-proportion z, leader pair
    tx_per_s: float
    events: tuple


def _z_stat(p1, n1, p2, n2) -> float:
    if min(n1, n2) <= 0:
        return 0.0
    pool = (p1 * n1 + p2 * n2) / (n1 + n2)
    var = pool * (1 - pool) * (1 / n1 + 1 / n2)
    if var <= 0:
        return 0.0
    return float((p1 - p2) / np.sqrt(var))


def report(exp: Experiment, *, rounds: int = 0,
           tx_per_s: float = 0.0) -> ExperimentReport:
    """The experiment so far; the z-statistic compares the reward rates
    of the two leading enabled arms (a sequential look: wait for |z| of
    2-3 before trusting the winner)."""
    t = exp.totals
    A = exp.n_arms
    n = np.maximum(t["interactions"], 1)
    rate = np.where(t["interactions"] > 0, t["reward"] / n, -np.inf)
    rate = np.where(np.asarray(exp.enabled, bool), rate, -np.inf)
    order = np.argsort(-rate)
    lead, run = int(order[0]), int(order[1]) if A > 1 else int(order[0])
    z = 0.0
    if A > 1 and np.isfinite(rate[run]):
        z = _z_stat(rate[lead], t["interactions"][lead],
                    rate[run], t["interactions"][run])
    matched = []
    for s in exp.arms:
        st = session_mod.pending_stats(s)
        matched.append(st["matched"] / max(1.0, st["issued"])
                       if st else 0.0)

    def tup(k):
        return tuple(float(x) for x in t[k])

    return ExperimentReport(
        rounds=rounds or exp.steps, names=exp.names, enabled=exp.enabled,
        fractions=exp.fractions, reward=tup("reward"),
        expected=tup("expected"), best=tup("best"),
        rand_reward=tup("rand"),
        regret=tuple(float(b - e) for b, e in zip(t["best"],
                                                  t["expected"])),
        interactions=tuple(int(x) for x in t["interactions"]),
        delivered=tuple(int(x) for x in t["delivered"]),
        matched_ratio=tuple(matched), shares=exp.shares,
        leader=exp.names[lead], runner_up=exp.names[run],
        z_leading_pair=z, tx_per_s=tx_per_s, events=exp.events)


# ---------------------------------------------------------------------------
# the seeded A/B harness (the fault harness's traffic and faults)
# ---------------------------------------------------------------------------


def run_experiment(exp: Experiment, theta, rounds: int, *,
                   spec: faults_mod.FaultSpec | None = None,
                   batch: int = 32, key: int = 0, drain: bool = True,
                   stream: faults_mod.TrafficStream | None = None):
    """Drive the experiment over ``faults.TrafficStream(key, ...)`` (the
    traffic of a ``run_faulted`` clean control with the same ``key``)
    with the fault harness's delivery faults on the merged decision
    stream, so every arm meets the same environment.  ``theta`` is the
    ``[n_users, d]`` preference matrix, or ``theta(counts)`` for a
    drifting one (counts = per-user lifetime interactions).  Every arm
    must be buffer-enabled.  Returns ``(exp, ExperimentReport)``."""
    spec = faults_mod.FaultSpec() if spec is None else spec
    cfg = exp.arms[0].policy.cfg
    dev = guardrails_mod.session_device(exp.arms[0])
    if stream is None:
        stream = faults_mod.TrafficStream(key, batch, cfg.n_users,
                                          K=cfg.hyper.n_candidates, d=cfg.d,
                                          device=dev)
    theta_fn = theta if callable(theta) else (lambda counts: theta)
    A = exp.n_arms
    h = faults_mod.Harness(spec, batch, dev)

    def fold(ids, rs):
        nonlocal exp
        exp = observe_delayed(exp, ids, rs)

    t0 = guardrails_mod.clock(exp.arms[0])
    for i in range(rounds):
        users, ctx, uniforms = stream.slate_batch(i)
        exp, choices, gids = recommend(exp, users, ctx)
        h.n_tx += 1
        th = theta_fn(exp.counts)
        realized, expected, best, rand = bandit_env.step_rewards(
            uniforms, th[users.long()], ctx, choices)
        gids_np = gids.cpu().numpy()
        valid = gids_np >= 0
        r_np = realized.cpu().numpy().astype(np.float32)
        r_del, lost, lag, dup = h.draw_faults(i, r_np)
        arms_np = np.where(valid, gids_np % A, -1)
        exp = record_feedback(exp, users.cpu().numpy(), arms_np, r_np,
                              expected=expected.cpu().numpy(),
                              best=best.cpu().numpy(),
                              rand=rand.cpu().numpy(),
                              learner_rewards=r_del)
        h.enqueue(i, gids_np, valid, r_del, lost, lag, dup)
        h.round_end(i, fold)
    if drain:
        h.drain(fold)
    dt = guardrails_mod.clock(exp.arms[0]) - t0
    return exp, report(exp, rounds=rounds, tx_per_s=h.n_tx / max(dt, 1e-9))
