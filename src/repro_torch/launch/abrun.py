"""A/B experiment CLI: policies head to head on live routed traffic
(``repro.launch.abrun``).

    PYTHONPATH=src python -m repro_torch.launch.abrun --rounds 120 \\
        --arms distclub dccb linucb --selector

Runs an N-arm ``serve.experiments`` experiment (sticky uid-hash traffic
splitting over one seeded request stream, ``faults.TrafficStream``) and
prints the ``ExperimentReport``: per-arm reward, regret and matched
ratios, the traffic shares over time, and the sequential z-statistic of
the leading pair.

``--selector`` turns on the Thompson-sampling selector (``--buckets``
adds the cold_start/regular/power_user context split), re-weighting the
fractions at epoch boundaries with a per-arm floor.  ``--guard`` gives
every arm its own guardrail monitors, so a breaching arm is disabled and
its traffic re-routed.  ``--faults`` adds the seeded delivery faults
(delay/loss/dup/sign-flip), the same for every arm.

``--env``: ``synthetic`` (fixed planted clusters), ``drift`` (preferences
rotate as users accumulate interactions) or ``catalog`` (each arm's
``step_catalog`` against a persistent item catalog; synchronous, no
delivery faults).  Runs on ``--device`` (default cuda; raises without a
card unless ``--device cpu``).
"""
from __future__ import annotations

import argparse
import functools

import torch

from .. import resolve_device
from ..core import env as bandit_env
from ..core.types import BanditHyper
from ..serve import (OnlineBandit, experiments, faults, guardrails,
                     make_catalog)


def make_arm(policy: str, args, device, alpha: float = 0.05):
    hyper = BanditHyper(alpha=alpha, gamma=2.4, n_candidates=args.k)
    return OnlineBandit.create(
        args.users, args.d, hyper, policy=policy,
        refresh_every=args.users * 4,
        pending_capacity=args.capacity, pending_ttl=args.ttl, device=device)


def print_report(rep, names):
    print(f"[experiment] {rep.rounds} rounds, final split "
          + " ".join(f"{n}={f:.2f}{'' if e else ' (DISABLED)'}"
                     for n, f, e in zip(names, rep.fractions, rep.enabled)))
    for i, n in enumerate(names):
        den = max(1, rep.interactions[i])
        print(f"  {n:10s} reward {rep.reward[i]:8.1f} "
              f"({rep.reward[i] / den:.3f}/decision)  "
              f"regret {rep.regret[i]:8.1f}  "
              f"decisions {rep.interactions[i]:6d}  "
              f"matched {rep.matched_ratio[i]:.2f}")
    print(f"  leader: {rep.leader} vs {rep.runner_up}, "
          f"z = {rep.z_leading_pair:+.2f}  ({rep.tx_per_s:.0f} tx/s)")
    if len(rep.shares) > 1:
        print("  shares over time:")
        for step, fr in rep.shares:
            print(f"    step {step:5d}: "
                  + " ".join(f"{f:.2f}" for f in fr))
    for e in rep.events:
        print(f"  event: {e}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arms", nargs="+",
                    default=["distclub", "dccb", "linucb"],
                    help="one policy name per arm "
                         "(distclub/dccb/club/linucb; repeats allowed)")
    ap.add_argument("--env", default="synthetic",
                    choices=["synthetic", "drift", "catalog"])
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--users", type=int, default=256)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--ttl", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--salt", type=int, default=0,
                    help="sticky-assignment hash salt")
    ap.add_argument("--selector", action="store_true",
                    help="Thompson-sampling meta-selector over the arms")
    ap.add_argument("--epoch-rounds", type=int, default=25,
                    help="[selector] rounds between traffic re-weights")
    ap.add_argument("--floor", type=float, default=0.05,
                    help="[selector] per-arm minimum traffic fraction")
    ap.add_argument("--buckets", action="store_true",
                    help="[selector] cold_start/regular/power_user "
                         "context buckets")
    ap.add_argument("--guard", action="store_true",
                    help="per-arm guardrails: a breaching arm is "
                         "disabled and its traffic re-routed")
    ap.add_argument("--ctr-floor", type=float, default=0.25)
    # -- delivery faults (synthetic/drift envs) --
    ap.add_argument("--faults", action="store_true",
                    help="inject the seeded delivery faults below")
    ap.add_argument("--delay", type=float, default=0.3)
    ap.add_argument("--max-delay", type=int, default=4)
    ap.add_argument("--loss", type=float, default=0.05)
    ap.add_argument("--dup", type=float, default=0.05)
    ap.add_argument("--flip", type=float, default=0.0)
    ap.add_argument("--flip-after", type=int, default=0)
    # -- catalog env knobs --
    ap.add_argument("--items", type=int, default=512)
    ap.add_argument("--k-short", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _catalog_rewards(theta, stream, key, uids, contexts, choice):
    """``key`` is the round: its reward uniforms come from ``stream``."""
    return bandit_env.step_rewards(stream.catalog_batch(key)[1],
                                   theta[uids.clamp_min(0).long()],
                                   contexts, choice)


def run(args):
    """``(experiment, ExperimentReport)`` of ``args``' run."""
    dev = resolve_device(args.device)
    A = len(args.arms)
    sessions = [make_arm(p, args, dev) for p in args.arms]
    names = []
    for i, p in enumerate(args.arms):
        names.append(p if p not in names else f"{p}#{i}")
    selector = None
    if args.selector:
        selector = experiments.make_selector(
            A, floor=args.floor, epoch_rounds=args.epoch_rounds,
            bucket_edges=(3, 21) if args.buckets else ())
    guard_cfg = None
    if args.guard:
        guard_cfg = guardrails.GuardrailConfig(
            ctr_floor=args.ctr_floor, warmup=2 * args.batch, ema=0.7,
            cooldown=2)
    exp = experiments.create(sessions, names=names, salt=args.salt,
                             selector=selector, guard_cfg=guard_cfg)
    n_clusters = max(2, args.users // 16)
    if args.env == "catalog":
        env, _ = bandit_env.make_catalog_env(
            1, n_users=args.users, d=args.d, n_clusters=n_clusters,
            n_items=args.items, n_candidates=args.k, device=dev)
        cat = make_catalog(bandit_env.catalog_embeddings(env))
        stream = faults.TrafficStream(args.seed, args.batch, args.users,
                                      device=dev)
        rfn = functools.partial(_catalog_rewards, env.theta, stream)
        for i in range(args.rounds):
            users, _ = stream.catalog_batch(i)
            exp, _, _ = experiments.step_catalog(exp, i, users, cat, rfn,
                                                 k_short=args.k_short)
        return exp, experiments.report(exp, rounds=args.rounds)
    spec = faults.FaultSpec(
        seed=args.seed, p_delay=args.delay, max_delay=args.max_delay,
        p_loss=args.loss, p_dup=args.dup, p_flip=args.flip,
        flip_after=args.flip_after) if args.faults \
        else faults.FaultSpec(seed=args.seed)
    if args.env == "drift":
        denv, _ = bandit_env.make_drift_env(
            1, n_users=args.users, d=args.d, n_clusters=n_clusters,
            n_candidates=args.k, drift_period=max(4, args.rounds // 4),
            device=dev)

        def theta(counts):
            return bandit_env.drift_theta(
                denv, torch.as_tensor(counts, dtype=torch.int32,
                                      device=dev))
    else:
        env, _ = bandit_env.make_synthetic_env(
            1, n_users=args.users, d=args.d, n_clusters=n_clusters,
            n_candidates=args.k, device=dev)
        theta = env.theta
    return experiments.run_experiment(exp, theta, args.rounds, spec=spec,
                                      batch=args.batch, key=args.seed)


def main(argv=None):
    exp, rep = run(parse_args(argv))
    print_report(rep, exp.names)
    return exp, rep


if __name__ == "__main__":
    main()
