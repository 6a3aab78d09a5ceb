"""Fault-injection CLI: the feedback loop under hostile delivery
(``repro.launch.faultrun``).

    PYTHONPATH=src python -m repro_torch.launch.faultrun --policy distclub \\
        --rounds 60 --delay 0.3 --loss 0.1 --dup 0.05

Runs the same seeded traffic twice, a clean control (no faults) and the
faulted run, through a buffer-enabled ``OnlineBandit`` session and
prints the degradation the faults cause.  ``--guard`` wraps the session
in ``serve.guardrails.Guarded`` (CTR floor), so a ``--flip``-corrupted
run ends in a rollback; its events are printed.

``--scenario churn`` serves against a live double-buffered catalog and
adds churn faults to the delivery faults: stage/publish cycles
(``--churn-every/-add/-retire``), swap stalls (``--swap-stall``), torn
swaps (``--torn``), a hot-region flash crowd (``--flash-crowd-at/-size``)
and a mass retirement (``--mass-retire-at``).  The control run is the
same traffic without churn; the report adds the quarantined (``stale``)
feedback and the published epochs.  ``--guard`` then tracks the catalog
too, so a ``--churn-ceiling`` breach rolls back (state, catalog, epoch).

Runs on ``--device`` (default cuda; raises without a card unless
``--device cpu``).  Checkpoints of ``--guard`` go to a temporary
directory that is removed at exit.
"""
from __future__ import annotations

import argparse
import tempfile

from .. import resolve_device
from ..core import env as bandit_env
from ..core.types import BanditHyper
from ..serve import OnlineBandit, faults, guardrails, make_catalog
from ..train.checkpoint import CheckpointManager


def make_session(args, device):
    hyper = BanditHyper(alpha=0.05, gamma=2.4, n_candidates=args.k)
    return OnlineBandit.create(
        args.users, args.d, hyper, policy=args.policy,
        refresh_every=args.users * 4,
        pending_capacity=args.capacity, pending_ttl=args.ttl, device=device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="feedback",
                    choices=["feedback", "churn"],
                    help="feedback: slate serving under delivery faults; "
                         "churn: catalog serving under live churn + "
                         "delivery faults")
    ap.add_argument("--policy", default="distclub",
                    choices=["distclub", "dccb", "club", "linucb"])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--users", type=int, default=256)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--ttl", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--delay", type=float, default=0.0,
                    help="P(feedback delayed 1..max-delay rounds)")
    ap.add_argument("--max-delay", type=int, default=4)
    ap.add_argument("--loss", type=float, default=0.0)
    ap.add_argument("--dup", type=float, default=0.0)
    ap.add_argument("--flip", type=float, default=0.0,
                    help="P(delivered reward sign-flipped)")
    ap.add_argument("--flip-after", type=int, default=0)
    ap.add_argument("--stall-every", type=int, default=0)
    ap.add_argument("--stall-rounds", type=int, default=2)
    ap.add_argument("--guard", action="store_true",
                    help="wrap in guardrails (CTR floor + rollback; with "
                         "--scenario churn the catalog rolls back with "
                         "the state)")
    ap.add_argument("--ctr-floor", type=float, default=0.25)
    # -- churn scenario knobs --
    ap.add_argument("--items", type=int, default=512,
                    help="[churn] initial catalog items")
    ap.add_argument("--item-capacity", type=int, default=768,
                    help="[churn] catalog slot capacity")
    ap.add_argument("--k-short", type=int, default=32)
    ap.add_argument("--churn-every", type=int, default=4,
                    help="[churn] stage+publish cadence in rounds")
    ap.add_argument("--churn-add", type=int, default=16)
    ap.add_argument("--churn-retire", type=int, default=16)
    ap.add_argument("--swap-stall", type=int, default=0,
                    help="[churn] publishes land this many rounds late")
    ap.add_argument("--torn", type=float, default=0.0,
                    help="[churn] P(a publish is torn/partial)")
    ap.add_argument("--flash-crowd-at", type=int, default=-1)
    ap.add_argument("--flash-crowd-size", type=int, default=0)
    ap.add_argument("--mass-retire-at", type=int, default=-1)
    ap.add_argument("--churn-ceiling", type=float, default=0.5,
                    help="[churn, --guard] capacity fraction per publish")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args, ckpt_dir: str):
    """``(clean report, faulted report)`` of ``args``' scenario."""
    dev = resolve_device(args.device)
    spec = faults.FaultSpec(
        seed=args.seed, p_delay=args.delay, max_delay=args.max_delay,
        p_loss=args.loss, p_dup=args.dup, p_flip=args.flip,
        flip_after=args.flip_after, stall_every=args.stall_every,
        stall_rounds=args.stall_rounds,
        churn_every=args.churn_every if args.scenario == "churn" else 0,
        churn_add=args.churn_add, churn_retire=args.churn_retire,
        swap_stall_rounds=args.swap_stall, p_torn=args.torn,
        flash_crowd_at=args.flash_crowd_at,
        flash_crowd_size=args.flash_crowd_size,
        mass_retire_at=args.mass_retire_at)
    session = make_session(args, dev)
    kw = dict(batch=args.batch, key=args.seed)
    if args.scenario == "churn":
        env, _ = bandit_env.make_catalog_env(
            1, n_users=args.users, d=args.d,
            n_clusters=max(2, args.users // 16), n_items=args.items,
            n_candidates=args.k, device=dev)
        cat = make_catalog(bandit_env.catalog_embeddings(env),
                           capacity=args.item_capacity)
        _, clean = faults.run_faulted_catalog(
            make_session(args, dev), env, args.rounds,
            faults.FaultSpec(seed=args.seed), catalog=cat,
            k_short=args.k_short, **kw)
        if args.guard:
            cfg = guardrails.GuardrailConfig(
                ctr_floor=args.ctr_floor, churn_ceiling=args.churn_ceiling,
                warmup=2 * args.batch, ema=0.7, snapshot_every=8,
                cooldown=2)
            session = guardrails.Guarded.create(
                session, CheckpointManager(ckpt_dir, keep=4), cfg,
                catalog=cat)
            _, rep = faults.run_faulted_catalog(
                session, env, args.rounds, spec, k_short=args.k_short, **kw)
        else:
            _, rep = faults.run_faulted_catalog(
                session, env, args.rounds, spec, catalog=cat,
                k_short=args.k_short, **kw)
        return clean, rep
    env, _ = bandit_env.make_synthetic_env(
        1, n_users=args.users, d=args.d,
        n_clusters=max(2, args.users // 16), n_candidates=args.k,
        device=dev)
    _, clean = faults.run_faulted(make_session(args, dev), env.theta,
                                  args.rounds, faults.FaultSpec(), **kw)
    if args.guard:
        cfg = guardrails.GuardrailConfig(
            ctr_floor=args.ctr_floor, warmup=2 * args.batch, ema=0.7,
            snapshot_every=8, cooldown=2)
        session = guardrails.Guarded.create(
            session, CheckpointManager(ckpt_dir, keep=4), cfg)
    _, rep = faults.run_faulted(session, env.theta, args.rounds, spec, **kw)
    return clean, rep


def print_report(args, clean, rep):
    n = max(1, rep.interactions)
    print(f"[{args.policy}/{args.scenario}] {rep.rounds} rounds x "
          f"{args.batch} ({rep.interactions} decisions, {rep.delivered} "
          f"deliveries, {rep.tx_per_s:.0f} tx/s)")
    print(f"  clean  : reward {clean.reward:8.1f}  regret {clean.regret:8.1f}"
          f"  ({clean.reward / max(1, clean.interactions):.3f}/decision)")
    print(f"  faulted: reward {rep.reward:8.1f}  regret {rep.regret:8.1f}"
          f"  ({rep.reward / n:.3f}/decision)")
    print(f"  regret degradation: "
          f"{rep.regret / max(clean.regret, 1e-9):.2f}x clean")
    print(f"  pending: {rep.pending}")
    if args.scenario == "churn":
        print(f"  churn: {rep.publishes} epochs published, "
              f"+{rep.items_added}/-{rep.items_retired} items, "
              f"{rep.pending['stale']} feedback quarantined, "
              f"tx ratio {rep.tx_per_s / max(clean.tx_per_s, 1e-9):.2f}x "
              "clean")
    for e in rep.events:
        print(f"  guard event: {e}")


def main(argv=None):
    args = parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="faultrun_ckpt_") as ckpt_dir:
        clean, rep = run(args, ckpt_dir)
    print_report(args, clean, rep)
    return clean, rep


if __name__ == "__main__":
    main()
