"""A 3-arm online experiment on the PyTorch port with one arm breaching
and being disabled (``ab_experiment.py``'s story).

Three policies (distclub / dccb / linucb) serve ONE request stream
behind sticky uid-hash traffic splitting, a Thompson-sampling selector
shifts traffic toward the winner at epoch boundaries, and per-arm
guardrails watch every arm.  From round 20 the linucb arm's feedback
pipeline sign-flips its rewards: its CTR monitor trips, the arm is
disabled (state rolled back to its last healthy snapshot, its traffic
re-routed to the survivors, who keep every user they had), and the
experiment keeps serving.

    PYTHONPATH=src python examples/ab_experiment_torch.py               # card
    PYTHONPATH=src python examples/ab_experiment_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device, serve
from repro_torch.core import env as bandit_env
from repro_torch.core.types import BanditHyper
from repro_torch.serve import experiments, faults, guardrails

N_USERS, D, K, BATCH = 128, 8, 10, 32
ROUNDS, POISON_AFTER = 60, 20


def make_arm(policy, device):
    hyper = BanditHyper(alpha=0.05, gamma=2.4, n_candidates=K)
    return serve.OnlineBandit.create(
        N_USERS, D, hyper, policy=policy, refresh_every=N_USERS * 4,
        pending_capacity=512, pending_ttl=16, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. a planted world and three arm sessions, one per policy, each with
    #    its own state and pending ring
    env, _ = bandit_env.make_synthetic_env(0, N_USERS, D, n_clusters=8,
                                           n_candidates=K, device=dev)

    # 2. the experiment: sticky split + TS selector + per-arm guardrails
    exp = experiments.create(
        [make_arm(p, dev) for p in ("distclub", "dccb", "linucb")],
        names=("distclub", "dccb", "linucb"), salt=7,
        selector=experiments.make_selector(3, epoch_rounds=15, floor=0.05),
        guard_cfg=guardrails.GuardrailConfig(ctr_floor=0.25,
                                             warmup=2 * BATCH, ema=0.7,
                                             cooldown=2),
        snapshot_every=4)

    # 3. one seeded request stream for all arms, linucb's rewards
    #    sign-flipped after round POISON_AFTER: the targeted poisoning
    stream = faults.TrafficStream(3, BATCH, N_USERS, K=K, d=D, device=dev)
    A = exp.n_arms
    for i in range(ROUNDS):
        users, ctx, uniforms = stream.slate_batch(i)
        exp, choices, ids = experiments.recommend(exp, users, ctx)
        realized, expected, best, rand = bandit_env.step_rewards(
            uniforms, env.theta[users.long()], ctx, choices)
        arm_of = torch.where(ids >= 0, ids % A, -1)
        delivered = realized
        if i >= POISON_AFTER:                   # poison ONLY linucb's arm
            delivered = torch.where(arm_of == 2, -realized, realized)
        exp = experiments.record_feedback(
            exp, users.cpu().numpy(), arm_of.cpu().numpy(),
            realized.cpu().numpy(), expected=expected.cpu().numpy(),
            best=best.cpu().numpy(), rand=rand.cpu().numpy(),
            learner_rewards=delivered.cpu().numpy())
        exp = experiments.observe_delayed(exp, ids, delivered)

    rep = experiments.report(exp, rounds=ROUNDS)

    # 4. what happened
    print(f"{ROUNDS} rounds x {BATCH} requests, poison from round "
          f"{POISON_AFTER} on the linucb arm\n")
    for i, name in enumerate(rep.names):
        n = max(1, rep.interactions[i])
        tag = "" if rep.enabled[i] else "   <- DISABLED"
        print(f"  {name:9s} reward/decision {rep.reward[i] / n:.3f}  "
              f"decisions {rep.interactions[i]:5d}  "
              f"final share {rep.fractions[i]:.2f}{tag}")
    print(f"\n  leader: {rep.leader} (z = {rep.z_leading_pair:+.2f} vs "
          f"{rep.runner_up})")
    print("  traffic shares over time:")
    for step, fr in rep.shares:
        print(f"    round {step:3d}: "
              + "  ".join(f"{nm}={f:.2f}" for nm, f in zip(rep.names, fr)))
    print("  guardrail events:")
    for e in rep.events:
        print(f"    {e}")

    assert not exp.enabled[2], "the poisoned arm should have been disabled"
    # survivors kept every user they had before the disable (sticky
    # fallback)
    arm_now = experiments.assign_arms(
        exp, torch.arange(N_USERS, device=dev)).cpu().numpy()
    assert not (arm_now == 2).any()
    assert np.isfinite(rep.z_leading_pair)
    print("\nthe poisoned arm was disabled, its state rolled back, and its "
          "traffic re-routed to the surviving arms: experiment still live.")
    return exp, rep


if __name__ == "__main__":
    main()
