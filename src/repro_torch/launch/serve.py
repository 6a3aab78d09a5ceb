"""Serving CLI: ``python -m repro_torch.launch.serve --arch <id>``
(``repro.launch.serve``).

Runs batched online recommendation with a policy-pluggable
``OnlineBandit`` session over a SASRec model's item embeddings at a
reduced scale: each request batch draws candidates from the catalog,
embeds them as unit-norm bandit contexts and serves them through one
session transaction.  Reports reward against the random policy and
throughput.  ``--policy`` takes distclub, club, linucb or dccb; LM
archs (KV-cache decode) are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import configs, resolve_device


def serve_recsys(spec, args, device=None) -> float:
    """Serve ``args.steps`` batches of ``args.batch`` of ``args.users``
    users; prints and returns reward/random.  Runs on ``device`` (default
    cuda; raises without a card unless ``device="cpu"``).  The Bernoulli
    draws are a tape of uniforms from a seeded generator, handed to
    ``core.env.step_rewards`` where ``repro`` passes a PRNG key.

    The world (model weights, users, traffic, draws) is drawn on the host
    from fixed seeds and moved to the device, so a run serves the same
    requests on either device and the card's result can be held to the
    CPU's."""
    from .. import serve
    from ..core import env as bandit_env
    from ..core.types import BanditHyper
    from ..models.recsys import seqrec

    dev = resolve_device(device)
    host = torch.device("cpu")
    d, K = 32, 20
    cfg = seqrec.SeqRecConfig(n_items=4096, embed_dim=d, n_blocks=2,
                              n_heads=2, seq_len=16)
    model = seqrec.SeqRec(cfg, seed=0, device=host).to(dev)
    world, _ = bandit_env.make_synthetic_env(
        1, n_users=args.users, d=d, n_clusters=8, n_candidates=K,
        device=host)
    hyper = BanditHyper(alpha=0.05, gamma=2.4, n_candidates=K)
    session = serve.OnlineBandit.create(
        args.users, d, hyper, policy=args.policy,
        refresh_every=args.users * 4, device=dev)
    theta = world.theta.to(dev)

    g = torch.Generator().manual_seed(2)
    users = torch.stack([torch.randperm(args.users, generator=g)[:args.batch]
                         for _ in range(args.steps)]).int().to(dev)
    cand = torch.randint(0, cfg.n_items, (args.steps, args.batch, K),
                         generator=g).to(dev)
    uniforms = torch.rand(args.steps, args.batch, generator=g).to(dev)

    def reward_fn(key, user_ids, contexts, choice):
        return bandit_env.step_rewards(uniforms[key],
                                       theta[user_ids.long()], contexts,
                                       choice)

    tot_r = tot_rand = 0.0
    t0 = time.perf_counter()
    for step in range(args.steps):
        ctx = serve.embed_candidates(model.item_embed, cand[step])
        session, _, m = serve.step(session, step, users[step], ctx,
                                   reward_fn)
        tot_r += float(m.reward)
        tot_rand += float(m.rand_reward)
    dt = time.perf_counter() - t0
    n = args.steps * args.batch
    print(f"[{args.policy}] {n} requests in {dt:.1f}s = {n / dt:.0f} req/s; "
          f"reward/random = {tot_r / tot_rand:.3f}")
    return tot_r / tot_rand


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="sasrec")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--users", type=int, default=256)
    ap.add_argument("--policy", default="distclub",
                    choices=["distclub", "dccb", "club", "linucb"],
                    help="serving policy (recsys archs)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.arch not in configs.REGISTRY:
        raise NotImplementedError(
            f"serving {args.arch!r} is not ported; the ported archs are "
            f"{sorted(configs.REGISTRY)}")
    serve_recsys(configs.get(args.arch), args)


if __name__ == "__main__":
    main()
