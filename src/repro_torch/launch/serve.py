"""Serving CLI: ``python -m repro_torch.launch.serve --arch <id>``
(``repro.launch.serve``).

Runs batched online recommendation with a policy-pluggable
``OnlineBandit`` session over a SASRec model's item embeddings at a
reduced scale: each request batch draws candidates from the catalog,
embeds them as unit-norm bandit contexts and serves them through one
session transaction.  Reports reward against the random policy and
throughput.  ``--policy`` takes distclub, club, linucb or dccb.  For the
LM archs (``--arch qwen3-4b``, the MoE ``deepseek-moe-16b``) it runs a
reduced config: a prompt pass, then greedy decode steps against a KV
cache.
"""
from __future__ import annotations

import argparse
import dataclasses
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


LM_PROMPT = 16
LM_CACHE = 128


def reduced_lm(spec):
    """``repro``'s CLI config for an LM arch: 2 blocks, d_model 128, 4
    heads of 32, d_ff 256, vocab 2048, f32, attention chunk 128."""
    c = spec.cfg
    return dataclasses.replace(
        c, n_layers=2 * c.block_layers, d_model=128, n_heads=4,
        n_kv_heads=min(4, c.n_kv_heads), d_head=32, d_ff=256, vocab=2048,
        n_experts=min(8, c.n_experts), d_ff_expert=128 if c.is_moe else 0,
        top_k=min(2, c.top_k), dtype=torch.float32, attn_chunk=128)


def lm_world(cfg, batch: int):
    """The CLI's weights (seed 0) and prompt [batch, 16] (seed 1), drawn
    on the host."""
    from ..models import transformer
    model = transformer.LM(cfg, seed=0, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (batch, LM_PROMPT),
                           generator=torch.Generator().manual_seed(1))
    return model, prompt


def serve_lm(spec, args, device=None):
    """Prefill ``args.batch`` prompts of 16 tokens, copy the cache into a
    128-slot one, then ``args.steps`` greedy decode steps, the first fed
    the prompt's last token (as ``repro``'s CLI does); returns the decoded
    tokens [batch, steps] on the host.  Runs on ``device`` (default cuda;
    raises without a card unless ``device="cpu"``).  Weights and prompt
    are drawn on the host and moved, so the card decodes the CPU's
    requests."""
    from ..models import transformer as tr
    dev = resolve_device(device)
    if LM_PROMPT + args.steps > LM_CACHE:
        raise ValueError(f"{args.steps} steps overrun the {LM_CACHE}-slot "
                         "cache")
    cfg = reduced_lm(spec)
    model, prompt = lm_world(cfg, args.batch)
    model, prompt = model.to(dev), prompt.to(dev)
    _, (k0, v0) = tr.lm_prefill(model, prompt)
    kc, vc = tr.init_cache(cfg, args.batch, LM_CACHE, device=dev)
    kc[..., :LM_PROMPT, :] = k0
    vc[..., :LM_PROMPT, :] = v0

    tok = prompt[:, -1]
    out = []
    t0 = time.perf_counter()
    for pos in range(LM_PROMPT, LM_PROMPT + args.steps):
        logits, _ = tr.lm_decode_step(model, tok, (kc, vc), pos)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    tokens = torch.stack(out, dim=1).cpu()
    dt = time.perf_counter() - t0
    print(f"decoded {args.steps} tokens x {args.batch} seqs in {dt:.1f}s = "
          f"{args.steps * args.batch / dt:.0f} tok/s (reduced config)")
    return tokens


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
    spec = configs.get(args.arch)
    if spec.family == "lm":
        serve_lm(spec, args)
    else:
        serve_recsys(spec, args)


if __name__ == "__main__":
    main()
