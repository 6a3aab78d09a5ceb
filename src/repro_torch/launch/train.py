"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[options]`` (``repro.launch.train``).

Runs real steps with checkpoint and resume: kill it mid-run and the same
command continues from the last checkpoint (``train.checkpoint``, the
newest two kept, under ``--ckpt-dir``, by default
``repro_torch_train_<arch>`` in the temporary directory).  Runs on
``--device`` (default cuda; raises without a card unless
``--device cpu``).

  * LMs (``--arch qwen3-4b``): AdamW at lr 3e-4 on ``repro``'s learnable
    synthetic stream, tokens drawn from a Zipf unigram (logits
    ``-1.5 log(1..V)``), so the loss falls from log V toward the
    unigram's entropy.  Step ``i`` draws from a generator seeded by
    ``(seed, i)`` alone, so a resumed run draws what an unbroken one
    draws.  The draw (``zipf_tokens``) is apart from the step
    (``lm_step``), which tests drive with ``repro``'s tokens.
  * Recsys (``dcn-v2``, ``sasrec``, ``bert4rec``, ``mind``): Adagrad on
    ``repro``'s synthetic batches, drawn by ``recsys_batch``.
  * ``distclub-paper``: ``core.distclub.run`` for ``--steps`` epochs.
  * ``gat-cora`` exits, as ``repro``'s does: its step is
    ``launch.steps.gnn_train_step``, driven by tests and benchmarks.

Examples:
    python -m repro_torch.launch.train --arch qwen3-4b --steps 3
    python -m repro_torch.launch.train --arch qwen3-4b --reduce --steps 50
    python -m repro_torch.launch.train --arch deepseek-moe-16b --reduce \\
        --steps 20
    python -m repro_torch.launch.train --arch sasrec --reduce --steps 100
    python -m repro_torch.launch.train --arch distclub-paper --reduce \\
        --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import tempfile
import time
from pathlib import Path

import torch

from .. import configs, resolve_device
from ..configs.base import ArchSpec
from ..train import optimizer
from ..train.checkpoint import CheckpointManager
from ..tree import tree_leaves, tree_map

def _reduced_cfg(spec):
    if spec.family == "lm":
        return dataclasses.replace(
            spec.cfg, n_layers=2 * spec.cfg.block_layers, d_model=128,
            n_heads=4, n_kv_heads=min(4, spec.cfg.n_kv_heads), d_head=32,
            d_ff=256, vocab=2048,
            n_experts=min(8, spec.cfg.n_experts),
            d_ff_expert=128 if spec.cfg.is_moe else 0,
            top_k=min(2, spec.cfg.top_k), dtype=torch.float32,
            attn_chunk=128, microbatches=1)
    if spec.family == "recsys":
        # DCN-v2's tables are cut by their per-field vocabulary, which it
        # has where the sequence models have n_items
        field = ("n_items" if hasattr(spec.cfg, "n_items")
                 else "vocab_per_field")
        return dataclasses.replace(spec.cfg, **{field: 4096})
    return spec.cfg


def _step_generator(seed: int, step: int) -> torch.Generator:
    """A host generator seeded by ``(seed, step)`` alone."""
    return torch.Generator().manual_seed((seed << 32) + step)


def zipf_tokens(vocab: int, shape, seed: int, step: int, device):
    """Step ``step``'s tokens: ``shape`` draws of the Zipf unigram with
    logits ``-1.5 log(1..vocab)``, on the host, moved to ``device``."""
    logits = -1.5 * torch.log(torch.arange(1, vocab + 1,
                                           dtype=torch.float32))
    tok = torch.multinomial(torch.softmax(logits, dim=0), math.prod(shape),
                            replacement=True,
                            generator=_step_generator(seed, step))
    return tok.reshape(shape).to(device)


def value_and_grad(loss_fn, params, *args):
    """``(loss, grads)``: the loss of ``loss_fn(*args)`` and its gradient
    for every leaf of ``params`` as a tree of the same structure (a leaf
    the loss does not reach raises)."""
    loss = loss_fn(*args)
    grads = iter(torch.autograd.grad(loss, tree_leaves(params)))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def lm_step(model, params, opt, tokens, lr=3e-4):
    """One AdamW step of ``lm_loss`` on tokens [B, S + 1] (inputs
    ``tokens[:, :-1]``, labels ``tokens[:, 1:]``); returns ``(params,
    opt, loss)``, the parameters updated in place."""
    from ..models import transformer as tr

    loss, grads = value_and_grad(tr.lm_loss, params, model, tokens[:, :-1],
                                 tokens[:, 1:])
    params, opt = optimizer.adamw_update(grads, opt, params, lr=lr)
    return params, opt, loss


def train_lm(spec, args):
    from ..models import transformer as tr

    dev = resolve_device(args.device)
    cfg = _reduced_cfg(spec) if args.reduce else spec.cfg
    model = tr.LM(cfg, seed=args.seed, device=dev).requires_grad_(True)
    params = model.tree()
    opt = optimizer.adamw_init(params)
    mgr = CheckpointManager(
        args.ckpt_dir or Path(tempfile.gettempdir())
        / f"repro_torch_train_{spec.arch_id}", keep=2)

    restored, start = mgr.restore_latest((params, opt))
    if restored is not None:
        saved, opt = restored
        with torch.no_grad():
            tree_map(lambda p, s: p.copy_(s), params, saved)
        print(f"resumed from checkpoint step {start}")
    else:
        start = 0

    B, S = args.batch, args.seq
    for i in range(start, args.steps):
        tokens = zipf_tokens(cfg.vocab, (B, S + 1), args.seed, i, dev)
        t0 = time.perf_counter()
        params, opt, loss = lm_step(model, params, opt, tokens)
        loss = float(loss)
        if i % args.log_every == 0:
            print(f"step {i:5d}  loss {loss:.4f}  "
                  f"{time.perf_counter() - t0:.2f}s")
        if (i + 1) % args.ckpt_every == 0:
            mgr.save((params, opt), i + 1)
    print("done; final loss", loss)


def train_bandit(spec, args):
    from ..core import distclub, env, env_ops

    dev = resolve_device(args.device)
    hyper = spec.cfg
    n, d = (2048, 25) if args.reduce else (20480, 25)
    e, _ = env.make_synthetic_env(0, n, d, 50, hyper.n_candidates,
                                  device=dev)
    ops = env_ops.synthetic_ops(e)
    state, metrics, nclu = distclub.run(ops, args.seed, hyper,
                                        n_epochs=args.steps, d=d, device=dev)
    T = int(metrics.interactions.sum())
    print(f"{T} interactions, reward/random = "
          f"{float(metrics.reward.sum()) / float(metrics.rand_reward.sum()):.3f}, "
          f"clusters {nclu.tolist()[-5:]}")


def recsys_batch(arch: str, cfg, batch: int, seed: int, step: int, device):
    """Step ``step``'s synthetic batch, drawn on the host from a generator
    seeded by ``(seed, step)`` and moved to ``device``, with the generator
    that draws the step's negatives: DCN-v2 ``(dense N(0, 1), sparse ids
    uniform over each field, labels Bernoulli(0.3))``; the sequence
    models ``(history, targets)``, ids uniform in ``[1, n_items)``,
    the history its own targets (SASRec, BERT4Rec) or one target a row
    (MIND)."""
    g = _step_generator(seed, step)
    if arch == "dcn-v2":
        dense = torch.randn(batch, cfg.n_dense, generator=g)
        sparse = torch.randint(0, cfg.vocab_per_field, (batch, cfg.n_sparse),
                               generator=g, dtype=torch.int32)
        labels = (torch.rand(batch, generator=g) < 0.3).float()
        out = (dense, sparse, labels)
    else:
        hist = torch.randint(1, cfg.n_items, (batch, cfg.seq_len),
                             generator=g, dtype=torch.int32)
        tgt = (hist if arch != "mind"
               else torch.randint(1, cfg.n_items, (batch,), generator=g,
                                  dtype=torch.int32))
        out = (hist, tgt)
    return tuple(t.to(device) for t in out), g


def recsys_step(loss_fn, model, params, opt, batch, gen=None):
    """One Adagrad step of ``loss_fn(model, *batch)`` (with ``gen`` after
    the batch where the loss draws negatives); returns ``(params, opt,
    loss)``, the parameters updated in place."""
    args = (model, *batch) + (() if gen is None else (gen,))
    loss, grads = value_and_grad(loss_fn, params, *args)
    params, opt = optimizer.adagrad_update(grads, opt, params)
    return params, opt, loss


def recsys_model(arch: str, cfg, seed: int, device):
    """``(model with gradients on, its loss function, whether the loss
    takes a generator for its negatives)``."""
    from ..models.recsys import dcn_v2, mind, seqrec

    if arch == "dcn-v2":
        cls, loss_fn = dcn_v2.DCNv2, dcn_v2.dcn_loss
    elif arch == "mind":
        cls, loss_fn = mind.MIND, mind.mind_loss
    else:
        cls, loss_fn = seqrec.SeqRec, seqrec.sampled_softmax_loss
    model = cls(cfg, seed=seed, device=device).requires_grad_(True)
    return model, loss_fn, arch != "dcn-v2"


def train_recsys(spec, args):
    dev = resolve_device(args.device)
    cfg = _reduced_cfg(spec) if args.reduce else spec.cfg
    model, loss_fn, sampled = recsys_model(spec.arch_id, cfg, args.seed, dev)
    params = model.tree()
    opt = optimizer.adagrad_init(params)
    for i in range(args.steps):
        batch, g = recsys_batch(spec.arch_id, cfg, args.batch, args.seed, i,
                                dev)
        params, opt, loss = recsys_step(loss_fn, model, params, opt, batch,
                                        g if sampled else None)
        if i % args.log_every == 0:
            print(f"step {i:5d}  loss {float(loss):.4f}")
    print("done; final loss", float(loss))


def get_spec(arch: str) -> ArchSpec:
    """The registered spec of ``arch``."""
    return configs.get(arch)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduce", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    spec = get_spec(args.arch)
    if spec.family == "lm":
        train_lm(spec, args)
    elif spec.family == "bandit":
        train_bandit(spec, args)
    elif spec.family == "recsys":
        train_recsys(spec, args)
    else:
        raise SystemExit("use tests/benchmarks for the GNN training path")


if __name__ == "__main__":
    main()
