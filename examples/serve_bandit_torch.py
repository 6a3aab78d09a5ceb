"""End-to-end online recommendation service on the PyTorch port:
SASRec embeddings + DistCLUB (``serve_bandit.py``'s story).

SASRec supplies candidate item embeddings as bandit contexts, an
``OnlineBandit`` session explores and exploits per user (stage-2
re-clustering fires on an interaction budget), and ``CheckpointManager``
snapshots the service every 50 steps.  At step 120 the session is killed;
a new one restores the latest checkpoint, replays the traffic it missed,
and must plan the dead session's next choices bit for bit.

    PYTHONPATH=src python examples/serve_bandit_torch.py                # card
    PYTHONPATH=src python examples/serve_bandit_torch.py --precision bf16
    PYTHONPATH=src python examples/serve_bandit_torch.py --device cpu

Checkpoints go to ``build/serve_bandit_ckpt`` under the repository root
unless ``--ckpt-dir`` says otherwise; the directory is emptied first.
"""
import argparse
import pathlib
import shutil

import torch

from repro_torch import serve
from repro_torch.core import clustering
from repro_torch.core import env as bandit_env
from repro_torch.core.types import BanditHyper
from repro_torch.models.recsys import seqrec
from repro_torch.train.checkpoint import CheckpointManager

N_USERS, N_ITEMS, D, K = 256, 2048, 32, 20
BATCH = 128
HYPER = BanditHyper(alpha=0.05, beta=2.0, gamma=2.4, n_candidates=K)
CKPT_DIR = pathlib.Path(__file__).resolve().parents[1] / "build" / \
    "serve_bandit_ckpt"


class Service:
    """The embedding model (trained offline; random weights here), the
    users' hidden preferences that drive the simulated clicks, and each
    step's requests, all drawn from fixed seeds on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)
        cfg = seqrec.SeqRecConfig(n_items=N_ITEMS, embed_dim=D, n_blocks=2,
                                  n_heads=2, seq_len=16)
        self.model = seqrec.SeqRec(cfg, seed=0, device=self.device)
        world, _ = bandit_env.make_synthetic_env(
            1, n_users=N_USERS, d=D, n_clusters=8, n_candidates=K,
            device=self.device)
        self.theta = world.theta

    def _gen(self, step: int, stream: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            3 * step + stream)

    def requests(self, step: int):
        """One batch: distinct users and SASRec-embedded candidate
        slates."""
        g = self._gen(step, 0)
        users = torch.randperm(N_USERS, generator=g, device=self.device)[
            :BATCH].to(torch.int32)
        cand = torch.randint(0, N_ITEMS, (BATCH, K), generator=g,
                             device=self.device)
        return users, serve.embed_candidates(self.model.item_embed, cand)

    def reward_fn(self, step, user_ids, contexts, choices):
        """Bernoulli clicks in the hidden affinity (step's own draws)."""
        u = torch.rand(user_ids.shape[0], generator=self._gen(step, 1),
                       device=self.device)
        return bandit_env.step_rewards(u, self.theta[user_ids.long()],
                                       contexts, choices)


def new_session(device, precision):
    return serve.OnlineBandit.create(N_USERS, D, HYPER, policy="distclub",
                                     refresh_every=N_USERS * 4,
                                     precision=precision, device=device)


def main(device="cuda", precision="f32", crash_at=120, every=50, after=80,
         ckpt_dir=CKPT_DIR):
    """Serve ``crash_at`` steps, checkpointing every ``every``; crash,
    restore, replay, and check the resumed choices; then serve ``after``
    more.  Returns ``(planned, resumed, reward / random)``."""
    svc = Service(device)
    session = new_session(device, precision)
    shutil.rmtree(ckpt_dir, ignore_errors=True)   # clean slate, THEN the
    ckpt = CheckpointManager(ckpt_dir, keep=2)    # manager, once

    total_reward = total_rand = 0.0
    for step in range(crash_at):
        users, contexts = svc.requests(step)
        session, _, m = serve.step(session, step, users, contexts,
                                   svc.reward_fn)
        total_reward += float(m.reward)
        total_rand += float(m.rand_reward)
        if (step + 1) % every == 0:
            session.save(ckpt, step + 1)
            n_clu = int(clustering.num_clusters(session.state.labels))
            print(f"step {step + 1:3d}: reward/random = "
                  f"{total_reward / total_rand:.3f}, clusters = {n_clu}, "
                  f"checkpointed @ {ckpt.latest_step()}")

    # --- kill the replica mid-run and resume from the latest checkpoint --
    probe_users, probe_contexts = svc.requests(crash_at)
    planned = serve.recommend(session, probe_users, probe_contexts)
    del session                                   # the "crash"
    session, resumed_at = new_session(device, precision).restore(ckpt)
    print(f"\nreplica restarted from checkpoint @ step {resumed_at} "
          f"(precision {precision})")
    # replay the traffic the checkpoint missed (its rewards were tallied
    # before the crash, so only the state advances); the restarted replica
    # must then plan exactly the dead one's choices
    for step in range(resumed_at, crash_at):
        users, contexts = svc.requests(step)
        session, _, _ = serve.step(session, step, users, contexts,
                                   svc.reward_fn)
    resumed = serve.recommend(session, probe_users, probe_contexts)
    assert torch.equal(planned, resumed), "resumed choices differ"
    print("restored replica reproduces the pre-crash choices "
          "bit-for-bit: OK")

    for step in range(crash_at, crash_at + after):
        users, contexts = svc.requests(step)
        session, _, m = serve.step(session, step, users, contexts,
                                   svc.reward_fn)
        total_reward += float(m.reward)
        total_rand += float(m.rand_reward)
    ratio = total_reward / total_rand
    print(f"\nfinal reward vs random policy: {ratio:.3f}")
    return planned, resumed, ratio


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--precision", default="f32",
                        choices=("f32", "bf16", "int8"))
    parser.add_argument("--crash-at", type=int, default=120)
    parser.add_argument("--every", type=int, default=50)
    parser.add_argument("--after", type=int, default=80)
    parser.add_argument("--ckpt-dir", type=pathlib.Path, default=CKPT_DIR)
    a = parser.parse_args()
    main(a.device, a.precision, a.crash_at, a.every, a.after, a.ckpt_dir)
