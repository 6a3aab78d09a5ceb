"""Logged-interaction (replay) tables for the paper-dataset clones.

The paper's datasets are logs: each interaction has a user, a candidate
set drawn from a finite item table and a click.  This module builds such
a log from a clone (``repro.data.replay``'s construction), so that the
algorithms run under the replay protocol: each user reads its own queue
of slates in order, whatever the batching of rounds.
``data.datasets.make_env(spec, kind="replay")`` is the front door.

    item_feats  [n_items, d]         unit rows
    cand_ids    [n_users, max_t, K]  int32 item ids in [1, n_items)
    click_probs [n_users, max_t, K]  f32 ``expected_reward`` of each

The click probabilities are computed a chunk of users at a time, so the
``[n_users, max_t, K, d]`` features of every logged slot are never formed
whole (5.1 GB at the synthetic spec; the two tables are 205 MB each).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..core import env as core_env
from ..core.env_ops import EnvOps, replay_ops
from .datasets import DatasetSpec

_CHUNK_SLOTS = 2**20      # logged slots (user, t, k) per chunk: 100 MB at d=25


class ReplayLog(NamedTuple):
    item_feats: torch.Tensor   # [n_items, d]
    cand_ids: torch.Tensor     # [n_users, max_t, K] i32
    click_probs: torch.Tensor  # [n_users, max_t, K] f32


def _click_probs(theta: torch.Tensor, item_feats: torch.Tensor,
                 cand_ids: torch.Tensor) -> torch.Tensor:
    """``expected_reward(theta[u], item_feats[cand_ids[u, t, k]])`` for
    every logged slot, a chunk of users at a time."""
    n, max_t, K = cand_ids.shape
    out = torch.empty(n, max_t, K, dtype=item_feats.dtype,
                      device=item_feats.device)
    step = max(1, _CHUNK_SLOTS // (max_t * K))
    for u0 in range(0, n, step):
        feats = item_feats[cand_ids[u0:u0 + step].long()]   # [c, t, K, d]
        out[u0:u0 + step] = core_env.expected_reward(
            theta[u0:u0 + step, None, None, :], feats)
    return out


def make_replay_log(spec: DatasetSpec, *, n_items: int = 2048,
                    max_t: int = 64, seed: int = 0, device=None
                    ) -> tuple[ReplayLog, torch.Tensor]:
    """The log of ``spec``'s clone and its users' true labels.  The users
    are ``make_synthetic_env(seed, ...)``'s (within-cluster noise 0.05);
    the item table and the slates come from a second generator."""
    dev = resolve_device(device)
    env, labels = core_env.make_synthetic_env(
        seed, n_users=spec.n_users, d=spec.d, n_clusters=spec.n_clusters,
        n_candidates=spec.n_candidates, within_cluster_noise=0.05,
        device=dev)
    g = torch.Generator(device=dev).manual_seed(core_env.item_seed(seed))
    item_feats = torch.randn(n_items, spec.d, generator=g, device=dev)
    item_feats = item_feats / torch.linalg.norm(item_feats, dim=-1,
                                                keepdim=True)
    cand_ids = torch.randint(1, n_items, (spec.n_users, max_t,
                                          spec.n_candidates),
                             generator=g, device=dev,
                             dtype=torch.int32)
    probs = _click_probs(env.theta, item_feats, cand_ids)
    return ReplayLog(item_feats, cand_ids, probs), labels


def make_replay_env(spec: DatasetSpec, *, n_items: int = 2048,
                    max_t: int = 64, seed: int = 0, device=None
                    ) -> tuple[EnvOps, torch.Tensor]:
    """``replay_ops`` over ``make_replay_log``'s tables; (EnvOps,
    labels)."""
    log, labels = make_replay_log(spec, n_items=n_items, max_t=max_t,
                                  seed=seed, device=device)
    return replay_ops(*log), labels
