"""The planted-cluster synthetic environment (the paper's "Synthetic"
dataset and the standard CLUB evaluation protocol).

Each user has a hidden unit vector theta drawn around one of
``n_clusters`` unit centroids; a set of ``K`` unit contexts is drawn per
interaction (``core.env_ops``); the click probability of item x for user
u is ``p = (1 + x . theta_u) / 2`` and the realized reward is
Bernoulli(p).  The tables are drawn on the device from a seeded
``torch.Generator``; they do not reproduce the reference's JAX draws,
which the parity tests bridge by handing both packages the same tables.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device


class SyntheticEnv(NamedTuple):
    theta: torch.Tensor       # [n_users, d] hidden preference vectors
    n_candidates: int

    @property
    def n_users(self) -> int:
        return self.theta.shape[0]

    @property
    def d(self) -> int:
        return self.theta.shape[1]


def make_synthetic_env(
    seed: int,
    n_users: int,
    d: int,
    n_clusters: int,
    n_candidates: int = 20,
    within_cluster_noise: float = 0.0,
    device=None,
) -> tuple[SyntheticEnv, torch.Tensor]:
    """Planted clustered environment; returns (env, true_labels)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    centroids = torch.randn(n_clusters, d, generator=g, device=dev)
    centroids = centroids / torch.linalg.norm(centroids, dim=-1, keepdim=True)
    labels = torch.randint(0, n_clusters, (n_users,), generator=g,
                           device=dev, dtype=torch.int64).to(torch.int32)
    theta = centroids[labels.long()]
    if within_cluster_noise > 0:
        theta = theta + within_cluster_noise * torch.randn(
            theta.shape, generator=g, device=dev)
    theta = theta / torch.linalg.norm(theta, dim=-1, keepdim=True)
    return SyntheticEnv(theta=theta, n_candidates=n_candidates), labels


def expected_reward(theta_u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """p(click) in [0, 1]; broadcasts over leading axes of x."""
    return 0.5 * (1.0 + torch.einsum("...d,...d->...", x, theta_u))
