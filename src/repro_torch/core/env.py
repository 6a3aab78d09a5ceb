"""Bandit environments: the planted-cluster synthetic environment (the
paper's "Synthetic" dataset and the standard CLUB evaluation protocol),
its non-stationary drift variant and the fixed-catalog environment.

Each user has a hidden unit vector theta drawn around one of
``n_clusters`` unit centroids; a set of ``K`` unit contexts is drawn per
interaction (``core.env_ops``); the click probability of item x for user
u is ``p = (1 + x . theta_u) / 2`` and the realized reward is
Bernoulli(p).  ``DriftEnv`` re-draws the centroids every
``drift_period`` of a user's own interactions, so its theta is a pure
function of (occ, user).  ``CatalogEnv`` keeps the synthetic users and
adds a persistent region-structured item catalog for catalog serving and
for the offline ``catalog`` kind.  The tables are drawn on the device
from seeded ``torch.Generator``s; they do not reproduce the reference's
JAX draws, which the parity tests bridge by handing both packages the
same tables (``convert.record_from_numpy``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


def step_rewards(uniforms: torch.Tensor, theta_u: torch.Tensor,
                 contexts: torch.Tensor, choice: torch.Tensor):
    """Realized Bernoulli reward of the chosen item and the regret terms:
    ``(reward, expected, best_expected, rand_reward)`` over the leading
    axes.  ``uniforms`` are the Bernoulli draws, where the reference takes
    a PRNG key; ``rand_reward`` is the expected reward of a uniformly
    random pick (the paper's RAN baseline)."""
    p_all = expected_reward(theta_u[..., None, :], contexts)      # [..., K]
    return click_metrics(uniforms, p_all, choice, contexts.dtype)


def click_metrics(uniforms: torch.Tensor, p_all: torch.Tensor,
                  choice: torch.Tensor, dtype: torch.dtype):
    """``step_rewards`` from the click probabilities ``p_all [..., K]`` of
    every candidate (a replay log's logged CTRs)."""
    p_choice = torch.take_along_dim(p_all, choice.long()[..., None],
                                    dim=-1)[..., 0]
    realized = (uniforms < p_choice).to(dtype)
    return realized, p_choice, p_all.max(dim=-1).values, p_all.mean(dim=-1)


def sample_contexts(generator: torch.Generator, shape_prefix, K: int,
                    d: int) -> torch.Tensor:
    """Unit-norm candidate features ``[*shape_prefix, K, d]``, drawn from
    ``generator`` (on its device) where the reference takes a key."""
    x = torch.randn(*shape_prefix, K, d, generator=generator,
                    device=generator.device)
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# the non-stationary environment (periodic centroid re-draws)
# ---------------------------------------------------------------------------


class DriftEnv(NamedTuple):
    """Planted clusters whose centroids re-draw every ``drift_period`` of a
    user's own interactions: user ``u`` at interaction count ``occ`` has

        theta = normalize(centroids[min(occ // drift_period, P - 1),
                                    labels[u]] + noise[u])
    """

    centroids: torch.Tensor   # [n_phases, n_clusters, d] unit rows
    labels: torch.Tensor      # [n_users] i32 fixed cluster assignment
    noise: torch.Tensor       # [n_users, d] per-user within-cluster offset
    drift_period: int
    n_candidates: int

    @property
    def n_users(self) -> int:
        return self.labels.shape[0]

    @property
    def d(self) -> int:
        return self.centroids.shape[-1]

    @property
    def n_phases(self) -> int:
        return self.centroids.shape[0]


def make_drift_env(
    seed: int,
    n_users: int,
    d: int,
    n_clusters: int,
    n_candidates: int = 20,
    drift_period: int = 64,
    n_phases: int = 4,
    within_cluster_noise: float = 0.05,
    device=None,
) -> tuple[DriftEnv, torch.Tensor]:
    """Planted clustered environment whose centroids re-draw every
    ``drift_period`` interactions; returns (env, true_labels)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    centroids = torch.randn(n_phases, n_clusters, d, generator=g, device=dev)
    centroids = centroids / torch.linalg.norm(centroids, dim=-1, keepdim=True)
    labels = torch.randint(0, n_clusters, (n_users,), generator=g,
                           device=dev, dtype=torch.int64).to(torch.int32)
    noise = within_cluster_noise * torch.randn(n_users, d, generator=g,
                                               device=dev)
    return DriftEnv(centroids=centroids, labels=labels, noise=noise,
                    drift_period=drift_period,
                    n_candidates=n_candidates), labels


def _phase(occ: torch.Tensor, period: int, n_phases: int) -> torch.Tensor:
    """``clamp(occ // period, 0, n_phases - 1)`` in int32."""
    return torch.clamp(torch.div(occ.to(torch.int32), period,
                                 rounding_mode="floor"), 0, n_phases - 1)


def drift_theta(env: DriftEnv, occ: torch.Tensor, row0: int = 0
                ) -> torch.Tensor:
    """Hidden preference vectors of the user slice ``[row0, row0 +
    occ.shape[0])`` at per-user interaction counts ``occ``."""
    rows = slice(row0, row0 + occ.shape[0])
    phase = _phase(occ, env.drift_period, env.n_phases)
    theta = env.centroids[phase.long(), env.labels[rows].long()] \
        + env.noise[rows]
    return theta / torch.linalg.norm(theta, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# the fixed-catalog environment (catalog serving's workload)
# ---------------------------------------------------------------------------


class CatalogEnv(NamedTuple):
    """Planted-cluster users against a persistent item catalog: item ``i``
    lives in region ``item_region[i]`` and its embedding at phase ``p`` is
    ``normalize(region_centroids[p, item_region[i]] + item_noise[i])``.
    ``drift_period == 0`` pins phase 0 (one static catalog)."""

    theta: torch.Tensor             # [n_users, d] hidden user preferences
    region_centroids: torch.Tensor  # [n_phases, n_regions, d] unit rows
    item_region: torch.Tensor       # [n_items] i32
    item_noise: torch.Tensor        # [n_items, d]
    drift_period: int
    n_candidates: int

    @property
    def n_users(self) -> int:
        return self.theta.shape[0]

    @property
    def d(self) -> int:
        return self.theta.shape[1]

    @property
    def n_items(self) -> int:
        return self.item_region.shape[0]

    @property
    def n_phases(self) -> int:
        return self.region_centroids.shape[0]


def item_seed(seed: int) -> int:
    """The item side's generator seed: a fixed odd-multiplier remix of
    ``seed``, so it differs from the user side's while both follow it."""
    return (seed * 0x9E3779B1 + 0x7F4A7C15) % (2**63)


def make_catalog_env(
    seed: int,
    n_users: int,
    d: int,
    n_clusters: int,
    n_items: int,
    n_regions: int | None = None,
    n_candidates: int = 20,
    drift_period: int = 0,
    n_phases: int = 1,
    within_cluster_noise: float = 0.05,
    item_noise_scale: float = 0.05,
    device=None,
) -> tuple[CatalogEnv, torch.Tensor]:
    """Planted users + region-structured item catalog; returns ``(env,
    true_user_labels)``.  The user side is ``make_synthetic_env`` with the
    same seed, so a catalog env serves the users an offline run learned."""
    dev = resolve_device(device)
    if n_regions is None:
        n_regions = n_clusters
    user_env, labels = make_synthetic_env(
        seed, n_users, d, n_clusters, n_candidates=n_candidates,
        within_cluster_noise=within_cluster_noise, device=dev)
    g = torch.Generator(device=dev).manual_seed(item_seed(seed))
    centroids = torch.randn(n_phases, n_regions, d, generator=g, device=dev)
    centroids = centroids / torch.linalg.norm(centroids, dim=-1, keepdim=True)
    region = torch.randint(0, n_regions, (n_items,), generator=g, device=dev,
                           dtype=torch.int64).to(torch.int32)
    noise = item_noise_scale * torch.randn(n_items, d, generator=g,
                                           device=dev)
    return CatalogEnv(
        theta=user_env.theta, region_centroids=centroids,
        item_region=region, item_noise=noise,
        drift_period=drift_period, n_candidates=n_candidates,
    ), labels


def catalog_embeddings(env: CatalogEnv, phase: int = 0) -> torch.Tensor:
    """The full ``[n_items, d]`` unit-norm catalog at ``phase``."""
    e = env.region_centroids[phase, env.item_region.long()] + env.item_noise
    return e / torch.linalg.norm(e, dim=-1, keepdim=True)


def catalog_phase(env: CatalogEnv, occ: torch.Tensor) -> torch.Tensor:
    """Per-user drift phase (int32) from the per-user interaction count;
    0 throughout for a static catalog (``drift_period <= 0``)."""
    if env.drift_period <= 0:
        return torch.zeros(occ.shape, dtype=torch.int32, device=occ.device)
    return _phase(occ, env.drift_period, env.n_phases)


def region_item_ids(env: CatalogEnv, region: int) -> np.ndarray:
    """Host ids (int32) of the catalog items planted in ``region``."""
    return np.nonzero(env.item_region.cpu().numpy() == region)[0].astype(
        np.int32)


def sample_churn_items(env: CatalogEnv, generator: torch.Generator, m: int,
                       region: int | None = None, phase: int = 0,
                       noise_scale: float = 0.05
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """``m`` fresh items in the planted regions (all in ``region`` when
    given, the flash-crowd case); ``(emb [m, d] unit rows, regions [m]
    i32)``, drawn from ``generator`` where the reference takes a key."""
    dev = env.region_centroids.device
    if region is None:
        regions = torch.randint(0, env.region_centroids.shape[1], (m,),
                                generator=generator, device=dev,
                                dtype=torch.int64)
    else:
        regions = torch.full((m,), region, dtype=torch.int64, device=dev)
    e = (env.region_centroids[phase, regions]
         + noise_scale * torch.randn(m, env.d, generator=generator,
                                     device=dev))
    return (e / torch.linalg.norm(e, dim=-1, keepdim=True),
            regions.to(torch.int32))
