"""Paper-dataset clones and the synthetic stress set (paper Table 1),
as ``repro.data.datasets`` defines them.

The real MovieLens / LastFM / Delicious / Yahoo logs are not downloaded:
each dataset is a stat-matched clone with the same user count, feature
dimension and interaction count, a planted cluster structure over the
user preference vectors and 0/1 rewards, evaluated as the paper does
(Li et al. 2014): every interaction presents a candidate set and the
learner is rewarded iff the user clicks its pick.

``make_env`` names the protocol that drives the clone:

  kind="synthetic"  fresh candidate sets per interaction against the
                    planted preferences (``synthetic_ops``).
  kind="replay"     logged tables: an item table and per-user queues of
                    slates with affinity-derived CTRs (``data.replay``,
                    ``replay_ops``), the paper's offline protocol.
  kind="drift"      the planted centroids re-draw periodically
                    (``drift_ops``): "content popularity can change
                    rapidly".
  kind="catalog"    slates drawn from a persistent region-structured
                    catalog (``catalog_ops``); ``drift_period`` re-draws
                    its region centroids.

Every kind returns an ``EnvOps`` that DistCLUB, CLUB and DCCB run on.
Cluster counts follow CLUB's evaluation (10 clusters for the web
datasets, 100 for the synthetic stress set).  The tables are drawn on
``device`` (default ``cuda``; raises without a card unless
``device="cpu"``) from seeded ``torch.Generator``s.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core import env as core_env
from ..core.env_ops import EnvOps, catalog_ops, drift_ops, synthetic_ops


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_interactions: int
    n_users: int
    d: int                 # item feature dim (paper Table 1)
    n_clusters: int
    n_candidates: int = 20


# paper Table 1 (Yahoo's d is listed as 1, a degenerate linear model; the
# CLUB preprocessing it cites uses 5-dim reduced features, adopted here so
# that clustering means something)
PAPER_DATASETS = {
    "movielens": DatasetSpec("movielens", 80_000, 943, 19, 10),
    "lastfm": DatasetSpec("lastfm", 10_000, 1_888, 25, 10),
    "delicious": DatasetSpec("delicious", 10_000, 1_816, 25, 10),
    "yahoo": DatasetSpec("yahoo", 50_000, 5_045, 5, 10),
    "synthetic": DatasetSpec("synthetic", 4_000_000, 20_000, 25, 100),
    # reduced synthetic for CI-scale runs
    "synthetic-small": DatasetSpec("synthetic-small", 64_000, 2_000, 25, 50),
}

# replay queues are bounded so that the [n_users, max_t, K] tables stay
# small (the synthetic set would need max_t = 200); past the bound a
# user's cursor clamps to its last logged slate (``replay_ops``)
_REPLAY_MAX_T = 128

# the persistent catalog of kind="catalog" offline runs: big enough that
# a round's slates rarely repeat an item, small enough that its tables
# stay trivial (catalog serving builds up to 2**20 items through
# ``core.env.make_catalog_env``)
_CATALOG_ITEMS = 4096


def make_env(spec: DatasetSpec, seed: int = 0, kind: str = "synthetic",
             drift_period: int | None = None, n_items: int | None = None,
             device=None) -> tuple[EnvOps, torch.Tensor]:
    """(EnvOps, true_labels) for a stat-matched clone of ``spec``.

    ``kind`` selects the protocol (see the module docstring).  "drift"
    re-draws the planted centroids every ``drift_period`` interactions
    (default: a quarter of the spec's per-user budget, over 4 phases);
    "catalog" draws slates from ``n_items`` items (default
    ``_CATALOG_ITEMS``) in one static phase unless ``drift_period`` is
    given (then 4 phases).  Catalog serving builds the same catalog with
    ``core.env.make_catalog_env`` and ``catalog_embeddings``.
    """
    if kind == "synthetic":
        env, labels = core_env.make_synthetic_env(
            seed, n_users=spec.n_users, d=spec.d,
            n_clusters=spec.n_clusters, n_candidates=spec.n_candidates,
            within_cluster_noise=0.05, device=device)
        return synthetic_ops(env), labels
    if kind == "replay":
        from .replay import make_replay_env
        max_t = min(_REPLAY_MAX_T,
                    max(1, math.ceil(spec.n_interactions / spec.n_users)))
        return make_replay_env(spec, max_t=max_t, seed=seed, device=device)
    if kind == "drift":
        per_user = max(1, spec.n_interactions // spec.n_users)
        env, labels = core_env.make_drift_env(
            seed, n_users=spec.n_users, d=spec.d,
            n_clusters=spec.n_clusters, n_candidates=spec.n_candidates,
            drift_period=drift_period or max(1, per_user // 4), n_phases=4,
            within_cluster_noise=0.05, device=device)
        return drift_ops(env), labels
    if kind == "catalog":
        period = drift_period or 0
        env, labels = core_env.make_catalog_env(
            seed, n_users=spec.n_users, d=spec.d,
            n_clusters=spec.n_clusters, n_items=n_items or _CATALOG_ITEMS,
            n_candidates=spec.n_candidates, drift_period=period,
            n_phases=4 if period else 1, within_cluster_noise=0.05,
            device=device)
        return catalog_ops(env), labels
    raise ValueError(
        f"unknown env kind {kind!r}; want synthetic|replay|drift|catalog")


def epochs_for(spec: DatasetSpec, hyper) -> int:
    """Four-stage epochs whose interactions come closest below the
    dataset's logged count (at least 1).  An epoch serves at most
    ``n_users * 2 * min(sigma, max_rounds)`` interactions: rebalancing
    keeps ``u_rounds + c_rounds = 2 sigma`` per user, but each budget is
    clipped to the ``max_rounds`` rounds a stage runs."""
    per_epoch = spec.n_users * 2 * min(hyper.sigma, hyper.max_rounds)
    return max(1, spec.n_interactions // per_epoch)
