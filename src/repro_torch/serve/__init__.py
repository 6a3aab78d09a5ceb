"""Online serving on the port: policy-pluggable ``OnlineBandit`` sessions
bound to the stage engine (``repro.serve``, single host).

    from repro_torch import serve

    session = serve.OnlineBandit.create(n_users, d, hyper,
                                        policy="distclub",
                                        refresh_every=n_users * 4)
    session, choices, metrics = serve.step(session, key, user_ids,
                                           contexts, reward_fn)

Against a persistent catalog, unpruned or cluster-pruned (bit-equal)::

    cat = serve.make_catalog(item_embeddings)
    session, item_ids, metrics = serve.step_catalog(
        session, key, user_ids, cat, reward_fn, k_short=64)
    clusters = serve.build_clusters(cat)
    session, item_ids, metrics, rmet = serve.step_catalog(
        session, key, user_ids, cat, reward_fn, clusters=clusters)

Delayed feedback: ``pending_capacity > 0`` makes ``recommend`` issue
decision ids and ``observe_delayed`` fold feedback by id.

Reduced precision: ``OnlineBandit.create(..., precision="bf16")`` (or
``"int8"``, or ``REPRO_PRECISION``) keeps ``Minv`` in bf16, and
``make_catalog(emb, precision=...)`` stores bf16 or int8 banks.
Checkpoints: ``session.save(CheckpointManager(dir), step)`` and
``session.restore(ckpt)`` (``train.checkpoint``).

The operations layer: ``guardrails.Guarded`` watches CTR, recall, ring
occupancy, latency and churn and rolls the session back to its last
healthy checkpoint; ``faults.run_faulted`` / ``run_faulted_catalog``
drive a session through seeded delivery faults and live catalog churn;
``experiments`` splits live traffic over policy arms (sticky hash,
Thompson-sampling selector, per-arm guardrails)::

    from repro_torch.serve import experiments
    exp = experiments.create([sess_a, sess_b, sess_c],
                             selector=experiments.make_selector(3))
    exp, choices, ids = experiments.recommend(exp, user_ids, contexts)
    exp = experiments.observe_delayed(exp, ids, rewards)

Policies: ``distclub`` | ``club`` | ``linucb`` | ``dccb``.
"""
from ..core.catalog import (Bank, Catalog, add_items, dequantize,
                            make_catalog, publish, random_catalog,
                            retire_items, staged_churn, torn_publish)
from ..core.itemclub import (ItemClusters, ItemStats, RetrievalMetrics,
                             build_clusters, init_stats, observe_served,
                             refresh_clusters, reset_new_slots)
from . import experiments, faults, guardrails
from .experiments import (Experiment, ExperimentReport, TSSelector,
                          assign_arms, make_selector, run_experiment)
from .faults import (FaultReport, FaultSpec, TrafficStream, run_faulted,
                     run_faulted_catalog)
from .guardrails import (Guarded, GuardrailConfig, GuardrailState,
                         post_rollback_state, shortlist_recall)
from .pending import PendingBuffer
from .policies import (POLICIES, ClusteredPolicy, ClusteredState,
                       DCCBPolicy, DCCBServeState, LinUCBPolicy, LinUCBServeState, ServeCfg,
                       from_distclub_state, get_policy, make_cfg,
                       to_distclub_state)
from .session import (OnlineBandit, embed_candidates, observe,
                      observe_delayed, pending_stats, recommend,
                      recommend_catalog, refresh, reset_pending, step,
                      step_catalog)

__all__ = [
    "Bank", "Catalog", "POLICIES", "ClusteredPolicy", "ClusteredState",
    "DCCBPolicy", "DCCBServeState", "Experiment", "ExperimentReport",
    "FaultReport", "FaultSpec", "Guarded", "GuardrailConfig",
    "GuardrailState", "ItemClusters", "ItemStats", "LinUCBPolicy",
    "LinUCBServeState", "OnlineBandit", "PendingBuffer", "RetrievalMetrics",
    "ServeCfg", "TSSelector", "TrafficStream",
    "add_items", "assign_arms", "build_clusters", "dequantize",
    "embed_candidates", "experiments", "faults", "from_distclub_state",
    "get_policy", "guardrails", "init_stats", "make_catalog", "make_cfg",
    "make_selector", "observe", "observe_delayed", "observe_served",
    "pending_stats", "post_rollback_state", "publish", "random_catalog",
    "recommend", "recommend_catalog", "refresh", "refresh_clusters",
    "reset_new_slots", "reset_pending", "retire_items", "run_experiment",
    "run_faulted", "run_faulted_catalog", "shortlist_recall",
    "staged_churn", "step", "step_catalog", "to_distclub_state",
    "torn_publish",
]
