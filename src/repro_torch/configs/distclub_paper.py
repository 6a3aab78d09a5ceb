"""The paper's own configuration: DistCLUB on the synthetic stress set
(20k users, d=25 features, 20 candidates per interaction; paper Tables
1-2).  Copied from ``repro.configs.distclub_paper``; the synthetic
environment at this scale plants 100 clusters with within-cluster noise
0.05 (the ``"synthetic"`` dataset spec of ``repro.data.datasets``).

One cell, ``online_20k``: a full four-stage epoch on the production mesh
with users sharded over every axis.  Its inputs are the sharded engine
state (``distributed.distclub_shard.ShardedDistCLUB``) and ``key``, the
epoch's ``(seed, epoch)`` as two int64 words, where ``repro`` takes a
PRNG key.
"""
import torch

from ..core.types import BanditHyper
from .base import ArchSpec, ShapeCell, register

N_USERS = 20_480          # paper: 20,000; rounded to divide 512-way meshes
D_FEAT = 25
N_CLUSTERS = 100
WITHIN_CLUSTER_NOISE = 0.05

CONFIG = BanditHyper(
    alpha=0.03, beta=2.0, gamma=1.6, sigma=16, n_candidates=20,
    max_rounds=32,
)


def _epoch(cfg):
    n, d = N_USERS, D_FEAT
    return {
        "Minv": ((n, d, d), torch.float32),
        "b": ((n, d), torch.float32),
        "occ": ((n,), torch.int32),
        # bit-packed adjacency rows (an int32 view of repro's uint32 words)
        "adj": ((n, (n + 31) // 32), torch.int32),
        "labels": ((n,), torch.int32),
        "u_rounds": ((n,), torch.int32),
        "c_rounds": ((n,), torch.int32),
        "comm_bytes": ((), torch.float32),
        "key": ((2,), torch.int64),
    }


SPEC = register(ArchSpec(
    arch_id="distclub-paper", family="bandit", cfg=CONFIG,
    shapes={
        "online_20k": ShapeCell(
            "bandit_epoch", _epoch,
            "paper synthetic: 20480 users x d=25, full 4-stage epoch"),
    },
    source="this paper (Mahadik et al. 2020), Tables 1-2",
))
