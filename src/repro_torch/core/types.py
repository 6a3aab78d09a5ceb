"""Core datatypes for the DistCLUB port.

Flat NamedTuples of tensors, field for field the records of
``repro.core.types``, so a state converts across (``repro_torch.convert``)
without renaming.  The user axis ``n`` leads every per-user tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BanditHyper(NamedTuple):
    """Hyper-parameters shared by CLUB / DCCB / DistCLUB (paper Table 2)."""

    alpha: float = 0.03        # UCB exploration coefficient
    beta: float = 2.0          # DistCLUB cluster-penalizing threshold
    gamma: float = 0.7         # edge-deletion threshold multiplier
    sigma: int = 16            # initial uRounds/cRounds split (paper: 2500)
    delta_net: int = 64        # CLUB network-update period (paper: 2000)
    buffer_size: int = 32      # DCCB buffer length (paper: 5000)
    n_candidates: int = 20     # |context set| presented per interaction
    max_rounds: int = 64       # bound on uRounds/cRounds loop lengths


class LinUCBState(NamedTuple):
    """Per-user linear-bandit sufficient statistics.

    M    : [n, d, d]  Gram matrix  I + sum x x^T (refreshed by inversion)
    Minv : [n, d, d]  maintained inverse (Sherman-Morrison)
    b    : [n, d]     reward-weighted context sum
    occ  : [n] i32    interaction counts
    """

    M: torch.Tensor
    Minv: torch.Tensor
    b: torch.Tensor
    occ: torch.Tensor


class GraphState(NamedTuple):
    """User-similarity graph + current clustering.

    adj    : [n, ceil(n/32)] int32 — bit-packed rows, LSB-first (bit
             ``j % 32`` of word ``j // 32`` = edge (i, j)).  The bits are
             those of the reference's uint32 words; int32 because torch
             has no shifts for uint32 on the CPU.  Bit 31 makes a word
             negative, and a full word is -1.
    labels : [n] i32  cluster label = min user-id in the component
    """

    adj: torch.Tensor
    labels: torch.Tensor


class ClusterStats(NamedTuple):
    """Per-cluster aggregates, indexed by cluster label (a user id).

    Rows for ids that are not a current label are garbage and never read.
    """

    Mc: torch.Tensor      # [n, d, d]
    Mcinv: torch.Tensor   # [n, d, d]
    bc: torch.Tensor      # [n, d]
    size: torch.Tensor    # [n] i32   users per cluster
    seen: torch.Tensor    # [n] i32   interactions at the last stage 2


class DistCLUBState(NamedTuple):
    lin: LinUCBState
    graph: GraphState
    clusters: ClusterStats
    u_rounds: torch.Tensor    # [n] i32 per-user stage-1 budget
    c_rounds: torch.Tensor    # [n] i32 per-user stage-3 budget
    comm_bytes: torch.Tensor  # [] f32 modeled bytes shipped


class Metrics(NamedTuple):
    """Streaming evaluation counters (one slot per lockstep round)."""

    reward: torch.Tensor        # realized reward summed over the round
    regret: torch.Tensor        # expected-best minus expected-chosen
    rand_reward: torch.Tensor   # expected reward of a uniform-random pick
    interactions: torch.Tensor  # number of unmasked interactions
