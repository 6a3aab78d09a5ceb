"""The paper's own configuration: DistCLUB on the synthetic stress set
(20k users, d=25 features, 20 candidates per interaction; paper Tables
1-2).  Copied from ``repro.configs.distclub_paper``; the synthetic
environment at this scale plants 100 clusters with within-cluster noise
0.05 (the ``"synthetic"`` dataset spec of ``repro.data.datasets``).
"""
from ..core.types import BanditHyper

N_USERS = 20_480          # paper: 20,000; rounded to divide 512-way meshes
D_FEAT = 25
N_CLUSTERS = 100
WITHIN_CLUSTER_NOISE = 0.05

CONFIG = BanditHyper(
    alpha=0.03, beta=2.0, gamma=1.6, sigma=16, n_candidates=20,
    max_rounds=32,
)
