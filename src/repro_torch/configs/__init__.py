"""Architecture configs: importing the package registers the ported
archs (the four recsys models, the three dense LMs, the two MoE LMs and
the GAT) and the paper's own bandit configuration, ``distclub_paper``."""
from . import (  # noqa: F401
    bert4rec,
    dcn_v2,
    deepseek_moe_16b,
    distclub_paper,
    gat_cora,
    llama3_8b,
    llama4_maverick_400b_a17b,
    mind,
    qwen3_4b,
    sasrec,
    yi_34b,
)
from .base import REGISTRY, ArchSpec, ShapeCell, all_cells, get  # noqa: F401
