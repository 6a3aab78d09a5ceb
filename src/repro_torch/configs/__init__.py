"""Architecture configs: importing the package registers the ported
archs (the four recsys models and the three dense LMs); the paper's own
bandit configuration is the plain module ``distclub_paper``.  The MoE
LMs (deepseek-moe-16b, llama4-maverick) wait for the MoE slice."""
from . import bert4rec, dcn_v2, llama3_8b, mind, qwen3_4b, sasrec, yi_34b  # noqa: F401
from .base import REGISTRY, ArchSpec, ShapeCell, all_cells, get  # noqa: F401
