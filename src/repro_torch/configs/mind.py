"""mind [arXiv:1904.08030; unverified] (``repro.configs.mind``).

embed_dim=64, 4 interest capsules, 3 routing iterations, multi-interest
label-aware attention, histories of 50 items, catalog of 2^20 items.
"""
from ..models.recsys.mind import MINDConfig
from .base import ArchSpec, register
from .recsys_shapes import seq_shapes

CONFIG = MINDConfig(
    name="mind", n_items=1 << 20, embed_dim=64, n_interests=4,
    capsule_iters=3, seq_len=50,
)

SPEC = register(ArchSpec(
    arch_id="mind", family="recsys", cfg=CONFIG,
    shapes=seq_shapes(seq_len=50, target_per_pos=False),
    source="arXiv:1904.08030",
))
