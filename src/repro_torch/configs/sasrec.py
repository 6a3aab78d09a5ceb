"""sasrec [arXiv:1808.09781; paper] (``repro.configs.sasrec``).

embed_dim=50 n_blocks=2 n_heads=1 seq_len=50, causal self-attention over
the item history, next-item objective.  Catalog scaled to 2^20 items (the
paper's datasets are small; the shape set assigns 2^20-candidate
retrieval).
"""
from ..models.recsys.seqrec import SeqRecConfig
from .base import ArchSpec, register
from .recsys_shapes import seq_shapes

CONFIG = SeqRecConfig(
    name="sasrec", n_items=1 << 20, embed_dim=50, n_blocks=2, n_heads=1,
    seq_len=50, causal=True,
)

SPEC = register(ArchSpec(
    arch_id="sasrec", family="recsys", cfg=CONFIG,
    shapes=seq_shapes(seq_len=50, target_per_pos=True),
    source="arXiv:1808.09781",
))
