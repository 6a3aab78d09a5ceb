"""bert4rec [arXiv:1904.06690; paper] (``repro.configs.bert4rec``).

embed_dim=64 n_blocks=2 n_heads=2 seq_len=200, bidirectional encoder,
cloze (masked-item) objective.  Catalog of 2^20 items.
"""
from ..models.recsys.seqrec import SeqRecConfig
from .base import ArchSpec, register
from .recsys_shapes import seq_shapes

CONFIG = SeqRecConfig(
    name="bert4rec", n_items=1 << 20, embed_dim=64, n_blocks=2, n_heads=2,
    seq_len=200, causal=False,
)

SPEC = register(ArchSpec(
    arch_id="bert4rec", family="recsys", cfg=CONFIG,
    shapes=seq_shapes(seq_len=200, target_per_pos=True),
    source="arXiv:1904.06690",
))
