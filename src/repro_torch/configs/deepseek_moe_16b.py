"""deepseek-moe-16b [arXiv:2401.06066; hf]
(``repro.configs.deepseek_moe_16b``).

28L d_model=2048 16H (kv=16) d_ff=1408 vocab=102400; 64 fine-grained
routed experts top-6 + 2 shared experts, every layer.
"""
import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_shapes, register

CONFIG = LMConfig(
    name="deepseek-moe-16b",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408, moe_every=1,
    dtype=torch.bfloat16, attn_chunk=2048, microbatches=16,
)

SPEC = register(ArchSpec(
    arch_id="deepseek-moe-16b", family="lm", cfg=CONFIG,
    shapes=lm_shapes(CONFIG), source="arXiv:2401.06066",
))
