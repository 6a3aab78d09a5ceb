"""yi-34b [arXiv:2403.04652; hf] (``repro.configs.yi_34b``).

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 (llama arch).
"""
import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_shapes, register

CONFIG = LMConfig(
    name="yi-34b",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab=64000,
    dtype=torch.bfloat16, attn_chunk=2048, microbatches=32,
)

SPEC = register(ArchSpec(
    arch_id="yi-34b", family="lm", cfg=CONFIG,
    shapes=lm_shapes(CONFIG), source="arXiv:2403.04652",
))
