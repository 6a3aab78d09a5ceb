"""llama3-8b [arXiv:2407.21783; unverified] (``repro.configs.llama3_8b``).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_shapes, register

CONFIG = LMConfig(
    name="llama3-8b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=128256,
    dtype=torch.bfloat16, attn_chunk=2048, microbatches=16,
)

SPEC = register(ArchSpec(
    arch_id="llama3-8b", family="lm", cfg=CONFIG,
    shapes=lm_shapes(CONFIG), source="arXiv:2407.21783",
))
