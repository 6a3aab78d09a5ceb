"""qwen3-4b [hf:Qwen/Qwen3-4B; hf] (``repro.configs.qwen3_4b``).

36L d_model=2560 32H (GQA kv=8, head_dim=128 decoupled from d_model)
d_ff=9728 vocab=151936, qk-norm on.
"""
import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_shapes, register

CONFIG = LMConfig(
    name="qwen3-4b",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=9728, vocab=151936, qk_norm=True,
    dtype=torch.bfloat16, attn_chunk=2048, microbatches=8,
)

SPEC = register(ArchSpec(
    arch_id="qwen3-4b", family="lm", cfg=CONFIG,
    shapes=lm_shapes(CONFIG), source="hf:Qwen/Qwen3-4B",
))
