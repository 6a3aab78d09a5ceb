"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4; unverified]
(``repro.configs.llama4_maverick_400b_a17b``).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 routed
experts top-1 + 1 shared expert on alternating layers (Llama-4
interleaved MoE).  The modality frontend ("early fusion") is a stub, as
in ``repro``: ``input_specs`` provides token ids; patch embeddings would
enter the same embedding slot.
"""
import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_shapes, register

CONFIG = LMConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=202048,
    n_experts=128, top_k=1, n_shared=1, d_ff_expert=8192, moe_every=2,
    dtype=torch.bfloat16, attn_chunk=1024, microbatches=8,
)

SPEC = register(ArchSpec(
    arch_id="llama4-maverick-400b-a17b", family="lm", cfg=CONFIG,
    shapes=lm_shapes(CONFIG),
    source="hf:meta-llama/Llama-4-Scout-17B-16E (scaled per assignment)",
))
