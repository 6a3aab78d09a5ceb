"""GQA attention with RoPE, optional qk-norm and a KV cache
(``repro.models.attention``).

Attention itself goes through ``kernels.flash.ops.attention``: the flash
kernel (``csrc/flash.cu``) for CUDA tensors, ``chunked_attention`` (the
kernel's plain version, in ``kernels/flash/ref.py`` and re-exported here)
for CPU tensors.  This is the split ``repro``'s module names: the Pallas
kernel is the TPU target of the same semantics, ``chunked_attention`` the
XLA-level equivalent that its CPU lowers.

The KV cache is laid out [B, Hkv, S_max, Dh] per layer; a step writes its
S positions at ``cache_pos`` and attends to the first ``cache_pos + S``.
The write start clamps as ``repro``'s ``dynamic_update_slice`` clamps it,
to ``[0, S_max - S]``: past the cache's end the new K/V overwrite its last
S slots.  Unlike ``repro``'s, the write is a slice assignment *in place*:
the cache tensors handed in are the ones returned.
"""
from __future__ import annotations

import torch

from ..distributed.sharding import P
from ..kernels.flash import ops as flash_ops
from ..kernels.flash.ref import chunked_attention  # noqa: F401
from . import layers


def init_attention(gen: torch.Generator, cfg,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """cfg needs: d_model, n_heads, n_kv_heads, d_head, qk_norm."""
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {"wq": layers.dense_init(gen, d, H * Dh, dtype),
         "wk": layers.dense_init(gen, d, Hkv * Dh, dtype),
         "wv": layers.dense_init(gen, d, Hkv * Dh, dtype),
         "wo": layers.dense_init(gen, H * Dh, d, dtype)}
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rms_norm(Dh, gen.device)
        p["k_norm"] = layers.init_rms_norm(Dh, gen.device)
    return p


def attention_specs(cfg) -> dict:
    """Tensor-parallel specs: q/k/v columns and out-projection rows over
    "model"."""
    p = {"wq": P(None, "model"), "wk": P(None, "model"),
         "wv": P(None, "model"), "wo": P("model", None)}
    if cfg.qk_norm:
        p["q_norm"] = layers.rms_norm_specs()
        p["k_norm"] = layers.rms_norm_specs()
    return p


def attention_fwd(
    params, cfg, x: torch.Tensor,
    *,
    positions: torch.Tensor,         # [S] absolute positions of x's tokens
    cache: tuple | None = None,      # (k_cache, v_cache) [B, Hkv, Smax, Dh]
    cache_pos: int = 0,              # write offset into the cache
    causal: bool = True,
    attn_chunk: int = 1024,
):
    """``params``: a mapping with ``wq``, ``wk``, ``wv``, ``wo`` (and
    ``q_norm``/``k_norm`` mappings with ``scale`` under qk-norm).  Returns
    ``(out [B, S, d], cache)``; the cache, when given, is written in
    place and returned."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    q = (x @ params["wq"]).reshape(B, S, H, Dh)
    k = (x @ params["wk"]).reshape(B, S, Hkv, Dh)
    v = (x @ params["wv"]).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"]["scale"]).to(q.dtype)
        k = layers.rms_norm(k, params["k_norm"]["scale"]).to(k.dtype)
    q = layers.apply_rope(q.transpose(1, 2), positions,
                          cfg.rope_base).contiguous()
    k = layers.apply_rope(k.transpose(1, 2), positions, cfg.rope_base)
    v = v.transpose(1, 2)

    if cache is None:
        out = flash_ops.attention(q, k.contiguous(), v.contiguous(),
                                  causal=causal, q_offset=0,
                                  chunk=attn_chunk)
    else:
        kc, vc = cache
        start = max(0, min(cache_pos, kc.shape[2] - S))
        kc[:, :, start:start + S] = k
        vc[:, :, start:start + S] = v
        out = flash_ops.attention(q, kc, vc, causal=causal,
                                  q_offset=cache_pos, kv_len=cache_pos + S,
                                  chunk=attn_chunk)
    out = out.transpose(1, 2).reshape(B, S, H * Dh)
    return out @ params["wo"], cache
