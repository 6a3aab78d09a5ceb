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

On a rank of a tensor-parallel mesh (``ax``, ``distributed.spmd.Axes``)
``params`` are the rank's shards of ``attention_specs``' layout: q/k/v
columns (heads) and the output projection's rows over "model", its
products summed (Megatron-LM's layout, which GSPMD derives from the same
specs).  Where the heads do not split evenly the rank gathers what it
needs (``heads_layout``): "local" (both q and kv heads split),
"kv_gathered" (kv heads gathered, each rank keeping those its q heads
read), "replicated" (q, k and v gathered, every head computed, the
output's local columns kept).
"""
from __future__ import annotations

import torch

from ..distributed import spmd
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


def heads_layout(cfg, m: int) -> str:
    """How a rank of ``m`` on "model" holds the heads: "local",
    "kv_gathered" or "replicated" (see the module's docstring)."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if H % m == 0:
        if Hkv % m == 0:
            return "local"
        hl, g = H // m, H // Hkv
        if g % hl == 0 or hl % g == 0:
            return "kv_gathered"
    return "replicated"


def _heads(t, B, S, Dh):
    return t.reshape(B, S, t.shape[-1] // Dh, Dh)


def attention_fwd(
    params, cfg, x: torch.Tensor,
    *,
    positions: torch.Tensor,         # [S] absolute positions of x's tokens
    cache: tuple | None = None,      # (k_cache, v_cache) [B, Hkv, Smax, Dh]
    cache_pos: int = 0,              # write offset into the cache
    causal: bool = True,
    attn_chunk: int = 1024,
    ax: spmd.Axes = spmd.ONE_RANK,
    prompt_kv: bool = False,
):
    """``params``: a mapping with ``wq``, ``wk``, ``wv``, ``wo`` (and
    ``q_norm``/``k_norm`` mappings with ``scale`` under qk-norm).  Returns
    ``(out [B, S, d], cache)``; the cache, when given, is written in
    place and returned.  With ``prompt_kv`` (a prompt pass, no cache
    given) the second item is the prompt's ``(k, v)`` [B, Hkv, S, Dh],
    every kv head, for the caller's cache, and attention runs as through
    a cache of the prompt's length (``kv_len = S``)."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    mode = heads_layout(cfg, ax.m)
    x = spmd.enter(x, ax.model)
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if mode == "replicated":
        q = spmd.gather(q, -1, ax.model)
    if mode != "local":
        k = spmd.gather(k, -1, ax.model)
        v = spmd.gather(v, -1, ax.model)
    q, k, v = _heads(q, B, S, Dh), _heads(k, B, S, Dh), _heads(v, B, S, Dh)
    if cfg.qk_norm:
        # replicated scales over the rank's heads: their gradients are
        # each rank's part
        q = layers.rms_norm(q, spmd.enter(params["q_norm"]["scale"],
                                          ax.model)).to(q.dtype)
        k = layers.rms_norm(k, spmd.enter(params["k_norm"]["scale"],
                                          ax.model)).to(k.dtype)
    q = layers.apply_rope(q.transpose(1, 2), positions,
                          cfg.rope_base).contiguous()
    k = layers.apply_rope(k.transpose(1, 2), positions, cfg.rope_base)
    v = v.transpose(1, 2)
    kw = dict(causal=causal, chunk=attn_chunk)

    if cache is not None:
        kc, vc = cache
        start = max(0, min(cache_pos, kc.shape[2] - S))
        kc[:, :, start:start + S] = k
        vc[:, :, start:start + S] = v
        out = flash_ops.attention(q, kc, vc, q_offset=cache_pos,
                                  kv_len=cache_pos + S, **kw)
    else:
        if prompt_kv:
            cache = (spmd.gather_nograd(k, 1, ax.model),
                     spmd.gather_nograd(v, 1, ax.model)) \
                if mode == "local" else (k, v)
            kw["kv_len"] = S
        if mode == "kv_gathered":
            hl, g = H // ax.m, H // Hkv
            lo, hi = ax.r * hl // g, ((ax.r + 1) * hl - 1) // g + 1
            k, v = k[:, lo:hi], v[:, lo:hi]
        out = flash_ops.attention(q, k.contiguous(), v.contiguous(),
                                  q_offset=0, **kw)
    out = out.transpose(1, 2).reshape(B, S, out.shape[1] * Dh)
    if mode == "replicated":
        cols = H * Dh // ax.m
        out = out[..., ax.r * cols:(ax.r + 1) * cols]
    return spmd.leave(out @ params["wo"], ax.model), cache
