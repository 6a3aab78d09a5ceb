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
"kv_gathered" (q heads split; kv heads gathered, each rank keeping those
its q heads read), "wq_gathered" (q heads straddle the ranks' columns:
the rank computes only the q heads its own columns of ``wq`` overlap,
``rank_heads``, with the columns of a straddling head fetched from the
neighbour that holds them (``_rank_wq``), and the kv heads those read;
the output's own columns kept).  So a rank computes at most
ceil(H / m) + 1 heads, and a head split across two ranks is computed on
both.
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
    "kv_gathered" or "wq_gathered" (see the module's docstring)."""
    if cfg.n_heads % m:
        return "wq_gathered"
    return "kv_gathered" if cfg.n_kv_heads % m else "local"


def rank_heads(cfg, m: int, r: int) -> tuple:
    """``((lo, hi), (klo, khi))``: the q heads ``[lo, hi)`` that rank
    ``r`` of ``m`` computes (those its ``H Dh / m`` columns of ``wq``
    overlap) and the kv heads ``[klo, khi)`` they read."""
    H, Dh = cfg.n_heads, cfg.d_head
    c = H * Dh // m
    lo, hi = r * c // Dh, -(-(r + 1) * c // Dh)
    g = H // cfg.n_kv_heads
    return (lo, hi), (lo // g, (hi - 1) // g + 1)


def _paired_kv(t, heads, g: int):
    """The kv heads of ``t`` [B, Hkv, S, Dh] that a rank's q heads read
    (``heads``, ``rank_heads``' pair), as the flash kernel pairs them
    (local q head ``j`` with kv head ``j // group``): a slice where the q
    heads read one kv head or cover whole groups, else one kv head for
    each q head."""
    (lo, hi), (klo, khi) = heads
    if khi - klo == 1 or (lo % g == 0 and hi % g == 0):
        return t[:, klo:khi]
    return t[:, torch.arange(lo, hi, device=t.device) // g]


def _rank_wq(wq, Dh: int, heads: tuple, ax: spmd.Axes):
    """The columns of ``wq`` for the q heads ``[lo, hi)`` (``heads``) that
    rank ``ax.r`` computes: its own ``c`` columns and, from each
    neighbour, its ``Dh`` columns next to them, of which those of the
    head the two ranks share are kept; every rank's columns where a head
    spans more than two ranks (``c < Dh``)."""
    (lo, hi), c = heads, wq.shape[-1]
    if c < Dh:
        return spmd.gather(wq, -1, ax.model)[:, lo * Dh:hi * Dh]
    left = spmd.shift(wq[:, c - Dh:], 1, ax.model)
    right = spmd.shift(wq[:, :Dh], -1, ax.model)
    start = ax.r * c - Dh
    return torch.cat([left, wq, right], -1)[:, lo * Dh - start:
                                               hi * Dh - start]


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
    H, Dh = cfg.n_heads, cfg.d_head
    mode = heads_layout(cfg, ax.m)
    heads = rank_heads(cfg, ax.m, ax.r)
    lo, hi = heads[0]
    x = spmd.enter(x, ax.model)
    wq = params["wq"]
    if mode == "wq_gathered":
        wq = _rank_wq(wq, Dh, heads[0], ax)
    q = x @ wq
    k = x @ params["wk"]
    v = x @ params["wv"]
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
        if mode != "local":
            g = H // cfg.n_kv_heads
            k, v = _paired_kv(k, heads, g), _paired_kv(v, heads, g)
        out = flash_ops.attention(q, k.contiguous(), v.contiguous(),
                                  q_offset=0, **kw)
    out = out.transpose(1, 2).reshape(B, S, out.shape[1] * Dh)
    if mode == "wq_gathered":
        c = H * Dh // ax.m
        out = out[..., ax.r * c - lo * Dh:(ax.r + 1) * c - lo * Dh]
    return spmd.leave(out @ params["wo"], ax.model), cache
