"""Distributed LM decode: tensor-parallel projections and flash-decoding
attention over a sequence-sharded KV cache
(``repro.distributed.decode_shard``).

``repro`` writes this step against explicit per-shard collectives under
``shard_map``; here each rank runs it in a process of its own, on the
named axes of a ``launch.mesh.Mesh``: ``mesh.col(axes)`` gives the
collectives over one axis or a tuple of axes, ``mesh.axis_index(axes)``
this rank's row-major index over them (a host int).

Layout (one step, one token a sequence):
  activations x        [B_loc, d]      replicated over "model"
  wq/wk/wv             columns split over "model" (TP)
  q/k/v                all-gathered over "model" on dim 1 (B x H x Dh)
  KV cache             [nb, bl, B_loc, Hkv, S_loc, Dh], S split over the
                       sequence axes
  attention            a partial online softmax (m, l, acc) over this
                       rank's S_loc slots, gathered over the sequence
                       axes and merged (flash decoding)
  wo / FFN down        rows split -> partial product -> psum over "model"
  MoE experts          E split over "model"; every local expert runs on
                       every token, weighted by its routing indicator
                       (dropless: unlike ``models.moe.moe_fwd``'s
                       capacity dispatch, which at a decode batch keeps
                       one slot an expert)
  lm_head              columns split -> logits stay vocab-sharded

The three layouts of ``build_decode_step`` are ``repro``'s, chosen by the
same rules.  The attention is ``repro``'s ``einsum`` and merge, outside
any kernel (``torch.matmul`` here): it reads every one of a rank's
``S_loc`` slots and masks those past ``pos``.  int8 KV: codes with an
f32 scale a (token, head), the scores and probabilities rescaled per
slot; the cache is never dequantized in place (the step upcasts its
local slice to compute, as ``repro``'s ``astype`` does).

``pos`` is a host int, as in ``models.transformer.lm_decode_step``; only
the rank whose slice holds ``pos`` writes its cache (in place), and a
``pos`` past the cache's end is written by none.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..launch.mesh import all_axes, batch_axes
from ..models import layers
from ..models.transformer import LMConfig, lm_specs
from .sharding import P, map_specs, shard


def decode_param_specs(cfg: LMConfig) -> dict:
    """The training specs with their ZeRO ("data") entries stripped:
    serving replicas hold whole (model-split) weights."""
    def strip(tree):
        if isinstance(tree, P):
            return P(*[None if e == "data" else e for e in tree])
        return {k: strip(v) for k, v in tree.items()}

    return strip(lm_specs(cfg))


def lm_specs_fshard(cfg: LMConfig) -> dict:
    """Serving layout for weights too large for "model" alone: the expert
    d_ff also splits over "data", as in training."""
    specs = lm_specs(cfg)
    for block in specs["blocks"].values():
        if "moe" in block:
            e = block["moe"]["experts"]
            e["gate"] = P(None, "model", None, "data")
            e["up"] = P(None, "model", None, "data")
            e["down"] = P(None, "model", "data", None)
    return specs


def fsharded(cfg: LMConfig, tp: int) -> bool:
    """``repro``'s rule for the f-sharded layout (decode, and the prefill
    cell): the bf16 weights over ``tp`` "model" ranks past 8e9 bytes a
    rank, the size it was set for on a 16 GiB chip."""
    return cfg.param_count() * 2 / tp > 8e9


def cache_spec(ba) -> P:
    return P(None, None, ba or None, None, "model", None)


def quantize(a: torch.Tensor):
    """int8 codes of ``a`` with one f32 scale over its last dim:
    ``max(max|a| / 127, 1e-8)``, codes rounded half to even and clipped
    to +-127.  The division by 127 is a product with its f32 reciprocal,
    as XLA compiles ``repro``'s division by the constant (a true division
    parts from it in the last bit of ~4% of scales)."""
    a = a.float()
    sc = torch.clamp(a.abs().amax(-1) * (1.0 / 127.0), min=1e-8)
    q = torch.clamp(torch.round(a / sc[..., None]), -127, 127)
    return q.to(torch.int8), sc


def _psum_lookup(table_loc, ids, lo: int, col):
    """Row lookup from a dim-0-split table: this rank's rows, zeros for
    ids it does not hold, summed over ``col``."""
    v_loc = table_loc.shape[0]
    local = ids.long() - lo
    ok = (local >= 0) & (local < v_loc)
    rows = table_loc[local.clamp(0, v_loc - 1)]
    return col.psum(rows.masked_fill(~ok[..., None], 0))


def _route(z, router, k: int):
    """Top-``k`` experts of each token and their gates (softmax, then the
    ``k`` largest, renormalised), the router in f32."""
    probs = torch.softmax(z.float() @ router, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1, sorted=True)
    return gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9), idx


def _flash_decode_attn(q, k_loc, v_loc, pos: int, s_lo: int, col,
                       k_scale=None, v_scale=None):
    """q [B, H, Dh]; k/v_loc [B, Hkv, S_loc, Dh], this rank's slots
    (int8 with ``k/v_scale`` [B, Hkv, S_loc]).  Returns the attention
    output [B, H, Dh] merged over ``col``'s ranks (replicated)."""
    B, H, Dh = q.shape
    Hkv, S_loc = k_loc.shape[1], k_loc.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, Dh)
    s = torch.matmul(qg, k_loc.to(qg.dtype).transpose(-1, -2)) * Dh ** -0.5
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    valid = s_lo + torch.arange(S_loc, device=q.device) <= pos
    s = torch.where(valid, s.float(), float("-inf"))
    m = s.amax(-1)                                           # [B, Hkv, g]
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(valid, torch.exp(s - m_safe[..., None]), 0.0)
    l = p.sum(-1)
    if v_scale is not None:
        pv = (p * v_scale[:, :, None, :]).float()
        acc = torch.matmul(pv, v_loc.float())
    else:
        acc = torch.matmul(p.to(v_loc.dtype), v_loc).float()

    # flash-decoding merge across the sequence shards
    m_all = col.all_gather(m, tiled=False)                   # [W, B, Hkv, g]
    l_all = col.all_gather(l, tiled=False)
    acc_all = col.all_gather(acc, tiled=False)               # [W, ..., Dh]
    w = torch.exp(m_all - m_all.amax(0)[None])
    l_star = (l_all * w).sum(0)
    out = (acc_all * w[..., None]).sum(0) / torch.clamp(l_star[..., None],
                                                        min=1e-30)
    return out.reshape(B, H, Dh)


def _unstack(blocks: dict, n: int) -> list[dict]:
    """Stacked [n, ...] leaves -> ``n`` trees of views, one a block."""
    def views(tree):
        if isinstance(tree, dict):
            kids = {k: views(v) for k, v in tree.items()}
            return [{k: kids[k][b] for k in kids} for b in range(n)]
        return tree.unbind(0)

    return views(blocks)


class DecodeStep(NamedTuple):
    """This rank's decode step and the cuts of the full inputs to its
    pieces.

    ``step(params, token, caches, pos) -> (logits [B_loc, V / tp],
    caches)``: ``params`` from ``shard_params``, ``token`` [B_loc] from
    ``shard_token``, ``caches`` ``(k, v)`` or, with ``kv_quant``, ``(k,
    v, k_scale, v_scale)`` from ``shard_caches`` (written in place).
    The specs say how the full tensors split (``sharding.assemble`` puts
    the ranks' logits back together under ``logits_spec``)."""

    step: Callable
    shard_params: Callable
    shard_caches: Callable
    shard_token: Callable
    param_specs: dict
    cache_specs: tuple
    token_spec: P
    logits_spec: P
    fshard: bool
    seq_axes: tuple


def build_decode_step(mesh, cfg: LMConfig, batch: int, s_max: int,
                      kv_quant: bool = False, device=None) -> DecodeStep:
    """This rank's decode step on ``mesh`` (a ``launch.mesh.Mesh``) for a
    global ``batch`` against ``s_max`` cache slots, its pieces on
    ``device`` (default cuda; raises without a card unless
    ``device="cpu"``).

    Three layouts by shape and size, as ``repro``'s:
      * standard: batch over ("pod", "data"), cache sequence over
        "model", TP weights (model-split, ZeRO stripped);
      * tiny batch (``batch`` not divisible by the batch axes, as
        long_500k's B = 1): batch replicated, cache sequence over every
        axis, merged over the mesh;
      * f-sharded (2 x parameters / tp > 8e9): expert d_ff split over
        "data" as in training, batch over "pod" only, cache sequence over
        ("data", "model"); the MoE partial products psum over both.
    """
    dev = resolve_device(device)
    tp = mesh.shape["model"]
    fshard = fsharded(cfg, tp)
    if fshard:
        ba = ("pod",) if ("pod" in mesh.axis_names
                          and batch % mesh.shape["pod"] == 0) else ()
        seq_ax = ("data", "model")
        p_specs = lm_specs_fshard(cfg)
    else:
        ba = batch_axes(mesh)
        if batch % mesh.size(ba):
            ba = ()                                  # replicate the batch
            seq_ax = all_axes(mesh)                  # sequence over all
        else:
            seq_ax = ("model",)
        p_specs = decode_param_specs(cfg)
    n_seq = mesh.size(seq_ax)
    if s_max % n_seq:
        raise ValueError(f"{s_max} cache slots do not divide over {n_seq} "
                         f"sequence shards {seq_ax}")
    c_spec = P(None, None, ba or None, None, seq_ax, None)
    s_spec = P(None, None, ba or None, None, seq_ax)
    cache_specs = (c_spec, c_spec, s_spec, s_spec) if kv_quant \
        else (c_spec, c_spec)
    tok_spec = P(ba or None)
    out_spec = P(ba or None, "model")
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s_loc = s_max // n_seq
    moe_axes = ("data", "model") if fshard else ("model",)

    def step(params, token, caches, pos: int):
        col = mesh.col("model")
        seq_col = mesh.col(seq_ax)
        widx = mesh.axis_index("model")
        s_lo = mesh.axis_index(seq_ax) * s_loc
        x = _psum_lookup(params["embed"], token, widx * (cfg.vocab // tp),
                         col)                                # [B, d]
        posv = torch.full((1,), pos, device=x.device)
        rel = pos - s_lo
        own = 0 <= rel < s_loc

        def attn_block(p, x, kc, vc, ks, vs):
            z = layers.rms_norm(x, p["ln1"]["scale"]).to(x.dtype)
            a = p["attn"]
            # TP projections: local columns, heads gathered
            q = col.all_gather(z @ a["wq"], axis=1).reshape(-1, H, Dh)
            k = col.all_gather(z @ a["wk"], axis=1).reshape(-1, Hkv, Dh)
            v = col.all_gather(z @ a["wv"], axis=1).reshape(-1, Hkv, Dh)
            if cfg.qk_norm:
                q = layers.rms_norm(q, a["q_norm"]["scale"]).to(q.dtype)
                k = layers.rms_norm(k, a["k_norm"]["scale"]).to(k.dtype)
            # [B, H, Dh] -> [B, H, 1, Dh]: RoPE sees a length-1 sequence
            q = layers.apply_rope(q[:, :, None], posv, cfg.rope_base)[:, :, 0]
            k = layers.apply_rope(k[:, :, None], posv, cfg.rope_base)[:, :, 0]
            if own:          # only the owner of ``pos`` writes its slot
                if kv_quant:
                    k_w, ks_w = quantize(k)
                    v_w, vs_w = quantize(v)
                    ks[:, :, rel] = ks_w
                    vs[:, :, rel] = vs_w
                else:
                    k_w, v_w = k, v
                kc[:, :, rel] = k_w
                vc[:, :, rel] = v_w
            o = _flash_decode_attn(q, kc, vc, pos, s_lo, seq_col,
                                   k_scale=ks, v_scale=vs)
            o = o.to(x.dtype).reshape(x.shape[0], H * Dh)
            # TP out-projection: this rank's head rows, partial product
            rows = H * Dh // tp
            o_loc = o[:, widx * rows:(widx + 1) * rows]
            return x + col.psum(o_loc @ a["wo"])

        def mlp_block(p, x):
            z = layers.rms_norm(x, p["ln2"]["scale"]).to(x.dtype)
            if "moe" in p:
                return x + _moe_decode(p["moe"], z)
            f = p["ffn"]
            h = F.silu(z @ f["gate"]) * (z @ f["up"])
            return x + col.psum(h @ f["down"])

        def _moe_decode(mp, z):
            e_loc = cfg.n_experts // tp
            gate, idx = _route(z, mp["router"], cfg.top_k)
            we = mp["experts"]
            # a decode batch is tiny: every local expert on every token,
            # weighted by its routing indicator, summed over the shards
            h = F.silu(torch.matmul(z, we["gate"])) * torch.matmul(z, we["up"])
            out_e = torch.matmul(h, we["down"])              # [e_loc, B, d]
            ids = widx * e_loc + torch.arange(e_loc, device=z.device)
            w = torch.where(idx[None] == ids[:, None, None], gate[None],
                            0.0).sum(-1).to(z.dtype)         # [e_loc, B]
            out = mesh.col(moe_axes).psum((out_e * w[..., None]).sum(0))
            if cfg.n_shared > 0:
                sh = mp["shared"]
                hs = F.silu(z @ sh["gate"]) * (z @ sh["up"])
                out = out + col.psum(hs @ sh["down"])
            return out

        kc_all, vc_all = caches[0], caches[1]
        ks_all, vs_all = (caches[2], caches[3]) if kv_quant else (None, None)
        for b, block in enumerate(_unstack(params["blocks"], cfg.n_blocks)):
            for i in range(cfg.block_layers):
                lp = block[f"l{i}"]
                x = attn_block(lp, x, kc_all[b, i], vc_all[b, i],
                               None if ks_all is None else ks_all[b, i],
                               None if vs_all is None else vs_all[b, i])
                x = mlp_block(lp, x)
        x = layers.rms_norm(x, params["final_norm"]["scale"]).to(x.dtype)
        return x @ params["lm_head"], caches             # [B_loc, V / tp]

    def piece(spec, t):
        """This rank's piece of ``t`` on ``dev``: a view where it is the
        whole tensor on ``dev`` already, else a copy of its own."""
        t = t.detach()
        out = shard(t, spec, mesh)
        on_dev = out.device.type == dev.type and dev.index in (
            None, out.device.index)
        if out.numel() < t.numel() or not on_dev:
            out = out.to(dev, copy=True).contiguous()
        return out

    def shard_params(tree):
        return map_specs(piece, p_specs, tree)

    def shard_caches(caches):
        if len(caches) != len(cache_specs):
            raise ValueError(f"{len(caches)} cache tensors, expected "
                             f"{len(cache_specs)}")
        return tuple(piece(s, c) for s, c in zip(cache_specs, caches))

    def shard_token(token):
        return piece(tok_spec, token)

    return DecodeStep(step, shard_params, shard_caches, shard_token,
                      p_specs, cache_specs, tok_spec, out_spec, fshard,
                      seq_ax)
