"""Mixture-of-Experts FFN: capacity dispatch by scatter, plus shared
experts (``repro.models.moe``).

Covers both MoE archs:
  * llama4-maverick: 128 routed experts, top-1, 1 shared expert, MoE on
    alternating layers.
  * deepseek-moe-16b: 64 fine-grained routed experts, top-6, 2 shared
    experts, every layer (arXiv:2401.06066).

Dispatch, as ``repro``'s: each (token, choice) gets the slot
``expert * C + its position in that expert's queue``; tokens are
scatter-added into an ``[E * C, d]`` buffer (pairs past the capacity C
are dropped, Switch semantics: they add exact zeros), the three stacked
expert products run as batched matmuls on ``[E, C, d]``, and the results
are gathered back and weighted by their gates.  The capacity is
reckoned on the host from the token count with ``repro``'s expression
(Python's ``round``, half to even), so at a decode step of batch 8 it
is 1 and most routed pairs are dropped, as in ``repro``.  ``repro``
computes the expert products with ``einsum`` outside any Pallas kernel;
``torch.bmm`` is their counterpart here.  Gradients come from autograd
through the scatter and the gather.

A shared expert runs densely on every token (no routing).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import P
from . import layers


def init_moe(gen: torch.Generator, cfg,
             dtype: torch.dtype = torch.bfloat16) -> dict:
    """cfg: d_model, d_ff_expert, n_experts, n_shared.  The router is
    f32 [d, E]; the experts' ``gate``/``up`` [E, d, f] and ``down``
    [E, f, d] are drawn one expert at a time, as ``repro``'s ``vmap``
    over keys draws them (a whole f32 draw at llama4's width would be a
    21.5 GB temporary)."""
    d, f, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    p = {"router": layers.dense_init(gen, d, E, torch.float32)}
    experts = {}
    for name, (d_in, d_out) in (("gate", (d, f)), ("up", (d, f)),
                                ("down", (f, d))):
        w = torch.empty((E, d_in, d_out), dtype=dtype, device=gen.device)
        for e in range(E):
            w[e] = layers.dense_init(gen, d_in, d_out, dtype)
        experts[name] = w
    p["experts"] = experts
    if cfg.n_shared > 0:
        p["shared"] = layers.init_swiglu(gen, d, f * cfg.n_shared, dtype)
    return p


def moe_specs(cfg) -> dict:
    """Training layout: experts over "model" on the expert axis, ZeRO-3
    over "data" on d_ff."""
    p = {"router": P(),
         "experts": {"gate": P("model", None, "data"),
                     "up": P("model", None, "data"),
                     "down": P("model", "data", None)}}
    if cfg.n_shared > 0:
        p["shared"] = layers.swiglu_specs()
    return p


def capacity(T: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots an expert: ``repro``'s ``int(max(1, round(T k / E cf)))``."""
    return int(max(1, round(T * k / E * capacity_factor)))


def moe_fwd(params, cfg, x: torch.Tensor):
    """x: [B, S, d] -> ([B, S, d], aux loss, an f32 scalar).  ``params``:
    a mapping with ``router``, ``experts`` (``gate``, ``up``, ``down``)
    and, with shared experts, ``shared``."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)

    # the router in full f32: TF32 would round its logits and move choices
    torch.backends.cuda.matmul.allow_tf32 = False
    logits = xt.float() @ params["router"]                      # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch eq. 4)
    me = probs.mean(dim=0)
    flat_e = gate_idx.reshape(T * k)                            # [T*k]
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, flat_e, torch.full((T * k,), 1.0 / (T * k), device=x.device))
    aux = E * torch.sum(me * ce)

    C = capacity(T, k, E, cfg.capacity_factor)

    # queue position of each (token, choice) within its expert: the
    # one-hot laid out [E, T*k], so that the scan runs along the inner dim
    onehot = (flat_e[None, :] == torch.arange(E, device=x.device)[:, None]
              ).int()
    pos = torch.cumsum(onehot, dim=1).gather(0, flat_e[None, :])[0] - 1
    keep = (pos < C).to(xt.dtype)                               # [T*k]
    slot = flat_e * C + torch.clamp(pos, max=C - 1)             # [T*k]

    x_rep = xt.repeat_interleave(k, dim=0)                      # [T*k, d]
    buf = torch.zeros((E * C, d), dtype=xt.dtype, device=x.device).index_add(
        0, slot, x_rep * keep[:, None])
    ex_in = buf.reshape(E, C, d)

    we = params["experts"]
    h = F.silu(torch.bmm(ex_in, we["gate"])) * torch.bmm(ex_in, we["up"])
    ex_out = torch.bmm(h, we["down"]).reshape(E * C, d)

    back = ex_out[slot]                                         # [T*k, d]
    back = back * (keep * gate_vals.reshape(T * k).to(xt.dtype))[:, None]
    out = back.reshape(T, k, d).sum(dim=1)

    if cfg.n_shared > 0:
        out = out + layers.swiglu(params["shared"], xt)
    return out.reshape(B, S, d), aux
