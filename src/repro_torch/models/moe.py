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

On a rank of a tensor-parallel mesh (``ax``, ``distributed.spmd.Axes``;
``repro``'s expert-parallel layout, as GSPMD makes it of ``moe_specs``):
tokens are replicated over "model" and each rank holds E / model experts
(their d_ff split over "data" in the training layout, gathered where
used) and fills only their capacity slots; the queue positions run over
the whole (micro)batch of ``rows`` rows, as in ``repro`` (the routings
gathered over the batch axes), and the dispatch buffer is summed over
them; the outputs are summed over "model".  C, ``keep`` and the slot
order are those of one rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed import spmd
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


def _expert_weights(we, cfg, ax):
    """The rank's experts' weights with their d_ff whole (gathered over
    "data" where the training layout splits it)."""
    gate, up, down = we["gate"], we["up"], we["down"]
    if gate.shape[-1] != cfg.d_ff_expert:
        gate = spmd.gather(gate, -1, ax.data)
        up = spmd.gather(up, -1, ax.data)
        down = spmd.gather(down, -2, ax.data)
    return gate, up, down


def moe_fwd(params, cfg, x: torch.Tensor, ax: spmd.Axes = spmd.ONE_RANK,
            rows: int | None = None):
    """x: [B, S, d] -> ([B, S, d], aux loss, an f32 scalar).  ``params``:
    a mapping with ``router``, ``experts`` (``gate``, ``up``, ``down``)
    and, with shared experts, ``shared``.  On a rank of ``ax``, ``x`` is
    its rows of a (micro)batch of ``rows`` rows (default ``B``)."""
    B, S, d = x.shape
    T = B * S
    rows = B if rows is None else rows
    T_all = rows * S
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
    me = spmd.psum(probs.sum(dim=0), ax.batch) / T_all
    flat_e = gate_idx.reshape(T * k)                            # [T*k]
    ce = spmd.psum(torch.zeros(E, dtype=torch.float32,
                               device=x.device).index_add_(
        0, flat_e, torch.full((T * k,), 1.0 / (T_all * k),
                              device=x.device)), ax.batch)
    aux = E * torch.sum(me * ce)

    C = capacity(T_all, k, E, cfg.capacity_factor)

    # queue position of each (token, choice) within its expert: the
    # one-hot laid out [E, T*k], so that the scan runs along the inner
    # dim; over the batch ranks' choices in row order, each rank's padded
    # to the most a rank holds with E, an expert none matches
    all_e, n = flat_e, T * k
    if ax.nb > 1:
        n = spmd.most_rows(rows, ax) * S * k
        all_e = spmd.gather_nograd(torch.cat([flat_e, flat_e.new_full(
            (n - T * k,), E)]), 0, ax.batch)
    onehot = (all_e[None, :] == torch.arange(E, device=x.device)[:, None]
              ).int()
    pos = torch.cumsum(onehot, dim=1).gather(
        0, all_e.clamp(max=E - 1)[None, :])[0] - 1
    pos = pos[ax.rb * n:ax.rb * n + T * k]
    keep = pos < C                                              # [T*k]
    slot = flat_e * C + torch.clamp(pos, max=C - 1)             # [T*k]
    El = E // ax.m
    if ax.m > 1:
        # this rank's experts' slots alone
        e0 = ax.r * El
        mine = (flat_e >= e0) & (flat_e < e0 + El)
        keep = keep & mine
        slot = torch.where(mine, slot - e0 * C, 0)
    keep = keep.to(xt.dtype)

    xin = spmd.enter(xt, ax.model)
    x_rep = xin.repeat_interleave(k, dim=0)                     # [T*k, d]
    buf = torch.zeros((El * C, d), dtype=xt.dtype, device=x.device).index_add(
        0, slot, x_rep * keep[:, None])
    ex_in = spmd.psum(buf, ax.batch).reshape(El, C, d)

    gate, up, down = _expert_weights(params["experts"], cfg, ax)
    h = F.silu(torch.bmm(ex_in, gate)) * torch.bmm(ex_in, up)
    ex_out = torch.bmm(h, down).reshape(El * C, d)

    gates = spmd.enter(gate_vals, ax.model)
    back = ex_out[slot]                                         # [T*k, d]
    back = back * (keep * gates.reshape(T * k).to(xt.dtype))[:, None]
    out = back.reshape(T, k, d).sum(dim=1)

    if cfg.n_shared > 0:
        out = out + layers.swiglu(params["shared"], xin)
    return spmd.leave(out, ax.model).reshape(B, S, d), aux
