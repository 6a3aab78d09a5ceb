"""Optimizers (``repro.train.optimizer``): AdamW with a chosen moment
dtype, Adafactor (factored second moment) and Adagrad (the recsys
archs' embedding tables).

Each works on trees shaped like ``repro``'s pytrees (``repro_torch.tree``:
nested dicts and lists of tensors, e.g. ``Params.tree()``), and its state
is a NamedTuple of such trees with ``repro``'s fields, so a checkpoint
(``train.checkpoint``) writes ``repro``'s keys.  The math is ``repro``'s,
in f32, each result cast back to its leaf's dtype; the bias corrections
``1 - b ** t`` are f32 tensors on the device, as ``repro`` takes them from
the f32 step.  Unlike ``repro``'s, an update works in place under
``torch.no_grad()``: the parameter, moment and accumulator tensors given
are overwritten, and the same trees come back (with a new ``step``).

A leaf of rank >= 3 over ``_CHUNK_BYTES`` as f32 (the LMs' stacked
[n_blocks, ...] leaves) is updated one slice of dim 0 at a time
(``_chunked``), as ``repro`` ``lax.map``s it: the f32 temporaries of the
update then cover one block, not the whole stack (Qwen3-4B's FFN leaves
are [36, 2560, 9728]: 3.6 GB a temporary whole, 100 MB a slice).
Elementwise updates come out bit-equal either way; Adafactor's update
RMS is taken per slice, as ``repro``'s is.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


# Leaves bigger than this, as f32, are updated slice by slice over dim 0.
_CHUNK_BYTES = 128 * 1024 * 1024


def _chunked(upd, *leaves) -> None:
    """Apply the in-place ``upd`` to ``leaves`` (the parameter last),
    slice by slice over dim 0 for huge stacked leaves."""
    p = leaves[-1]
    if p.dim() >= 3 and p.numel() * 4 > _CHUNK_BYTES and all(
            leaf.dim() >= 1 and leaf.shape[:1] == p.shape[:1]
            for leaf in leaves):
        for i in range(p.shape[0]):
            upd(*(leaf[i] for leaf in leaves))
    else:
        upd(*leaves)


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def adamw_init(params, moment_dtype=torch.float32) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr=1e-3, b1=0.9,
                 b2=0.999, eps=1e-8, weight_decay=0.01):
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t

    def upd(g, m, v, p):
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        del gf
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        m.copy_(m_new)
        v.copy_(v_new)
        del m_new, v_new
        pf = p.float()
        p.copy_(pf - lr * (delta + weight_decay * pf))

    tree_map(lambda g, m, v, p: _chunked(upd, g, m, v, p),
             grads, state.m, state.v, params)
    return params, AdamWState(step=step, m=state.m, v=state.v)


class AdafactorState(NamedTuple):
    """Factored second moment (Shazeer & Stern, arXiv:1804.04235) and a
    low-precision momentum."""

    step: torch.Tensor
    vr: Any      # row factors  (mean over the last dim)
    vc: Any      # col factors  (mean over the second-to-last dim)
    v: Any       # full second moment of rank < 2 leaves
    m: Any       # momentum


def _factored(p) -> bool:
    return p.dim() >= 2


def adafactor_init(params, momentum_dtype=torch.bfloat16) -> AdafactorState:
    def zeros(shape, p, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=p.device)

    def vr(p):
        return zeros(p.shape[:-1] if _factored(p) else (1,), p)

    def vc(p):
        return zeros(p.shape[:-2] + p.shape[-1:] if _factored(p) else (1,),
                     p)

    def v(p):
        return zeros((1,) if _factored(p) else p.shape, p)

    return AdafactorState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        vr=tree_map(vr, params), vc=tree_map(vc, params),
        v=tree_map(v, params),
        m=tree_map(lambda p: zeros(p.shape, p, momentum_dtype), params))


@torch.no_grad()
def adafactor_update(grads, state: AdafactorState, params, *, lr=1e-3,
                     decay=0.999, beta1=0.9, eps=1e-30, clip_rms=1.0):
    step = state.step + 1

    def clipped_step(u, m, p):
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp_min(rms / clip_rms, 1.0)
        m_n = beta1 * m.float() + (1 - beta1) * u
        p.copy_(p.float() - lr * m_n)
        m.copy_(m_n)

    def upd_factored(g, vr, vc, m, p):
        gf = g.float()
        g2 = gf * gf + eps
        vr_n = decay * vr + (1 - decay) * torch.mean(g2, dim=-1)
        vc_n = decay * vc + (1 - decay) * torch.mean(g2, dim=-2)
        del g2
        denom = torch.clamp_min(torch.mean(vr_n, dim=-1, keepdim=True), eps)
        vhat = (vr_n[..., None] * vc_n[..., None, :]) / denom[..., None]
        vr.copy_(vr_n)
        vc.copy_(vc_n)
        clipped_step(gf / torch.sqrt(vhat + eps), m, p)

    def upd(g, vr, vc, v, m, p):
        if _factored(p):
            _chunked(upd_factored, g, vr, vc, m, p)
            return
        gf = g.float()
        v_n = decay * v + (1 - decay) * (gf * gf + eps)
        v.copy_(v_n)
        clipped_step(gf / torch.sqrt(v_n + eps), m, p)

    tree_map(upd, grads, state.vr, state.vc, state.v, state.m, params)
    return params, AdafactorState(step=step, vr=state.vr, vc=state.vc,
                                  v=state.v, m=state.m)


class AdagradState(NamedTuple):
    accum: Any


def adagrad_init(params) -> AdagradState:
    return AdagradState(accum=tree_map(
        lambda p: torch.full(p.shape, 0.1, dtype=torch.float32,
                             device=p.device), params))


@torch.no_grad()
def adagrad_update(grads, state: AdagradState, params, *, lr=1e-2,
                   eps=1e-10):
    def upd(g, a, p):
        gf = g.float()
        a_new = a + gf * gf
        p.copy_(p.float() - lr * gf / (torch.sqrt(a_new) + eps))
        a.copy_(a_new)

    tree_map(upd, grads, state.accum, params)
    return params, state
