"""Plain PyTorch versions of blocked GQA attention (``csrc/flash.cu``).

* ``mha_ref``: ``repro.kernels.flash.ref.mha_ref``, the dense oracle
  (the whole [Sq, Skv] score matrix, one softmax).
* ``chunked_attention``: ``repro.models.attention.chunked_attention``,
  the flash kernel's plain version.  The KV sequence is scanned in chunks
  with a running max, normaliser and accumulator, so the [Sq, Skv] score
  matrix never exists beyond one chunk.  It follows the reference step
  for step: the fully-masked-row guard (such a row comes out 0), the
  correction of the running sums, and the final ``max(l, 1e-30)``
  divide.  It is not ``scaled_dot_product_attention``: that is another
  algorithm.
* ``split_kv_attention``: the split-KV decode variant's arithmetic.  The
  keys are cut into splits; each split's softmax partial ``(m, l, acc)``
  is taken on its own, in f32, and the partials merge by log-sum-exp.
"""
from __future__ import annotations

import torch


def mha_ref(
    q: torch.Tensor,        # [B, Hq, Sq, Dh]
    k: torch.Tensor,        # [B, Hkv, Skv, Dh]
    v: torch.Tensor,        # [B, Hkv, Skv, Dh]
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Softmax attention with GQA head sharing (kv head = q head // group).

    ``q_offset`` positions the query block inside the kv sequence
    (decode: Sq = 1, q_offset = cache_len - 1); causal masking uses
    absolute positions."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kq = k.repeat_interleave(group, dim=1)
    vq = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kq) * Dh ** -0.5
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Skv, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq)


def chunked_attention(
    q: torch.Tensor,        # [B, Hq, Sq, Dh]
    k: torch.Tensor,        # [B, Hkv, Skv, Dh]
    v: torch.Tensor,        # [B, Hkv, Skv, Dh]
    *,
    causal: bool,
    q_offset=0,             # int or 0-d tensor: position of q's first row
    kv_len=None,            # int or 0-d tensor: valid cache length
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention, scanning KV in chunks; [B, Hq, Sq, Dh]."""
    B, Hq, Sq, Dh = q.shape
    _, Hkv, Skv, _ = k.shape
    group = Hq // Hkv
    scale = Dh ** -0.5
    chunk = min(chunk, Skv)
    if Skv % chunk:
        raise ValueError(f"{Skv} keys do not split into chunks of {chunk}")

    qg = q.reshape(B, Hkv, group, Sq, Dh)       # q heads folded on kv heads
    qpos = torch.arange(Sq, device=q.device) + q_offset
    acc = torch.zeros(B, Hkv, group, Sq, Dh, dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, Hkv, group, Sq), float("-inf"), device=q.device)
    l = torch.zeros(B, Hkv, group, Sq, device=q.device)
    for j in range(Skv // chunk):
        kj = k[:, :, j * chunk:(j + 1) * chunk]
        vj = v[:, :, j * chunk:(j + 1) * chunk]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kj) * scale
        kpos = j * chunk + torch.arange(chunk, device=q.device)
        mask = torch.ones(Sq, chunk, dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if kv_len is not None:
            mask &= kpos[None, :] < kv_len
        s = torch.where(mask, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = corr * l + p.sum(dim=-1)
        acc = corr[..., None] * acc + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(vj.dtype), vj).float()
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, Hq, Sq, Dh).to(q.dtype)


def split_kv_attention(
    q: torch.Tensor,        # [B, Hq, Sq, Dh]
    k: torch.Tensor,        # [B, Hkv, Skv, Dh]
    v: torch.Tensor,        # [B, Hkv, Skv, Dh]
    *,
    causal: bool,
    q_offset: int = 0,
    kv_len: int | None = None,
    split: int,             # keys per split
) -> torch.Tensor:
    """What ``chunked_attention`` computes, taken as the split-KV kernel
    takes it: split ``s`` holds keys ``[s * split, (s + 1) * split)`` and
    gives the partial ``m`` (its rows' max score), ``l`` (the sum of
    ``exp(score - m)``) and ``acc`` (those weights times v), all f32; a
    split with no valid key for a row gives ``m = -inf, l = 0, acc = 0``.
    The merge weighs split ``s`` by ``exp(m_s - M)``, ``M`` the max over
    splits (0 where ``m_s = -inf``), and divides by ``max(L, 1e-30)``: a
    row with no valid key anywhere comes out 0."""
    B, Hq, Sq, Dh = q.shape
    _, Hkv, Skv, _ = k.shape
    group = Hq // Hkv
    kv = Skv if kv_len is None else min(int(kv_len), Skv)
    qg = q.float().reshape(B, Hkv, group, Sq, Dh)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    ms, ls, accs = [], [], []
    for k0 in range(0, Skv, split):
        kj = k[:, :, k0:k0 + split].float()
        vj = v[:, :, k0:k0 + split].float()
        kpos = k0 + torch.arange(kj.shape[2], device=q.device)
        mask = (kpos[None, :] < kv).expand(Sq, -1)
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kj) * Dh ** -0.5
        s = torch.where(mask, s, float("-inf"))
        m = s.amax(dim=-1)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhgqk,bhkd->bhgqd", p, vj))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    M = m.amax(dim=0)
    M_safe = torch.where(torch.isfinite(M), M, 0.0)
    w = torch.where(torch.isfinite(m), torch.exp(m - M_safe), 0.0)
    out = (w[..., None] * acc).sum(dim=0) / torch.clamp_min(
        (w * l).sum(dim=0)[..., None], 1e-30)
    return out.reshape(B, Hq, Sq, Dh).to(q.dtype)
