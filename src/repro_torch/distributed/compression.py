"""int8 gradient compression with error feedback
(``repro.distributed.compression``).

Each block of ``BLOCK`` values of the flattened tensor (zero-padded to
whole blocks) is sent as int8 codes and one f32 scale, its absolute max
over 127 (at least 1e-12); codes are rounded to nearest, ties to even,
and clipped to +-127, as ``jnp.round`` and ``jnp.clip`` give them.
Error feedback keeps what the codes could not carry and adds it to the
next step's gradient:

    c = compress(g + err)          # what can be sent
    g_hat = decompress(c, shape)   # what a compressed all-reduce moves
    err = (g + err) - g_hat        # kept for the next step

``ef_step`` does one such round over a tree of gradients.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..tree import tree_map

BLOCK = 256


class Compressed(NamedTuple):
    q: torch.Tensor       # int8 codes, flat, padded to whole blocks
    scale: torch.Tensor   # f32 scale of each block
    n: int                # the true element count


def compress(x: torch.Tensor) -> Compressed:
    flat = x.float().reshape(-1)
    n = flat.numel()
    flat = F.pad(flat, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    scale = torch.clamp_min(flat.abs().amax(dim=1) / 127.0, 1e-12)
    q = torch.clamp(torch.round(flat / scale[:, None]), -127, 127)
    return Compressed(q=q.to(torch.int8).reshape(-1), scale=scale, n=n)


def decompress(c: Compressed, shape, dtype=torch.float32) -> torch.Tensor:
    deq = (c.q.reshape(-1, BLOCK).float() * c.scale[:, None]).reshape(-1)
    return deq[:c.n].reshape(shape).to(dtype)


def compressed_ratio(shape, dtype=torch.float32) -> float:
    """bytes(compressed) / bytes(raw), for reporting."""
    n = math.prod(shape)
    nb = -(-n // BLOCK)
    raw = n * torch.empty((), dtype=dtype).element_size()
    return (n + 4 * nb) / raw


def ef_step(grads, err):
    """One error-feedback round over a tree: ``(g_hat, new_err)``, each a
    tree of ``grads``' structure; ``g_hat`` is what a compressed
    all-reduce carries, in each gradient's dtype."""
    out = tree_map(_ef_leaf, grads, err)
    g_hat = tree_map(lambda _, o: o[0], grads, out)
    new_err = tree_map(lambda _, o: o[1], grads, out)
    return g_hat, new_err


def _ef_leaf(g, e):
    tot = g.float() + e
    g_hat = decompress(compress(tot), g.shape)
    return g_hat.to(g.dtype), tot - g_hat


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
