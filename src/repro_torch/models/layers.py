"""Shared model layers (``repro.models.layers``): initialisers, the relu
MLP, layer norm, RMSNorm, rotary embeddings and SwiGLU, plus the
parameter-tree module the models are built from.  ``*_specs`` give a
layer's partition specs (``distributed.sharding.P``), as ``repro``'s.

Initialisers return plain tensors drawn from the caller's
``torch.Generator`` on that generator's device, from the same
distributions as the JAX package (not the same bits: parity goes through
``repro_torch.convert``).  A model's ``init_*`` builds a nested dict of
tensors shaped like the JAX parameter tree and wraps it in
:class:`Params`, so ``named_parameters()`` yields the JAX paths
(``cross.0.W``, ``blocks.ffn.1.b``), and ``tree()`` gives them back as
that tree.  Parameters start frozen (``requires_grad=False``), so
serving builds no autograd graph; training turns gradients on with the
module's own ``requires_grad_(True)``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..distributed.sharding import P


class Params(nn.Module):
    """A parameter tree as a module: dict keys become attribute names,
    lists ``nn.ModuleList``s, tensors frozen parameters."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            setattr(self, name, _node(value))

    def tree(self) -> dict:
        """The parameters as ``repro``'s tree: nested dicts (keys sorted,
        as a pytree flattens them) and lists of the ``nn.Parameter``s
        themselves, so that an update of a leaf is an update of the
        module."""
        return _tree(self)


def _node(value):
    if isinstance(value, dict):
        return Params(value)
    if isinstance(value, (list, tuple)):
        return nn.ModuleList(_node(v) for v in value)
    return nn.Parameter(value, requires_grad=False)


def _tree(module):
    if isinstance(module, nn.ModuleList):
        return [_tree(m) for m in module]
    kids = dict(module._parameters)
    kids.update({name: _tree(m) for name, m in module._modules.items()})
    return {name: kids[name] for name in sorted(kids)}


def tree_stack(trees: list):
    """Trees of one structure -> one tree whose leaves are stacked on a
    new leading axis (what ``jax.vmap`` of an init gives)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    """``repro``'s layer norm: statistics in f32, eps 1e-6 (not torch's
    1e-5 default), population variance."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def rms_norm(x, scale, eps: float = 1e-6):
    """``repro``'s RMSNorm: the mean square in f32, the normalised x cast
    back to x's dtype *before* the (f32) scale multiplies, so a bf16
    input comes back f32 and callers cast it again, as ``repro``'s do."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def init_rms_norm(d: int, device) -> dict:
    return {"scale": torch.ones(d, device=device)}


def rms_norm_specs() -> dict:
    return {"scale": P()}


def layer_norm_specs() -> dict:
    return {"scale": P(), "bias": P()}


def init_layer_norm(d: int, device) -> dict:
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[d_in, d_out] ~ N(0, 2 / (d_in + d_out)), drawn in f32 and cast."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn(d_in, d_out, generator=gen, device=gen.device) * scale
    return w.to(dtype)


# --- rotary position embedding ---------------------------------------------


def rope_freqs(d_head: int, base: float = 10000.0, device=None):
    return 1.0 / (base ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                        device=device) / d_head))


def apply_rope(x, positions, base: float = 10000.0):
    """x [..., S, Dh], positions [S]: rotates the split halves (x1, x2) of
    the last axis, not interleaved pairs, by f32 angles of the absolute
    positions; returns x's dtype."""
    freqs = rope_freqs(x.shape[-1], base, x.device)             # [Dh/2]
    angles = positions[..., :, None].float() * freqs             # [S, Dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.chunk(2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rot.to(x.dtype)


# --- MLPs --------------------------------------------------------------------


def init_swiglu(gen: torch.Generator, d: int, f: int,
                dtype: torch.dtype = torch.float32) -> dict:
    return {"gate": dense_init(gen, d, f, dtype),
            "up": dense_init(gen, d, f, dtype),
            "down": dense_init(gen, f, d, dtype)}


def swiglu_specs() -> dict:
    return {"gate": P(None, "model"), "up": P(None, "model"),
            "down": P("model", None)}


def swiglu(params, x):
    """``params``: a mapping with ``gate``, ``up`` [d, f], ``down`` [f, d]."""
    h = torch.nn.functional.silu(x @ params["gate"]) * (x @ params["up"])
    return h @ params["down"]


def init_mlp(gen: torch.Generator, d_in: int, hidden: tuple[int, ...],
             d_out: int | None = None) -> list[dict]:
    """Plain relu MLP (recsys towers): a list of ``{w, b}``."""
    dims = [d_in, *hidden] + ([d_out] if d_out is not None else [])
    return [{"w": dense_init(gen, a, b),
             "b": torch.zeros(b, device=gen.device)}
            for a, b in zip(dims[:-1], dims[1:])]


def mlp_specs(n_layers: int) -> list[dict]:
    """Alternating column- and row-split layers over "model"."""
    return [{"w": P(None, "model"), "b": P("model")} if i % 2 == 0
            else {"w": P("model", None), "b": P()}
            for i in range(n_layers)]


def mlp_shapes(d_in: int, hidden: tuple[int, ...],
               d_out: int | None = None) -> list[dict]:
    """``init_mlp``'s leaves as ``(shape, dtype)``, allocating nothing."""
    dims = [d_in, *hidden] + ([d_out] if d_out is not None else [])
    return [{"w": ((a, b), torch.float32), "b": ((b,), torch.float32)}
            for a, b in zip(dims[:-1], dims[1:])]


def mlp(params, x, final_act: bool = False):
    """``params``: a sequence of ``(w, b)``; relu after every layer but
    the last (and after the last too with ``final_act``)."""
    params = list(params)
    for i, (w, b) in enumerate(params):
        x = x @ w + b
        if i < len(params) - 1 or final_act:
            x = torch.relu(x)
    return x
