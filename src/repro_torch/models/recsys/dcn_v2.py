"""DCN-v2 (arXiv:2008.13535; ``repro.models.recsys.dcn_v2``): a cross
network and a deep tower in parallel over Criteo-style features (13
dense + 26 categorical fields), concatenated into one logit.

The three cross layers ``x_{l+1} = x0 * (xl W^T + b) + xl`` go through
the cross kernel (``kernels/cross``) for CUDA tensors, and back through
its closed-form gradient in torch ops; the deep tower and the final
product stay ``torch.matmul``, as ``repro`` left them to XLA.
Parameters keep ``repro``'s tree and layouts: ``tables`` [F, V, D],
``cross.{i}.W`` [d, d] / ``.b``, ``deep.{i}.w`` [d_in, d_out] / ``.b``,
``final`` [d + mlp_dims[-1], 1] (no bias).
"""
from __future__ import annotations

import dataclasses

import torch

from ... import resolve_device
from ...distributed import spmd
from ...distributed.sharding import P
from ...kernels.cross import ops as cross_ops
from .. import layers
from . import embedding


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    vocab_per_field: int = 1 << 20
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp_dims: tuple[int, ...] = (1024, 1024, 512)
    dtype: torch.dtype = torch.float32

    @property
    def d_interact(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


def init_dcn(gen: torch.Generator, cfg: DCNConfig) -> dict:
    """The parameter tree, drawn on the generator's device."""
    d = cfg.d_interact
    dev = gen.device
    tables = torch.empty(cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim,
                         device=dev)
    for f in range(cfg.n_sparse):       # one field at a time: no stacked copy
        tables[f] = embedding.init_table(gen, cfg.vocab_per_field,
                                         cfg.embed_dim)
    cross = [{"W": layers.dense_init(gen, d, d),
              "b": torch.zeros(d, device=dev)}
             for _ in range(cfg.n_cross_layers)]
    deep = layers.init_mlp(gen, d, cfg.mlp_dims)
    final = layers.dense_init(gen, d + cfg.mlp_dims[-1], 1)
    return {"tables": tables, "cross": cross, "deep": deep, "final": final}


def dcn_specs(cfg: DCNConfig) -> dict:
    """``repro``'s layout: the cross W [429, 429] replicated (429 is not
    16-divisible), the deep tower over "model", the tables row-sharded
    per field."""
    return {"tables": P(None, "model", None),
            "cross": [{"W": P(), "b": P()}
                      for _ in range(cfg.n_cross_layers)],
            "deep": layers.mlp_specs(len(cfg.mlp_dims)),
            "final": P()}


def param_shapes(cfg: DCNConfig) -> dict:
    """The parameter tree as ``(shape, dtype)`` leaves."""
    d, f32 = cfg.d_interact, torch.float32
    return {"tables": ((cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim),
                       f32),
            "cross": [{"W": ((d, d), f32), "b": ((d,), f32)}
                      for _ in range(cfg.n_cross_layers)],
            "deep": layers.mlp_shapes(d, cfg.mlp_dims),
            "final": ((d + cfg.mlp_dims[-1], 1), f32)}


class DCNv2(layers.Params):
    """DCN-v2 with random weights from ``seed``, on ``device`` (default
    cuda; raises without a card unless ``device="cpu"``)."""

    ax = spmd.ONE_RANK      # the table's lookups (``embedding``)

    def __init__(self, cfg: DCNConfig = DCNConfig(), *, seed: int = 0,
                 device=None):
        dev = resolve_device(device)
        super().__init__(init_dcn(
            torch.Generator(device=dev).manual_seed(seed), cfg))
        self.cfg = cfg


def interaction_input(model: DCNv2, dense_feats, sparse_ids):
    """x0 [B, d]: the dense features, then each field's embedding,
    field-major (``repro``'s feature order)."""
    cfg = model.cfg
    B = dense_feats.shape[0]
    fields = torch.arange(cfg.n_sparse, device=sparse_ids.device)
    # per-field gathers from the stacked [F, V, D] tables -> [B, F, D]
    emb = embedding.lookup_rows(lambda i: model.tables[fields, i],
                                sparse_ids, cfg.vocab_per_field,
                                model.tables.shape[1], model.ax)
    return torch.cat([dense_feats.to(cfg.dtype), emb.reshape(B, -1)], dim=-1)


def dcn_fwd(model: DCNv2, dense_feats, sparse_ids):
    """dense_feats [B, 13] f32, sparse_ids [B, 26] i32 -> logits [B]."""
    x0 = interaction_input(model, dense_feats, sparse_ids)
    xl = x0
    for lyr in model.cross:
        xl = cross_ops.cross_layer(x0, xl, lyr.W, lyr.b)
    deep = layers.mlp([(lyr.w, lyr.b) for lyr in model.deep], x0,
                      final_act=True)
    both = torch.cat([xl, deep], dim=-1)
    return (both @ model.final)[:, 0]


def dcn_loss(model: DCNv2, dense_feats, sparse_ids, labels):
    """Mean binary cross-entropy of the logits, as ``repro``'s.  On a
    model turned on with ``requires_grad_(True)`` it differentiates
    through the cross kernel's autograd Function
    (``kernels.cross.ops``)."""
    logits = dcn_fwd(model, dense_feats, sparse_ids).float()
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))
