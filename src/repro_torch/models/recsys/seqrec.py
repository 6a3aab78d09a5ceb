"""Sequential recommenders: SASRec (arXiv:1808.09781) and BERT4Rec
(arXiv:1904.06690) share one transformer-over-item-history backbone
(``repro.models.recsys.seqrec``).

  * SASRec: causal self-attention, learned absolute positions, scores
    through the tied item embeddings.
  * BERT4Rec: the same with bidirectional attention.

Serving entry points:
  * ``score_candidates`` (serve_p99 / serve_bulk): the last position's
    user state against each user's candidate embeddings;
  * ``retrieval_scores`` (retrieval_cand): one user against a candidate
    slab, a [N, d] x [d] product.

Parameters keep ``repro``'s tree: ``item_embed`` [n_items, d],
``pos_embed`` [seq_len, d], ``blocks.*`` with every leaf stacked on a
leading [n_blocks] axis (``ln1``, ``wqkv`` [nb, d, 3d], ``wo``, ``ln2``,
``ffn.{0,1}``), ``final_ln``.  No kernel runs here.

Training: ``sampled_softmax_loss``, one positive against
``n_negatives`` shared uniform negatives.  ``repro`` draws them from a
PRNG key; here they come from the caller's ``torch.Generator``, or are
given as ``negatives`` (how the tests feed ``repro``'s draws: threefry
cannot be replayed).
"""
from __future__ import annotations

import dataclasses

import torch

from ... import resolve_device
from ...distributed import spmd
from ...distributed.sharding import P
from .. import layers
from ..attention import chunked_attention
from . import embedding


@dataclasses.dataclass(frozen=True)
class SeqRecConfig:
    name: str = "sasrec"
    n_items: int = 1 << 20
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    causal: bool = True          # False -> BERT4Rec
    n_negatives: int = 127
    dtype: torch.dtype = torch.float32

    @property
    def d_head(self) -> int:
        return self.embed_dim // self.n_heads


def init_seqrec(gen: torch.Generator, cfg: SeqRecConfig) -> dict:
    d = cfg.embed_dim
    dev = gen.device

    def init_block():
        return {
            "ln1": layers.init_layer_norm(d, dev),
            "wqkv": layers.dense_init(gen, d, 3 * d),
            "wo": layers.dense_init(gen, d, d),
            "ln2": layers.init_layer_norm(d, dev),
            "ffn": layers.init_mlp(gen, d, (4 * d,), d),
        }

    return {
        "item_embed": embedding.init_table(gen, cfg.n_items, d),
        "pos_embed": torch.randn(cfg.seq_len, d, generator=gen,
                                 device=dev) * 0.02,
        "blocks": layers.tree_stack([init_block()
                                     for _ in range(cfg.n_blocks)]),
        "final_ln": layers.init_layer_norm(d, dev),
    }


def seqrec_specs(cfg: SeqRecConfig) -> dict:
    """``repro``'s layout: the tower (embed_dim 50-64, not 16-divisible)
    replicated, the 2^20-row item table row-sharded; tower compute is
    data-parallel."""
    block = {"ln1": layers.layer_norm_specs(), "wqkv": P(), "wo": P(),
             "ln2": layers.layer_norm_specs(),
             "ffn": [{"w": P(), "b": P()}, {"w": P(), "b": P()}]}
    return {"item_embed": embedding.table_specs(), "pos_embed": P(),
            "blocks": block, "final_ln": layers.layer_norm_specs()}


def param_shapes(cfg: SeqRecConfig) -> dict:
    """The parameter tree as ``(shape, dtype)`` leaves."""
    d, nb, f32 = cfg.embed_dim, cfg.n_blocks, torch.float32

    def ln(stack=()):
        return {"scale": ((*stack, d), f32), "bias": ((*stack, d), f32)}

    block = {"ln1": ln((nb,)), "wqkv": ((nb, d, 3 * d), f32),
             "wo": ((nb, d, d), f32), "ln2": ln((nb,)),
             "ffn": [{"w": ((nb, d, 4 * d), f32), "b": ((nb, 4 * d), f32)},
                     {"w": ((nb, 4 * d, d), f32), "b": ((nb, d), f32)}]}
    return {"item_embed": ((cfg.n_items, d), f32),
            "pos_embed": ((cfg.seq_len, d), f32), "blocks": block,
            "final_ln": ln()}


class SeqRec(layers.Params):
    """SASRec / BERT4Rec with random weights from ``seed``, on ``device``
    (default cuda; raises without a card unless ``device="cpu"``)."""

    ax = spmd.ONE_RANK      # the table's lookups (``embedding``)

    def __init__(self, cfg: SeqRecConfig = SeqRecConfig(), *, seed: int = 0,
                 device=None):
        dev = resolve_device(device)
        super().__init__(init_seqrec(
            torch.Generator(device=dev).manual_seed(seed), cfg))
        self.cfg = cfg


def _block_fwd(p, i: int, cfg: SeqRecConfig, x):
    """Block ``i`` of the stacked block parameters ``p``."""
    B, S, d = x.shape
    H, Dh = cfg.n_heads, cfg.d_head
    z = layers.layer_norm(x, p.ln1.scale[i], p.ln1.bias[i])
    qkv = (z @ p.wqkv[i]).reshape(B, S, 3, H, Dh)
    q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
    o = chunked_attention(q, k, v, causal=cfg.causal,
                          chunk=min(1024, S)).transpose(1, 2)
    x = x + o.reshape(B, S, d) @ p.wo[i]
    z = layers.layer_norm(x, p.ln2.scale[i], p.ln2.bias[i])
    return x + layers.mlp([(f.w[i], f.b[i]) for f in p.ffn], z)


def user_states(model: SeqRec, item_ids):
    """item_ids [B, S] -> per-position user states [B, S, d]."""
    cfg = model.cfg
    x = embedding.item_rows(model, item_ids) + model.pos_embed
    for i in range(cfg.n_blocks):
        x = _block_fwd(model.blocks, i, cfg, x)
    return layers.layer_norm(x, model.final_ln.scale, model.final_ln.bias)


def score_candidates(model: SeqRec, item_ids, cand_ids):
    """item_ids [B, S], cand_ids [B, C] -> scores [B, C] (online serving)."""
    h = user_states(model, item_ids)[:, -1]                   # [B, d]
    ce = embedding.item_rows(model, cand_ids)                 # [B, C, d]
    return torch.einsum("bd,bcd->bc", h, ce)


def retrieval_scores(model: SeqRec, item_ids, cand_ids):
    """One user against a candidate slab: [1, S] x [N] -> [N] scores."""
    h = user_states(model, item_ids)[:, -1]                   # [1, d]
    ce = embedding.item_rows(model, cand_ids)                 # [N, d]
    return (ce @ h[0]).float()


def sampled_softmax_loss(model: SeqRec, item_ids, targets, gen=None,
                         negatives=None):
    """Next-item (causal) or cloze (bidirectional) loss: item_ids,
    targets [B, S]; positions whose target is 0 (pads) weigh nothing.
    ``negatives`` [n_negatives] are drawn from ``gen`` unless given."""
    cfg = model.cfg
    h = user_states(model, item_ids)                          # [B, S, d]
    if negatives is None:
        negatives = embedding.draw_negatives(gen, cfg.n_negatives,
                                             cfg.n_items, h.device)
    pos_e = embedding.item_rows(model, targets)               # [B, S, d]
    neg_e = embedding.item_rows(model, negatives)             # [N, d]
    pos_logit = torch.sum(h * pos_e, dim=-1, keepdim=True)    # [B, S, 1]
    neg_logit = torch.einsum("bsd,nd->bsn", h, neg_e)         # [B, S, N]
    logits = torch.cat([pos_logit, neg_logit], dim=-1).float()
    lse = torch.logsumexp(logits, dim=-1)
    weight = (targets > 0).float()
    loss = (lse - logits[..., 0]) * weight
    return torch.sum(loss) / torch.clamp_min(torch.sum(weight), 1.0)
