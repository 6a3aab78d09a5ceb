"""MIND (arXiv:1904.08030; ``repro.models.recsys.mind``): multi-interest
extraction by capsule routing.

User history -> behaviour capsules -> ``n_interests`` interest capsules
by B2I dynamic routing (squash nonlinearity, ``capsule_iters`` routing
iterations from a fixed sine initialisation of the routing logits, so
serving is reproducible) -> label-aware attention picks the interest
for scoring.  Parameters: ``item_embed`` [n_items, d] and the shared
bilinear routing map ``S`` [d, d].  No kernel runs here.

Training: ``mind_loss``, a sampled softmax of the label-aware scores
over the target and ``n_negatives`` shared uniform negatives (from the
caller's ``torch.Generator``, or given).  As in ``repro``, the routing
iterations see the behaviour capsules detached: the gradient flows
through the final weighted sum only.
"""
from __future__ import annotations

import dataclasses

import torch

from ... import resolve_device
from ...distributed import spmd
from ...distributed.sharding import P
from .. import layers
from . import embedding


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 1 << 20
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    seq_len: int = 50
    n_negatives: int = 127
    pow_p: float = 2.0          # label-aware attention sharpness
    dtype: torch.dtype = torch.float32


def init_mind(gen: torch.Generator, cfg: MINDConfig) -> dict:
    return {
        "item_embed": embedding.init_table(gen, cfg.n_items, cfg.embed_dim),
        # shared bilinear routing map S (B2I routing, paper eq. 5)
        "S": layers.dense_init(gen, cfg.embed_dim, cfg.embed_dim),
    }


def mind_specs(cfg: MINDConfig) -> dict:
    return {"item_embed": embedding.table_specs(), "S": P()}


def param_shapes(cfg: MINDConfig) -> dict:
    """The parameter tree as ``(shape, dtype)`` leaves."""
    d, f32 = cfg.embed_dim, torch.float32
    return {"item_embed": ((cfg.n_items, d), f32), "S": ((d, d), f32)}


class MIND(layers.Params):
    """MIND with random weights from ``seed``, on ``device`` (default
    cuda; raises without a card unless ``device="cpu"``)."""

    ax = spmd.ONE_RANK      # the table's lookups (``embedding``)

    def __init__(self, cfg: MINDConfig = MINDConfig(), *, seed: int = 0,
                 device=None):
        dev = resolve_device(device)
        super().__init__(init_mind(
            torch.Generator(device=dev).manual_seed(seed), cfg))
        self.cfg = cfg


def _squash(v, dim: int = -1):
    n2 = torch.sum(v * v, dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * v / torch.sqrt(n2 + 1e-9)


def interest_capsules(model: MIND, hist_ids):
    """hist_ids [B, L] -> interests [B, K, d] by dynamic routing; history
    slots with id <= 0 are pads."""
    cfg = model.cfg
    e = embedding.item_rows(model, hist_ids)                  # [B, L, d]
    u = e @ model.S                                           # [B, L, d]
    B, L, d = u.shape
    K = cfg.n_interests
    mask = (hist_ids > 0).float()[..., None]                  # [B, L, 1]
    # fixed init of the routing logits (paper: random; a deterministic
    # function of the positions keeps serving reproducible)
    pos = torch.arange(L, dtype=torch.float32, device=u.device)
    k = torch.arange(K, dtype=torch.float32, device=u.device)
    blog = (torch.sin(pos[:, None] * (1.0 + k[None, :])) * 0.1).expand(B, L,
                                                                      K)
    ud = u.detach()
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(blog, dim=-1) * mask                # [B, L, K]
        cap = _squash(torch.einsum("blk,bld->bkd", w, ud))    # [B, K, d]
        blog = blog + torch.einsum("bld,bkd->blk", ud, cap)
    w = torch.softmax(blog, dim=-1) * mask
    return _squash(torch.einsum("blk,bld->bkd", w, u))        # [B, K, d]


def label_aware_scores(interests, item_e, pow_p):
    """interests [B, K, d], item_e [B, T, d] -> scores [B, T]."""
    sims = torch.einsum("bkd,btd->btk", interests, item_e)    # [B, T, K]
    att = torch.softmax(torch.pow(sims.abs(), pow_p) * torch.sign(sims),
                        dim=-1)
    chosen = torch.einsum("btk,bkd->btd", att, interests)
    return torch.sum(chosen * item_e, dim=-1)


def mind_loss(model: MIND, hist_ids, target_ids, gen=None,
              negatives=None):
    """Sampled-softmax loss: hist [B, L], target [B]; ``negatives``
    [n_negatives] are drawn from ``gen`` unless given."""
    cfg = model.cfg
    interests = interest_capsules(model, hist_ids)            # [B, K, d]
    if negatives is None:
        negatives = embedding.draw_negatives(gen, cfg.n_negatives,
                                             cfg.n_items, interests.device)
    pos_e = embedding.item_rows(model, target_ids)            # [B, d]
    neg_e = embedding.item_rows(model, negatives)             # [N, d]
    cand = torch.cat([pos_e[:, None, :],
                      neg_e.expand(hist_ids.shape[0], *neg_e.shape)], dim=1)
    logits = label_aware_scores(interests, cand, cfg.pow_p).float()
    return torch.mean(torch.logsumexp(logits, dim=-1) - logits[:, 0])


def mind_serve(model: MIND, hist_ids, cand_ids):
    """hist [B, L], cand [B, C] -> scores [B, C] (max over interests)."""
    interests = interest_capsules(model, hist_ids)
    ce = embedding.item_rows(model, cand_ids)                 # [B, C, d]
    return torch.einsum("bkd,bcd->bck", interests, ce).amax(dim=-1)


def mind_retrieval(model: MIND, hist_ids, cand_ids):
    """One user against a candidate slab: hist [1, L], cand [N] -> [N]."""
    interests = interest_capsules(model, hist_ids)[0]         # [K, d]
    ce = embedding.item_rows(model, cand_ids)                 # [N, d]
    return (ce @ interests.T).amax(dim=-1).float()
