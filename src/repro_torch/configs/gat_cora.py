"""gat-cora [arXiv:1710.10903; paper] (``repro.configs.gat_cora``).

2 layers, 8 hidden units x 8 attention heads, attn aggregator.  The four
graph cells span full-batch small (Cora), sampled training
(Reddit-scale), full-batch large (ogbn-products) and batched molecules,
each with its own feature and class dims (``cfg_overrides``, taken from
the public datasets).
"""
import torch

from ..models.gnn import GNNConfig
from .base import ArchSpec, ShapeCell, register

CONFIG = GNNConfig(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8)

# per-cell graph dims: (n_nodes, n_edges, d_feat, n_classes).  Node and
# edge counts are padded up to the next multiple of 32 (isolated dummy
# nodes, masked self-loop edges), as in ``repro``; true sizes in comments.
CELL_DIMS = {
    "full_graph_sm": (3072, 10752, 1433, 7),            # Cora 2708 / 10556
    "minibatch_lg": (232_965, 114_615_892, 602, 41),    # Reddit (sampled path)
    "ogb_products": (2_449_408, 61_859_328, 100, 47),   # products 2449029 / 61859140
    "molecule": (4096, 64 * 128, 16, 10),               # 128-graph union (30x128 nodes)
}

FANOUTS = (15, 10)
BATCH_NODES = 1024


def _full_graph(n, e, f, c):
    def make(cfg):
        return {"feats": ((n, f), torch.float32),
                "src": ((e,), torch.int32),
                "dst": ((e,), torch.int32),
                "labels": ((n,), torch.int32),
                "mask": ((n,), torch.bool)}
    return make


def _minibatch(f, c):
    # union subgraph: 1024 seeds, fanout 15 then 10 (fixed shapes)
    n_tot = BATCH_NODES * (1 + FANOUTS[0] + FANOUTS[0] * FANOUTS[1])
    e_tot = BATCH_NODES * (FANOUTS[0] + FANOUTS[0] * FANOUTS[1])

    def make(cfg):
        return {"feats": ((n_tot, f), torch.float32),
                "src": ((e_tot,), torch.int32),
                "dst": ((e_tot,), torch.int32),
                "labels": ((n_tot,), torch.int32),
                "mask": ((n_tot,), torch.bool)}   # true on the seed block
    return make


def _shapes():
    out = {}
    for cell, (n, e, f, c) in CELL_DIMS.items():
        ov = (("d_feat", f), ("n_classes", c))
        if cell == "ogb_products":
            # the 2.45M-node gather is this cell's bottleneck in ``repro``
            ov += (("quantized_gather", True),)
        if cell == "minibatch_lg":
            out[cell] = ShapeCell("train", _minibatch(f, c),
                                  "sampled blocks 1024 @ fanout 15-10", ov)
        else:
            out[cell] = ShapeCell("train", _full_graph(n, e, f, c),
                                  f"full batch {n} nodes / {e} edges", ov)
    return out


SPEC = register(ArchSpec(
    arch_id="gat-cora", family="gnn", cfg=CONFIG, shapes=_shapes(),
    source="arXiv:1710.10903",
))
