"""Per-cell training steps (``repro.launch.steps``).

So far the GNN family's: ``gnn_train_step`` is the body of ``repro``'s
``build_gnn_cell`` ``local_step``, run by each rank on its node rows and
its destination block of edges (``models.gnn.gat_loss_local``): the
gradient of the rank's loss, the mean of the gradients over the ranks
(``repro``'s ``pmean``), then AdamW at lr 5e-3 on the replicated
parameters.  One process passes ``runtime.collectives.NullCollectives()``.
"""
from __future__ import annotations

from ..models import gnn
from ..train import optimizer
from ..tree import tree_leaves, tree_map
from .train import value_and_grad


def gnn_train_step(params, opt, cfg, feats, src, dst, labels, mask, col):
    """One GAT step on this rank's shard; returns ``(params, opt,
    loss)``, the parameters (their gradients turned on here) and the
    AdamW moments updated in place."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, grads = value_and_grad(gnn.gat_loss_local, params, params, cfg,
                                 feats, src, dst, labels, mask, col)
    n = col.n_shards
    grads = tree_map(lambda g: col.psum(g) / n, grads)
    params, opt = optimizer.adamw_update(grads, opt, params, lr=5e-3)
    return params, opt, loss
