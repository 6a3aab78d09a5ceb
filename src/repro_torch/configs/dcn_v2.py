"""dcn-v2 [arXiv:2008.13535; paper] (``repro.configs.dcn_v2``).

13 dense + 26 sparse fields (Criteo layout), embed_dim=16, 3 cross layers,
deep tower 1024-1024-512, parallel combination.  Per-field vocab 2^20
(hashed), so d_interact = 13 + 26 * 16 = 429.  ``retrieval_cand`` for a
ranker = bulk scoring of 2^20 candidate rows for one query context.
"""
import torch

from ..models.recsys.dcn_v2 import DCNConfig
from .base import ArchSpec, ShapeCell, register
from .recsys_shapes import BULK_B, N_CAND_RETR, P99_B, TRAIN_B

CONFIG = DCNConfig(
    name="dcn-v2", n_dense=13, n_sparse=26, vocab_per_field=1 << 20,
    embed_dim=16, n_cross_layers=3, mlp_dims=(1024, 1024, 512),
)


def _fwd(batch, with_labels):
    def make(cfg):
        d = {
            "dense_feats": ((batch, cfg.n_dense), torch.float32),
            "sparse_ids": ((batch, cfg.n_sparse), torch.int32),
        }
        if with_labels:
            d["labels"] = ((batch,), torch.float32)
        return d
    return make


SPEC = register(ArchSpec(
    arch_id="dcn-v2", family="recsys", cfg=CONFIG,
    shapes={
        "train_batch": ShapeCell("train", _fwd(TRAIN_B, True),
                                 f"batch {TRAIN_B}"),
        "serve_p99": ShapeCell("serve", _fwd(P99_B, False), "online ranking"),
        "serve_bulk": ShapeCell("serve", _fwd(BULK_B, False),
                                "offline scoring"),
        "retrieval_cand": ShapeCell("serve", _fwd(N_CAND_RETR, False),
                                    "1M candidate rows for one query"),
    },
    source="arXiv:2008.13535",
))
