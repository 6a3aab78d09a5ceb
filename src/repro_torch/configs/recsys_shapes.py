"""Shared recsys shape sets (train_batch / serve_p99 / serve_bulk /
retrieval_cand) for the sequence recommenders (sasrec, bert4rec, mind),
as in ``repro.configs.recsys_shapes``.

The serve cells score 1000 candidates per user (a final-ranking slate);
retrieval scores one query against 2^20 candidates as one batched dot.
The train cell's ``seed`` stands where ``repro`` takes a PRNG key: the
port draws from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import torch

from .base import ShapeCell

TRAIN_B = 65_536
P99_B = 512
BULK_B = 262_144
N_CAND_SERVE = 1000
N_CAND_RETR = 1_048_576   # 2^20: 10^6 rounded up to divide 512-way meshes


def seq_shapes(seq_len: int, target_per_pos: bool) -> dict[str, ShapeCell]:
    """target_per_pos: SASRec/BERT4Rec predict per position; MIND one target."""

    def train(cfg):
        return {
            "hist": ((TRAIN_B, seq_len), torch.int32),
            "seed": ((), torch.int64),
            "targets": ((TRAIN_B, seq_len) if target_per_pos else (TRAIN_B,),
                        torch.int32),
        }

    def serve(batch):
        def make(cfg):
            return {
                "hist": ((batch, seq_len), torch.int32),
                "cand": ((batch, N_CAND_SERVE), torch.int32),
            }
        return make

    def retrieval(cfg):
        return {
            "hist": ((1, seq_len), torch.int32),
            "cand": ((N_CAND_RETR,), torch.int32),
        }

    return {
        "train_batch": ShapeCell("train", train, f"batch {TRAIN_B}"),
        "serve_p99": ShapeCell("serve", serve(P99_B),
                               f"online, {P99_B} x {N_CAND_SERVE} candidates"),
        "serve_bulk": ShapeCell("serve", serve(BULK_B),
                                f"offline, {BULK_B} x {N_CAND_SERVE} candidates"),
        "retrieval_cand": ShapeCell("serve", retrieval,
                                    f"1 query x {N_CAND_RETR} candidates"),
    }
