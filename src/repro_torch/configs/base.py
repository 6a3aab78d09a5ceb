"""Architecture registry (``repro.configs.base``): ``ArchSpec`` and the
per-cell input specs.

Every ported architecture registers an ``ArchSpec`` with its published
configuration and its own shape set.  A *cell* = (arch, shape) names one
unit of work; ``input_specs`` describes its inputs as
``{name: (shape, torch.dtype)}``, allocating nothing (``repro`` uses
``jax.ShapeDtypeStruct``), from the cell's config: ``cell_cfg`` applies
the cell's ``cfg_overrides`` (gat-cora's per-graph feature and class
dims).  The four recsys archs, the five LMs, the GNN and the paper's
own bandit configuration (``distclub_paper``) register.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    kind: str              # "train" | "serve" | "decode" | "bandit_epoch"
    make_inputs: Callable[[Any], dict]  # cfg -> {name: (shape, dtype)}
    note: str = ""
    cfg_overrides: tuple = ()      # (("d_feat", 100), ...) applied per cell


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # "lm" | "gnn" | "recsys" | "bandit"
    cfg: Any
    shapes: dict[str, ShapeCell]
    source: str = ""

    def cell_cfg(self, shape: str):
        ov = dict(self.shapes[shape].cfg_overrides)
        return dataclasses.replace(self.cfg, **ov) if ov else self.cfg

    def input_specs(self, shape: str) -> dict:
        return self.shapes[shape].make_inputs(self.cell_cfg(shape))


REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    REGISTRY[spec.arch_id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    return REGISTRY[arch_id]


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a, spec in REGISTRY.items() for s in spec.shapes]


# ---- the shared LM shape set ------------------------------------------


def lm_shapes(cfg) -> dict[str, ShapeCell]:
    def train_4k(c):
        return {"tokens": ((256, 4096), torch.int32),
                "labels": ((256, 4096), torch.int32)}

    def prefill_32k(c):
        return {"tokens": ((32, 32768), torch.int32)}

    def _decode(batch, s_max):
        def make(c):
            cache_shape = (c.n_blocks, c.block_layers, batch, c.n_kv_heads,
                           s_max, c.d_head)
            return {"token": ((batch,), torch.int32),
                    "k_cache": (cache_shape, c.dtype),
                    "v_cache": (cache_shape, c.dtype),
                    "pos": ((), torch.int32)}
        return make

    return {
        "train_4k": ShapeCell("train", train_4k, "seq 4096, global batch 256"),
        "prefill_32k": ShapeCell("serve", prefill_32k,
                                 "inference prefill, 32 x 32768"),
        "decode_32k": ShapeCell("decode", _decode(128, 32768),
                                "one token vs 32k KV cache, batch 128"),
        # decode against a 500k cache is linear in the cache length (one
        # query token), so full-attention archs run it
        "long_500k": ShapeCell("decode", _decode(1, 524288),
                               "one token vs 524288 KV cache, batch 1"),
    }
