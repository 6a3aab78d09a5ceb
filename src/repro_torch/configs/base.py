"""Architecture registry (``repro.configs.base``): ``ArchSpec`` and the
per-cell input specs.

Every ported architecture registers an ``ArchSpec`` with its published
configuration and its own shape set.  A *cell* = (arch, shape) names one
unit of work; ``input_specs`` describes its inputs as
``{name: (shape, torch.dtype)}``, allocating nothing (``repro`` uses
``jax.ShapeDtypeStruct``).  Only the four recsys archs register so far;
the paper's own bandit configuration (``distclub_paper``) stays a plain
module.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    kind: str                      # "train" | "serve"
    make_inputs: Callable[[Any], dict]  # cfg -> {name: (shape, dtype)}
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # "recsys" so far
    cfg: Any
    shapes: dict[str, ShapeCell]
    source: str = ""

    def input_specs(self, shape: str) -> dict:
        return self.shapes[shape].make_inputs(self.cfg)


REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    REGISTRY[spec.arch_id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    return REGISTRY[arch_id]


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a, spec in REGISTRY.items() for s in spec.shapes]
