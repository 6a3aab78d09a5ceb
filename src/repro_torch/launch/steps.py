"""Per-cell steps (``repro.launch.steps``).

``build_cell(arch_id, shape, mesh)`` returns a :class:`CellBundle`: the
cell's step as this rank runs it and each argument's local ``(shape,
dtype)`` on this rank, allocating nothing (``repro`` builds abstract
``ShapeDtypeStruct`` arguments).  So far the LM decode cells (decode_32k
and long_500k): ``distributed.decode_shard``'s step, whose layout
(standard, tiny batch or f-sharded) the shapes follow; with
``kv_quant`` the caches are int8 codes with f32 scales ``[..., S]``.
The train, prefill, recsys and bandit cells are global programs that
``repro`` leaves to GSPMD; they are not ported yet (ROADMAP queue 1, item
9d-2) and ``build_cell`` raises for them.

``gnn_train_step`` is the body of ``repro``'s ``build_gnn_cell``
``local_step``, run by each rank on its node rows and its destination
block of edges (``models.gnn.gat_loss_local``): the gradient of the
rank's loss, the mean of the gradients over the ranks (``repro``'s
``pmean``), then AdamW at lr 5e-3 on the replicated parameters.  One
process passes ``runtime.collectives.NullCollectives()``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import configs
from ..distributed import decode_shard
from ..distributed.sharding import map_specs, shard_shape
from ..models import gnn, transformer
from ..train import optimizer
from ..tree import tree_leaves, tree_map
from .train import value_and_grad


@dataclasses.dataclass
class CellBundle:
    arch_id: str
    shape: str
    kind: str
    step_fn: Callable             # this rank's step, positional args
    local_args: tuple             # (shape, dtype) trees, this rank's
    arg_specs: tuple              # each argument's partition specs
    note: str = ""


def build_lm_cell(spec, shape: str, mesh, kv_quant: bool = False,
                  device=None) -> CellBundle:
    """The decode cells of an LM arch on ``mesh`` (a ``launch.mesh.Mesh``
    or a description of one), seen from its rank; the step's pieces go to
    ``device`` (default cuda, as ``build_decode_step``)."""
    cfg = spec.cell_cfg(shape)
    cell = spec.shapes[shape]
    if cell.kind != "decode":
        raise NotImplementedError(
            f"{spec.arch_id} {shape}: the LM {cell.kind} cell is a GSPMD "
            "program, not ported yet (ROADMAP queue 1, item 9d-2)")
    inputs = spec.input_specs(shape)
    batch = inputs["token"][0][0]
    cache_shape, cache_dtype = inputs["k_cache"]
    ds = decode_shard.build_decode_step(mesh, cfg, batch, cache_shape[4],
                                        kv_quant=kv_quant, device=device)

    def local(spec_, shape_dtype):
        return shard_shape(shape_dtype[0], spec_, mesh), shape_dtype[1]

    params = map_specs(local, ds.param_specs, transformer.param_shapes(cfg))
    if kv_quant:
        full = ((cache_shape, torch.int8),) * 2 \
            + ((cache_shape[:-1], torch.float32),) * 2
    else:
        full = ((cache_shape, cache_dtype),) * 2
    caches = tuple(local(s, sd) for s, sd in zip(ds.cache_specs, full))
    return CellBundle(
        spec.arch_id, shape, "decode", ds.step,
        (params, local(ds.token_spec, inputs["token"]), caches,
         inputs["pos"]),
        (ds.param_specs, ds.token_spec, ds.cache_specs, None),
        note=cell.note)


def build_cell(arch_id: str, shape: str, mesh, kv_quant: bool = False,
               device=None) -> CellBundle:
    spec = configs.get(arch_id)
    if spec.family != "lm":
        raise NotImplementedError(
            f"{arch_id} {shape}: the {spec.family} cells are GSPMD "
            "programs, not ported yet (ROADMAP queue 1, item 9d-2)")
    return build_lm_cell(spec, shape, mesh, kv_quant=kv_quant,
                         device=device)


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
