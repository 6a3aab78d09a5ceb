"""Carry states across the two packages as numpy arrays.

``state_from_numpy`` takes a ``repro`` ``DistCLUBState`` whose leaves are
numpy arrays (``jax.tree.map(np.asarray, state)``) and builds the port's
state; ``state_to_numpy`` goes the other way, so both packages can compute
from the same state.  The records have the same fields; the only change
is the packed adjacency, uint32 in the reference and an int32 view of the
same bits here.

``club_state_{from,to}_numpy`` and ``dccb_state_{from,to}_numpy`` do
the same for the baselines' ``CLUBState`` (packed adjacency as above)
and ``DCCBState`` (dense bool adjacency; the buffer cursor ``slot`` a
Python int here).

``record_from_numpy`` / ``record_to_numpy`` do the same for the serving
records, field by field by name: ``ClusteredState``, ``LinUCBServeState``,
``PendingBuffer``, ``Catalog`` and ``ItemClusters`` (``record_to_numpy``
also takes records that nest records, as ``DCCBServeState``).  Fields
the port keeps on the host (``Catalog.active``/``epoch``,
``ItemClusters.epoch``) become Python ints.  Reduced precision comes
across bit for bit: a ``repro`` bfloat16 array (``ml_dtypes``) through
its ``uint16`` bits into ``torch.bfloat16``, int8 codes and f32 scales as
they are (``catalog_from_numpy`` for a quantized ``Catalog``);
``record_to_numpy`` widens bf16 tensors to float32, exactly.  The same two functions carry
the environments' tables, so both packages run on the same ones:
``core.env``'s ``SyntheticEnv``, ``DriftEnv`` and ``CatalogEnv`` (the
reference's records of the same names), and ``data.replay.ReplayLog``
built from the reference's replay tables (``item_feats``, ``cand_ids``,
``click_probs``).

``dcn_from_numpy`` / ``seqrec_from_numpy`` / ``mind_from_numpy`` /
``lm_from_numpy`` take a ``repro`` model parameter tree with numpy leaves
and return the port's module holding those weights: the module's
parameters carry the tree's paths as names (``cross.0.W``,
``blocks.ffn.1.b``, ``blocks.l0.attn.wq``, a MoE layer's
``blocks.l1.moe.experts.gate``), and each leaf must match its
parameter's shape.  ``module.tree()`` gives a module's parameters back
as ``repro``'s tree, so a checkpoint of ``(module.tree(), opt_state)``
has ``repro``'s keys.  ``gat_from_numpy`` takes ``repro``'s GAT
parameter list and returns the port's, a list of ``{W, a_src, a_dst}``
tensors.

``opt_state_from_numpy`` takes a ``repro`` optimizer state
(``AdamWState``, ``AdafactorState`` or ``AdagradState``) whose leaves are
numpy arrays and builds the port's state of the same name, leaf for leaf
(bf16 moments bit for bit).
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from . import resolve_device
from .core import club, dccb
from .core.catalog import Catalog
from .core.types import (ClusterStats, DistCLUBState, GraphState,
                         LinUCBState)
from .models import gnn, transformer
from .models.recsys import dcn_v2, mind, seqrec
from .train import optimizer


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: carry the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def _conv(record, cls, dev):
    return cls(*(_tensor(getattr(record, f), dev) for f in cls._fields))


def state_from_numpy(state, device=None) -> DistCLUBState:
    dev = resolve_device(device)
    return DistCLUBState(
        lin=_conv(state.lin, LinUCBState, dev),
        graph=_conv(state.graph, GraphState, dev),
        clusters=_conv(state.clusters, ClusterStats, dev),
        u_rounds=_tensor(state.u_rounds, dev),
        c_rounds=_tensor(state.c_rounds, dev),
        comm_bytes=_tensor(state.comm_bytes, dev),
    )


def state_to_numpy(state: DistCLUBState) -> DistCLUBState:
    """The port's state with numpy leaves; the adjacency as uint32."""

    def arr(t):
        return t.detach().cpu().numpy()

    def conv(record):
        return type(record)(*(arr(t) for t in record))

    graph = state.graph
    return DistCLUBState(
        lin=conv(state.lin),
        graph=GraphState(adj=arr(graph.adj).view(np.uint32),
                         labels=arr(graph.labels)),
        clusters=conv(state.clusters),
        u_rounds=arr(state.u_rounds),
        c_rounds=arr(state.c_rounds),
        comm_bytes=arr(state.comm_bytes),
    )


def club_state_from_numpy(state, device=None) -> club.CLUBState:
    """The port's ``CLUBState`` from a reference ``CLUBState`` with numpy
    leaves (the uint32 adjacency as an int32 view of its bits)."""
    dev = resolve_device(device)
    return club.CLUBState(lin=_conv(state.lin, LinUCBState, dev),
                          graph=_conv(state.graph, GraphState, dev),
                          clusters=_conv(state.clusters, ClusterStats, dev))


def club_state_to_numpy(state: club.CLUBState) -> club.CLUBState:
    """The port's ``CLUBState`` with numpy leaves; the adjacency uint32."""
    return club.CLUBState(*(record_to_numpy(rec) for rec in state))


def dccb_state_from_numpy(state, device=None) -> dccb.DCCBState:
    """The port's ``DCCBState`` from a reference one with numpy leaves."""
    return record_from_numpy(state, dccb.DCCBState, device=device)


def dccb_state_to_numpy(state: dccb.DCCBState) -> dccb.DCCBState:
    """The port's ``DCCBState`` with numpy leaves (``slot`` an int)."""
    return record_to_numpy(state)


def record_from_numpy(record, cls, device=None):
    """The port's ``cls`` built from a reference record of the same field
    names whose leaves are numpy arrays."""
    dev = resolve_device(device)
    hints = typing.get_type_hints(cls)
    vals = {}
    for f in cls._fields:
        v = getattr(record, f)
        vals[f] = int(np.asarray(v)) if hints[f] is int else _tensor(v, dev)
    return cls(**vals)


def record_to_numpy(record):
    """The port's record with numpy leaves (packed int32 adjacency as
    uint32, host ints as they are, nested records converted too)."""
    vals = {}
    for f in record._fields:
        v = getattr(record, f)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            if f == "adj" and v.dtype == np.int32:
                v = v.view(np.uint32)
        elif hasattr(v, "_fields"):
            v = record_to_numpy(v)
        vals[f] = v
    return type(record)(**vals)


def catalog_from_numpy(record, device=None):
    """The port's ``core.catalog.Catalog`` from a ``repro`` ``Catalog``
    with numpy leaves: both banks' embeddings (f32, bf16 or int8 codes),
    liveness, arrival epochs and scales bit for bit, the bank flip and
    epoch as ints."""
    return record_from_numpy(record, Catalog, device=device)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _flatten(v, f"{prefix}.{k}" if prefix else str(k))


def load_params(module: torch.nn.Module, params) -> torch.nn.Module:
    """Copy a parameter tree with numpy leaves into ``module``, leaf by
    leaf by path; raises unless paths and shapes agree exactly."""
    own = dict(module.named_parameters())
    flat = dict(_flatten(params))
    if own.keys() != flat.keys():
        raise ValueError(f"parameter paths differ: only in the module "
                         f"{sorted(own.keys() - flat.keys())}, only in the "
                         f"tree {sorted(flat.keys() - own.keys())}")
    with torch.no_grad():
        for name, p in own.items():
            a = np.asarray(flat[name])
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape}, expected "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(a.astype(np.float32)))
    return module


def dcn_from_numpy(params, cfg: dcn_v2.DCNConfig, device=None):
    return load_params(dcn_v2.DCNv2(cfg, device=device), params)


def seqrec_from_numpy(params, cfg: seqrec.SeqRecConfig, device=None):
    return load_params(seqrec.SeqRec(cfg, device=device), params)


def mind_from_numpy(params, cfg: mind.MINDConfig, device=None):
    return load_params(mind.MIND(cfg, device=device), params)


def lm_from_numpy(params, cfg: transformer.LMConfig, device=None):
    """The port's ``LM`` from ``repro``'s ``init_lm`` tree (leaves stacked
    [n_blocks, ...]; a MoE layer's f32 router [n_blocks, d, E] and expert
    leaves [n_blocks, E, ...]), each leaf cast to its parameter's
    dtype."""
    return load_params(transformer.LM(cfg, device=device), params)


def gat_from_numpy(params, cfg: gnn.GNNConfig, device=None) -> list[dict]:
    """The port's GAT parameters from ``repro``'s ``init_gat`` list with
    numpy leaves, each in ``cfg.dtype``; raises unless every layer's
    leaves have the shapes ``cfg`` gives them."""
    dev = resolve_device(device)
    dims = gnn.layer_dims(cfg)
    if len(params) != len(dims):
        raise ValueError(f"{len(params)} layers, expected {len(dims)}")
    out = []
    for i, (layer, (d_in, dh)) in enumerate(zip(params, dims)):
        want = {"W": (d_in, cfg.n_heads * dh), "a_src": (cfg.n_heads, dh),
                "a_dst": (cfg.n_heads, dh)}
        got = {k: np.asarray(v).shape for k, v in layer.items()}
        if got != want:
            raise ValueError(f"layer {i}: shapes {got}, expected {want}")
        out.append({k: torch.from_numpy(
            np.array(v, dtype=np.float32)).to(dev, cfg.dtype)
            for k, v in layer.items()})
    return out


def _tree_from_numpy(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_from_numpy(v, dev) for v in tree)
    return _tensor(tree, dev)


def opt_state_from_numpy(state, device=None):
    """The port's optimizer state of ``state``'s class name (its step an
    int32 0-d tensor, its trees of tensors) from a ``repro`` one with
    numpy leaves."""
    dev = resolve_device(device)
    cls = getattr(optimizer, type(state).__name__)
    return cls(*(_tree_from_numpy(getattr(state, f), dev)
                 for f in cls._fields))
