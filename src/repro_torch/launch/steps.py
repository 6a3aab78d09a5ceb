"""Per-cell steps (``repro.launch.steps``).

``build_cell(arch_id, shape, mesh)`` returns a :class:`CellBundle` for
every cell of ``configs.all_cells()``: the cell's step, each argument's
local ``(shape, dtype)`` on this rank and its partition specs, allocating
nothing (``repro`` builds abstract ``ShapeDtypeStruct`` arguments).
``mesh`` is a ``launch.mesh.Mesh``; a description (``mesh_spec``) gives
the shapes, a mesh made by ``make_mesh`` with a ``device_type`` also runs
the steps.

The LM decode cells are ``distributed.decode_shard``'s step on each
rank's local tensors (their layout, standard, tiny batch or f-sharded,
follows ``repro``'s rules; with ``kv_quant`` the caches are int8 codes
with f32 scales ``[..., S]``).

Every other cell is a global program, as ``repro``'s ``jax.jit`` cells
are: its step takes and returns DTensors on the mesh's ``DeviceMesh``
(``CellBundle.to_args`` wraps a rank's local tensors), and runs a body
on each rank's local shards, where ``repro`` lets GSPMD partition it:

  LM train     ``cfg.microbatches`` splits of the global batch (the batch
               dim redistributed onto the batch axes in each split), the
               gradients of ``models.transformer.lm_loss`` as one rank of
               the tensor-parallel mesh (``distributed.spmd.Axes``)
               accumulated in the ZeRO layout (``zero_specs``; f32, or
               bf16 under Adafactor), one update of their mean: Adafactor
               (bf16 momentum) past 100e9 parameters, else AdamW at lr
               3e-4 (f32 moments), on the parameters redistributed to the
               ZeRO layout and back;
  LM prefill   ``transformer.lm_prefill`` on the rank, in the decode
               layout, or the f-sharded one where
               ``decode_shard.fsharded``; logits on
               ``P(batch, "model")``, caches on ``decode_shard.cache_spec``;
  recsys       the batch data-parallel, the row-split tables looked up
               row-parallel over "model" (``models.recsys.embedding``:
               each rank its own rows, summed), the towers gathered
               whole (DCN-v2's deep tower is split over "model"): train
               is one Adagrad step (SASRec, BERT4Rec and MIND in 8
               microbatches from 65536 rows), its gradients reduced onto
               the parameters' layout; serve_bulk runs in chunks of
               16384 rows; retrieval_cand scores the query against its
               slab of candidates, split over every axis (each rank
               scores its "model" group's slabs and keeps its own);
  GNN          ``gnn_train_step`` over ``mesh.col(all axes)``: node rows
               and destination-blocked edges on ``P(axes)``;
  bandit       ``distributed.distclub_shard``'s epoch over ``mesh.col(all
               axes)`` at ``distclub_paper``'s 20480 users, d = 25, rows
               on ``P(axes)``.

The flash and cross kernels run inside these bodies on each rank's own
shard (``kernels.flash.ops.attention`` from ``models.attention``,
``kernels.cross.ops.cross_layer`` from ``models.recsys.dcn_v2``), as
``choose``, ``rank1_update_inv``, ``prune`` and ``cc_hop`` do in the
bandit epoch.

``gnn_train_step`` is the body of ``repro``'s ``build_gnn_cell``
``local_step``, run by each rank on its node rows and its destination
block of edges (``models.gnn.gat_loss_local``): the gradient of the
rank's loss, the mean of the gradients over the ranks (``repro``'s
``pmean``), then AdamW at lr 5e-3 on the replicated parameters.  One
process passes ``runtime.collectives.NullCollectives()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .. import configs
from ..core.types import Metrics
from ..distributed import decode_shard, spmd
from ..distributed.sharding import (P, hint, hint_mesh, map_specs,
                                    placements, shard, shard_shape,
                                    zero_specs)
from ..models import gnn, layers, transformer
from ..models.recsys import dcn_v2, embedding, mind, seqrec
from ..train import optimizer
from ..tree import tree_leaves, tree_map
from .mesh import all_axes, batch_axes, batch_spec
from .train import value_and_grad

SERVE_CHUNK = 16_384        # serve_bulk rows a chunk, as ``repro``'s


@dataclasses.dataclass
class CellBundle:
    arch_id: str
    shape: str
    kind: str
    step_fn: Callable             # positional args
    local_args: tuple             # (shape, dtype) trees, this rank's
    arg_specs: tuple              # each argument's partition specs
    note: str = ""
    global_args: tuple = ()       # (shape, dtype) trees, whole; a global
                                  # program's (not the decode cells')
    mesh: object = None

    def to_args(self, local_trees, first: int = 0) -> tuple:
        """The step's arguments ``first``, ``first + 1``, ... from this
        rank's local tensors (trees of ``local_args``' shapes): DTensors
        on the mesh's ``DeviceMesh``."""
        if not self.global_args:
            raise ValueError(f"{self.arch_id} {self.shape}: the step takes "
                             "local tensors")
        return tuple(map_specs(lambda s, t, sd: _dt(t, s, sd[0], self.mesh),
                               spec, tree, full)
                     for spec, tree, full in zip(self.arg_specs[first:],
                                                 local_trees,
                                                 self.global_args[first:]))

    def from_full(self, full_trees, first: int = 0) -> tuple:
        """The same from whole tensors (each rank's piece cut by
        ``sharding.shard``)."""
        return self.to_args(tuple(
            map_specs(lambda s, t: shard(t, s, self.mesh), spec, tree)
            for spec, tree in zip(self.arg_specs[first:], full_trees)),
            first)


def _contiguous_stride(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def _dt(local, spec, full_shape, mesh, partial=()):
    """A DTensor of ``full_shape`` from this rank's ``local`` piece under
    ``spec`` (``Partial`` on the axes of ``partial`` the spec leaves
    free)."""
    from torch.distributed.tensor import DTensor

    dm = mesh.device_mesh
    return DTensor.from_local(
        local, dm, placements(spec, dm, partial), run_check=False,
        shape=torch.Size(full_shape), stride=_contiguous_stride(full_shape))


def _local(x):
    return x.to_local()


def _redistribute(x, spec):
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def _local_shapes(specs, shapes, mesh):
    return map_specs(lambda s, sd: (shard_shape(sd[0], s, mesh), sd[1]),
                     specs, shapes)


def _bundle(spec, shape, kind, step, specs, shapes, mesh) -> CellBundle:
    return CellBundle(
        spec.arch_id, shape, kind, step,
        tuple(_local_shapes(s, sd, mesh) for s, sd in zip(specs, shapes)),
        tuple(specs), note=spec.shapes[shape].note,
        global_args=tuple(shapes), mesh=mesh)


def _zeros(shape, dtype, spec, mesh, device):
    return _dt(torch.zeros(shard_shape(shape, spec, mesh), dtype=dtype,
                           device=device), spec, shape, mesh)


def _replicated_loss(share, mesh, ba):
    """The global loss from each rank's share (summed over the batch
    axes), replicated."""
    return _redistribute(_dt(share, P(), (), mesh, partial=ba), P())


def _split_rows(x, n: int, ba):
    """``x`` [B, ...] as [n, B / n, ...] with dim 1 on the batch axes:
    split ``i`` is the global rows ``[i B / n, (i + 1) B / n)``, each
    split's rows spread over the batch axes (``repro``'s sharding
    constraint on the microbatch or chunk split)."""
    nb = math.prod(x.device_mesh.size(x.device_mesh.mesh_dim_names.index(a))
                   for a in ba)
    if n % nb:
        # the split dim cannot carry the rows' sharding: gather them first
        x = _redistribute(x, P())
    return _redistribute(x.reshape(n, x.shape[0] // n, *x.shape[1:]),
                         P(None, ba))


def _by_shape(p_shapes, z_specs, tree):
    """``repro``'s ``opt_shardings``: an optimizer leaf takes the ZeRO
    spec of the first parameter (in pytree order) of its shape, else
    replicated."""
    def leaves(t):      # a dict tree's leaves in pytree order, keys sorted
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        return [t]

    first = {}
    for sd, s in zip(leaves(p_shapes), leaves(z_specs)):
        first.setdefault(tuple(sd[0]), s)
    return _map_shapes(lambda sd: first.get(tuple(sd[0]), P()), tree)


def _map_shapes(fn, tree):
    """``fn`` over a tree whose leaves are ``(shape, dtype)`` pairs."""
    if isinstance(tree, dict):
        return {k: _map_shapes(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_shapes(fn, v) for v in tree))
    if isinstance(tree, list):
        return [_map_shapes(fn, v) for v in tree]
    return fn(tree)


# --- LM family -------------------------------------------------------------


def _adamw_shapes(shapes):
    return optimizer.AdamWState(
        step=((), torch.int32),
        m=_map_shapes(lambda sd: (sd[0], torch.float32), shapes),
        v=_map_shapes(lambda sd: (sd[0], torch.float32), shapes))


def _adafactor_shapes(shapes):
    f32 = torch.float32

    def vr(sd):
        s = sd[0]
        return (tuple(s[:-1]) if len(s) >= 2 else (1,), f32)

    def vc(sd):
        s = sd[0]
        return (tuple(s[:-2]) + tuple(s[-1:]) if len(s) >= 2 else (1,), f32)

    def v(sd):
        return ((1,) if len(sd[0]) >= 2 else tuple(sd[0]), f32)

    return optimizer.AdafactorState(
        step=((), torch.int32), vr=_map_shapes(vr, shapes),
        vc=_map_shapes(vc, shapes), v=_map_shapes(v, shapes),
        m=_map_shapes(lambda sd: (sd[0], torch.bfloat16), shapes))


def _lm_train(spec, shape, mesh, cfg, inputs):
    ba = batch_axes(mesh)
    p_specs = transformer.lm_specs(cfg)
    shapes = transformer.param_shapes(cfg)
    z_specs = zero_specs(p_specs, shapes, mesh.shape["data"])
    adafactor = cfg.param_count() > 100e9
    if adafactor:
        opt_shapes = _adafactor_shapes(shapes)
        update = optimizer.adafactor_update
    else:
        opt_shapes = _adamw_shapes(shapes)

        def update(g, o, p):
            return optimizer.adamw_update(g, o, p, lr=3e-4)
    opt_specs = _by_shape(shapes, z_specs, opt_shapes)
    acc_dt = torch.bfloat16 if adafactor else torch.float32
    mb = cfg.microbatches
    tok = inputs["tokens"]
    if tok[0][0] % mb:
        raise ValueError(f"batch {tok[0][0]} over {mb} microbatches")

    def step(params, opt, tokens, labels):
        ax = spmd.axes(mesh, ba)
        dev = tokens.to_local().device
        with hint_mesh(mesh):
            tb = _split_rows(tokens, mb, ba).to_local()
            lb = _split_rows(labels, mb, ba).to_local()
            model = transformer.LM.of(cfg, tree_map(_local, params))
            model.requires_grad_(True)
            leaves = model.tree()
            g_acc = map_specs(
                lambda s, sd: _zeros(sd[0], acc_dt, s, mesh, dev),
                z_specs, shapes)
            shares = []
            for i in range(mb):
                share, grads = value_and_grad(
                    transformer.lm_loss, leaves, model, tb[i], lb[i], ax,
                    tok[0][0] // mb)
                # in place: a second accumulator would double its bytes
                map_specs(lambda s, a, g, sd, z: a.add_(hint(
                    _dt(g, s, sd[0], mesh, partial=ba), *z).to(a.dtype)),
                    p_specs, g_acc, grads, shapes, z_specs)
                del grads
                shares.append(share)
            del model, leaves
            loss = _replicated_loss(torch.stack(shares).mean(), mesh, ba)
            tree_map(lambda g: g.div_(mb), g_acc)
            p_z = map_specs(lambda z, p: hint(p, *z), z_specs, params)
            p_z, opt = update(g_acc, opt, p_z)
            params = map_specs(lambda s, p: hint(p, *s), p_specs, p_z)
        return params, opt, loss

    tok_spec = batch_spec(mesh, 2)
    return _bundle(spec, shape, "train", step,
                   (p_specs, opt_specs, tok_spec, tok_spec),
                   (shapes, opt_shapes, tok, inputs["labels"]), mesh)


def _lm_prefill(spec, shape, mesh, cfg, inputs):
    ba = batch_axes(mesh)
    fshard = decode_shard.fsharded(cfg, mesh.shape["model"])
    p_specs = (decode_shard.lm_specs_fshard(cfg) if fshard
               else decode_shard.decode_param_specs(cfg))
    shapes = transformer.param_shapes(cfg)
    tok = inputs["tokens"]
    B, S = tok[0]
    cache = (cfg.n_blocks, cfg.block_layers, B, cfg.n_kv_heads, S,
             cfg.d_head)
    c_spec = decode_shard.cache_spec(ba)

    @torch.no_grad()
    def step(params, tokens):
        logits, (kc, vc) = transformer.lm_prefill(
            transformer.LM.of(cfg, tree_map(_local, params)),
            tokens.to_local(), spmd.axes(mesh, ba), B)
        return (_dt(logits, P(ba, "model"), (B, cfg.vocab), mesh),
                (_dt(kc, c_spec, cache, mesh), _dt(vc, c_spec, cache, mesh)))

    return _bundle(spec, shape, "serve", step,
                   (p_specs, batch_spec(mesh, 2)), (shapes, tok), mesh)


def build_lm_cell(spec, shape: str, mesh, kv_quant: bool = False,
                  device=None) -> CellBundle:
    """An LM cell on ``mesh``, seen from its rank; the decode step's
    pieces go to ``device`` (default cuda, as ``build_decode_step``)."""
    cfg = spec.cell_cfg(shape)
    cell = spec.shapes[shape]
    inputs = spec.input_specs(shape)
    if cell.kind == "train":
        return _lm_train(spec, shape, mesh, cfg, inputs)
    if cell.kind == "serve":
        return _lm_prefill(spec, shape, mesh, cfg, inputs)
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


# --- GNN family ------------------------------------------------------------


def _gat_shapes(cfg) -> list:
    return [{"W": ((d_in, cfg.n_heads * dh), cfg.dtype),
             "a_src": ((cfg.n_heads, dh), cfg.dtype),
             "a_dst": ((cfg.n_heads, dh), cfg.dtype)}
            for d_in, dh in gnn.layer_dims(cfg)]


def build_gnn_cell(spec, shape: str, mesh) -> CellBundle:
    """GAT train step: node rows over every mesh axis, edges partitioned
    by destination block (every dst in the rank's node rows), parameters
    and moments replicated."""
    cfg = spec.cell_cfg(shape)
    inputs = spec.input_specs(shape)
    axes = all_axes(mesh)
    shapes = _gat_shapes(cfg)
    p_specs = _map_shapes(lambda _: P(), shapes)
    opt_shapes = optimizer.AdamWState(step=((), torch.int32), m=shapes,
                                      v=shapes)
    opt_specs = optimizer.AdamWState(step=P(), m=p_specs, v=p_specs)
    names = ("feats", "src", "dst", "labels", "mask")
    in_specs = (P(axes, None),) + (P(axes),) * 4

    def step(params, opt, feats, src, dst, labels, mask):
        lp, lo = tree_map(_local, params), tree_map(_local, opt)
        lp, lo, loss = gnn_train_step(
            lp, lo, cfg, *(_local(t) for t in (feats, src, dst, labels,
                                               mask)), mesh.col(axes))
        wrap = [map_specs(lambda s, t, sd: _dt(t.detach(), s, sd[0], mesh),
                          sp, tr, sh)
                for sp, tr, sh in ((p_specs, lp, shapes),
                                   (opt_specs, lo, opt_shapes))]
        return wrap[0], wrap[1], _dt(loss.detach(), P(), (), mesh)

    return _bundle(spec, shape, "train", step,
                   (p_specs, opt_specs, *in_specs),
                   (shapes, opt_shapes, *(inputs[n] for n in names)), mesh)


# --- recsys family ---------------------------------------------------------


_RECSYS = {
    "dcn-v2": (dcn_v2.DCNv2, dcn_v2.dcn_specs, dcn_v2.param_shapes),
    "sasrec": (seqrec.SeqRec, seqrec.seqrec_specs, seqrec.param_shapes),
    "bert4rec": (seqrec.SeqRec, seqrec.seqrec_specs, seqrec.param_shapes),
    "mind": (mind.MIND, mind.mind_specs, mind.param_shapes),
}


def _as_model(cls, cfg, tree):
    """A model object of ``cls`` holding ``tree``'s tensors (no draw)."""
    model = cls.__new__(cls)
    layers.Params.__init__(model, tree)
    model.cfg = cfg
    return model


_TABLES = ("tables", "item_embed")     # the row-split embedding leaves


def _rank_model(cls, cfg, params, ax):
    """A model of ``cls`` on this rank: the tables its own rows, looked up
    row-parallel over ``ax``'s "model", every other leaf gathered whole
    (local tensors)."""
    from torch.distributed.tensor import Replicate

    def whole(p):
        return p.redistribute(p.device_mesh,
                              [Replicate()] * p.device_mesh.ndim).to_local()

    model = _as_model(cls, cfg, {
        k: tree_map(_local if k in _TABLES else whole, v)
        for k, v in params.items()})
    model.ax = ax
    return model


def _held_specs(p_specs):
    """The layout a rank's gradient comes in: its rows of the tables,
    every other leaf whole."""
    return {k: v if k in _TABLES else map_specs(lambda s, _: P(), v, v)
            for k, v in p_specs.items()}


def _negatives(seed, cfg, device):
    """The step's shared negatives, drawn from a generator seeded by the
    cell's ``seed`` (the same on every rank)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return embedding.draw_negatives(gen, cfg.n_negatives, cfg.n_items,
                                    device)


def _recsys_train(spec, shape, mesh, cfg, inputs, cls, p_specs, shapes):
    arch = spec.arch_id
    ba = batch_axes(mesh)
    opt_specs = optimizer.AdagradState(accum=p_specs)
    opt_shapes = optimizer.AdagradState(
        accum=_map_shapes(lambda sd: (sd[0], torch.float32), shapes))

    if arch == "dcn-v2":
        names = ("dense_feats", "sparse_ids", "labels")
        in_specs = (batch_spec(mesh, 2), batch_spec(mesh, 2),
                    batch_spec(mesh, 1))
        mb = 1
    else:
        names = ("hist", "targets", "seed")
        in_specs = (batch_spec(mesh, 2),
                    batch_spec(mesh, len(inputs["targets"][0])), P())
        mb = 8 if inputs["hist"][0][0] >= 65_536 else 1

    def share_of(model, rows, negatives, ax):
        """This rank's share of the global loss on its rows."""
        if arch == "dcn-v2":
            loss = dcn_v2.dcn_loss(model, *rows)
        elif arch == "mind":
            loss = mind.mind_loss(model, *rows, negatives=negatives)
        else:
            loss = seqrec.sampled_softmax_loss(model, *rows,
                                               negatives=negatives)
            if ax.nb > 1:
                # the loss is a weighted mean over every rank's rows
                w = (rows[1] > 0).sum().float()
                w_all = spmd.psum(w, ax.batch)
                return loss * torch.clamp_min(w, 1.0) / torch.clamp_min(
                    w_all, 1.0)
        return loss / ax.nb

    held = _held_specs(p_specs)

    def step(params, opt, *batch):
        ax = spmd.axes(mesh, ba)
        model = _rank_model(cls, cfg, params, ax).requires_grad_(True)
        leaves = model.tree()
        dev = tree_leaves(leaves)[0].device
        with hint_mesh(mesh):
            negatives = None
            if arch == "dcn-v2":
                data = [tuple(_local(t) for t in batch)]
            else:
                hist, targets, seed = batch
                hs = _split_rows(hist, mb, ba).to_local()
                ts = _split_rows(targets, mb, ba).to_local()
                data = [(hs[i], ts[i]) for i in range(mb)]
                negatives = _negatives(_local(seed), cfg, dev)
            acc, shares = None, []
            for rows in data:
                share, grads = value_and_grad(
                    lambda *a: share_of(model, a, negatives, ax), leaves,
                    *rows)
                grads = tree_map(lambda g: g.float(), grads)
                acc = grads if acc is None else tree_map(torch.add, acc,
                                                         grads)
                shares.append(share)
            loss = _replicated_loss(torch.stack(shares).mean(), mesh, ba)
            if mb > 1:
                acc = tree_map(lambda g: g / mb, acc)
            g = map_specs(lambda s, h, t, sd: hint(
                _dt(t, h, sd[0], mesh, partial=ba), *s),
                p_specs, held, acc, shapes)
            params, opt = optimizer.adagrad_update(g, opt, params)
        return params, opt, loss

    return _bundle(spec, shape, "train", step,
                   (p_specs, opt_specs, *in_specs),
                   (shapes, opt_shapes, *(inputs[n] for n in names)), mesh)


def build_recsys_cell(spec, shape: str, mesh) -> CellBundle:
    cfg = spec.cell_cfg(shape)
    cell = spec.shapes[shape]
    inputs = spec.input_specs(shape)
    ba = batch_axes(mesh)
    arch = spec.arch_id
    cls, specs_fn, shapes_fn = _RECSYS[arch]
    p_specs, shapes = specs_fn(cfg), shapes_fn(cfg)
    if cell.kind == "train":
        return _recsys_train(spec, shape, mesh, cfg, inputs, cls, p_specs,
                             shapes)

    if arch == "dcn-v2":
        names = ("dense_feats", "sparse_ids")
        in_specs = (batch_spec(mesh, 2),) * 2
        B = inputs["dense_feats"][0][0]
        out_spec, out_shape = P(ba), (B,)

        def body(model, dense, sparse):
            return dcn_v2.dcn_fwd(model, dense, sparse)
    elif shape == "retrieval_cand":
        names = ("hist", "cand")
        axes = all_axes(mesh)
        in_specs = (P(None, None), P(axes))
        out_spec, out_shape = P(axes), inputs["cand"][0]
        retr = (mind.mind_retrieval if arch == "mind"
                else seqrec.retrieval_scores)

        def body(model, hist, cand):
            # the lookup sums rows over "model": every rank of the group
            # looks up the group's candidates
            ax, n = model.ax, cand.shape[0]
            out = retr(model, hist, spmd.gather_nograd(cand, 0, ax.model))
            return out[ax.r * n:(ax.r + 1) * n]
    else:
        names = ("hist", "cand")
        in_specs = (batch_spec(mesh, 2),) * 2
        B, C = inputs["cand"][0]
        out_spec, out_shape = P(ba, None), (B, C)
        serve = (mind.mind_serve if arch == "mind"
                 else seqrec.score_candidates)
        body = serve

    chunks = (shape == "serve_bulk" and arch != "dcn-v2"
              and out_shape[0] > SERVE_CHUNK)

    @torch.no_grad()
    def step(params, *batch):
        model = _rank_model(cls, cfg, params, spmd.axes(mesh, ba))
        if not chunks:
            return _dt(body(model, *(_local(t) for t in batch)), out_spec,
                       out_shape, mesh)
        n = out_shape[0] // SERVE_CHUNK
        hb, cb = (_split_rows(t, n, ba).to_local() for t in batch)
        out = torch.stack([body(model, hb[i], cb[i]) for i in range(n)])
        return _dt(out, P(None, ba, None), (n, SERVE_CHUNK, out_shape[1]),
                   mesh).reshape(out_shape)

    return _bundle(spec, shape, "serve", step, (p_specs, *in_specs),
                   (shapes, *(inputs[n] for n in names)), mesh)


# --- bandit (the paper's own cell) -----------------------------------------


def build_bandit_cell(spec, shape: str, mesh, device=None,
                      ops=None) -> CellBundle:
    """One DistCLUB epoch (``distclub_shard.build_epoch_fn``) over every
    mesh axis; the step takes the state and ``key`` = (seed, epoch).
    ``ops`` is the environment (default: ``env_ops``' planted synthetic
    one)."""
    from ..configs import distclub_paper as dp
    from ..distributed import distclub_shard

    inputs = spec.input_specs(shape)
    axes = all_axes(mesh)
    rows, rep = P(axes), P()
    specs = distclub_shard.ShardedDistCLUB(
        Minv=rows, b=rows, occ=rows, adj=rows, labels=rep, u_rounds=rows,
        c_rounds=rows, comm_bytes=rep)
    shapes = distclub_shard.ShardedDistCLUB(
        **{f: inputs[f] for f in distclub_shard.ShardedDistCLUB._fields})
    built = {}

    def step(state, key):
        if "epoch" not in built:
            built["epoch"] = distclub_shard.build_epoch_fn(
                mesh.col(axes), dp.N_USERS, dp.D_FEAT, spec.cfg, ops=ops,
                device=device)
        seed, e = (int(v) for v in _local(key).tolist())
        new, metrics, n_clusters = built["epoch"](
            distclub_shard.ShardedDistCLUB(*(_local(t) for t in state)),
            seed, e)
        new = map_specs(lambda s, t, sd: _dt(t, s, sd[0], mesh), specs, new,
                        shapes)
        return new, Metrics(*metrics), n_clusters

    return _bundle(spec, shape, "bandit_epoch", step, (specs, P()),
                   (shapes, inputs["key"]), mesh)


# --- dispatcher ------------------------------------------------------------


def build_cell(arch_id: str, shape: str, mesh, kv_quant: bool = False,
               device=None) -> CellBundle:
    """Cell ``(arch_id, shape)`` on ``mesh``; ``device`` is where the
    decode and bandit steps build their pieces (default cuda)."""
    spec = configs.get(arch_id)
    if spec.family == "lm":
        return build_lm_cell(spec, shape, mesh, kv_quant=kv_quant,
                             device=device)
    if spec.family == "gnn":
        return build_gnn_cell(spec, shape, mesh)
    if spec.family == "recsys":
        return build_recsys_cell(spec, shape, mesh)
    return build_bandit_cell(spec, shape, mesh, device=device)


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
