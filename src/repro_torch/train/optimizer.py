"""Optimizers (``repro.train.optimizer``): AdamW with a chosen moment
dtype, Adafactor (factored second moment) and Adagrad (the recsys
archs' embedding tables).

Each works on trees shaped like ``repro``'s pytrees (``repro_torch.tree``:
nested dicts and lists of tensors, e.g. ``Params.tree()``), and its state
is a NamedTuple of such trees with ``repro``'s fields, so a checkpoint
(``train.checkpoint``) writes ``repro``'s keys.  The math is ``repro``'s,
in f32, each result cast back to its leaf's dtype; the bias corrections
``1 - b ** t`` are f32 tensors on the device, as ``repro`` takes them from
the f32 step.  Unlike ``repro``'s, an update works in place under
``torch.no_grad()``: the parameter, moment and accumulator tensors given
are overwritten, and the same trees come back (with a new ``step``).

A leaf of rank >= 3 over ``_CHUNK_BYTES`` as f32 (the LMs' stacked
[n_blocks, ...] leaves) is updated one slice of dim 0 at a time
(``_on_pieces``), as ``repro`` ``lax.map``s it: the f32 temporaries of the
update then cover one block, not the whole stack (Qwen3-4B's FFN leaves
are [36, 2560, 9728]: 3.6 GB a temporary whole, 100 MB a slice).
Elementwise updates come out bit-equal either way; Adafactor's update
RMS is taken per slice, as ``repro``'s is.

Given DTensor leaves (the LM train cells' ZeRO layout, ``launch.steps``),
AdamW and Adafactor update this rank's own piece of each leaf, where
``repro`` lets GSPMD partition the update (``_on_pieces``).  A moment
laid out otherwise than its parameter (``repro``'s ``opt_shardings`` give
a leaf the layout of the first parameter of its shape) is brought to the
parameter's layout and back: where the two swap two mesh dims' splits,
by an exchange with one other rank, slice by slice (``_Moment``); else
redistributed whole.  Adafactor's means
are the piece's partial sums, summed over the ranks that split the
reduced dims; its factors ``vr``/``vc`` keep their own layout (whole on
every rank, as a rule; one split is gathered a slice at a time,
``_Whole``): the rank reads the rows and columns its piece covers, and
assembles the new factors whole from every rank's.  No
temporary then holds more than the rank's piece of the slice being
updated, in f32.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..runtime.collectives import bind
from ..tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


# Leaves bigger than this, as f32, are updated slice by slice over dim 0.
_CHUNK_BYTES = 128 * 1024 * 1024


def _chunks(p) -> bool:
    """Whether leaf ``p`` (its whole shape) is updated slice by slice."""
    return p.dim() >= 3 and p.numel() * 4 > _CHUNK_BYTES


class _Piece:
    """Where this rank's piece of a leaf lies: the whole leaf's
    ``shape``, the piece's ``start`` in each dim and, for each dim, the
    mesh dims that split it (``split``).  A plain tensor is one whole
    piece, and its means are ``torch.mean``'s."""

    def __init__(self, shape, mesh=None, placements=()):
        self.shape, self.mesh = tuple(shape), mesh
        self.placements = tuple(placements)
        self.split = [[] for _ in self.shape]
        self.start = [0] * len(self.shape)
        for i, pl in enumerate(self.placements):
            if pl.is_shard() and mesh.size(i) > 1:
                self.split[pl.dim].append(i)
        if self.whole:
            return
        # DTensor's split: each mesh dim in turn cuts the dim in chunks
        self.size, coord = list(self.shape), mesh.get_coordinate()
        for i, pl in enumerate(self.placements):
            if pl.is_shard():
                d, n = pl.dim, mesh.size(i)
                chunk = -(-self.size[d] // n)
                lo = min(coord[i] * chunk, self.size[d])
                self.start[d] += lo
                self.size[d] = min(chunk, self.size[d] - lo)

    @property
    def whole(self) -> bool:
        return not any(self.split)

    def row(self, i: int) -> "_Piece":
        """The piece of the leaf's slice ``start[0] + i`` of dim 0."""
        out = _Piece(self.shape[1:])
        if not self.whole:
            out.mesh, out.split = self.mesh, self.split[1:]
            out.start, out.size = self.start[1:], self.size[1:]
        return out

    def _dims(self, dims) -> list:
        return sorted(d % len(self.shape) for d in dims)

    def _psum(self, x, dims):
        """``x`` summed over the ranks that split the leaf's ``dims``."""
        for md in sorted({md for d in self._dims(dims)
                          for md in self.split[d]}):
            x = bind(self.mesh.get_group(md)).psum(x)
        return x

    def mean(self, x, over, dims=None, keepdim=False):
        """The mean of ``x`` (the piece's values, or made from them) over
        its ``dims`` (default ``over``), which span the leaf's dims
        ``over``."""
        dims = over if dims is None else dims
        if self.whole:
            return torch.mean(x, dim=dims, keepdim=keepdim)
        s = self._psum(x.sum(dim=dims, keepdim=keepdim), over)
        return s / math.prod(self.shape[d] for d in self._dims(over))

    def region(self, t, dims):
        """The piece's part of ``t``, a whole tensor over the leaf's
        ``dims``."""
        if self.whole:
            return t
        for i, d in enumerate(self._dims(dims)):
            t = t.narrow(i, self.start[d], self.size[d])
        return t

    def assemble(self, x, dims):
        """The whole tensor over the leaf's ``dims`` from every rank's
        region ``x``, on every rank."""
        if self.whole:
            return x
        dims = self._dims(dims)
        out = x.new_zeros([self.shape[d] for d in dims])
        self.region(out, dims).copy_(x)
        # the ranks that split the other dims hold the same region
        return self._psum(out, dims)


def _dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _local(x):
    return x.to_local() if _dtensor(x) else x


def _as(local, like, placements):
    """A DTensor of ``like``'s shape on its mesh from this rank's
    ``local`` piece under ``placements``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def _swap_partner(x, placements, rows: bool):
    """The rank whose piece of ``x`` is this rank's piece in the layout
    ``placements``, where the two layouts swap the splits of two mesh
    dims of one size (each the only split of its dim, and not dim 0 when
    the update goes by ``rows``); else None.  ``repro``'s
    ``opt_shardings`` lay out ``wq``'s moments as ``wo``'s so."""
    xp, dm = x.placements, x.device_mesh
    diff = [i for i in range(len(xp)) if xp[i] != placements[i]]
    if len(diff) != 2:
        return None
    i, j = diff
    dims = {xp[i].dim, xp[j].dim} if xp[i].is_shard() and \
        xp[j].is_shard() else set()
    if (xp[i] != placements[j] or xp[j] != placements[i] or len(dims) != 2
            or dm.size(i) != dm.size(j) or (rows and 0 in dims)
            or sum(q.is_shard() and q.dim in dims for q in xp) != 2):
        return None
    coord = list(dm.get_coordinate())
    coord[i], coord[j] = coord[j], coord[i]
    rank = 0            # init_device_mesh lays the ranks out row-major
    for c, n in zip(coord, dm.shape):
        rank = rank * n + c
    return rank


def _exchange(t, peer: int):
    """``t`` sent to rank ``peer``, and what ``peer`` sent back."""
    import torch.distributed as dist

    if peer == dist.get_rank():
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, peer),
                                        dist.P2POp(dist.irecv, out, peer)]):
        work.wait()
    return out


class _Moment:
    """A leaf of ``p``'s shape read, and written back, in ``p``'s layout:
    its own local tensor where the layouts agree; the piece of the rank at
    the swapped coordinates, point to point (slice by slice where the
    update goes so, ``rows``), where they swap two mesh dims' splits
    (``_swap_partner``); else redistributed whole."""

    def __init__(self, x, p, rows: bool):
        self.x, self.local, self.peer, self.moved = x, _local(x), None, None
        if not _dtensor(x) or x.placements == p.placements:
            return
        self.peer = _swap_partner(x, p.placements, rows)
        if self.peer is None:
            self.moved = p.placements
            self.local = _local(x.redistribute(x.device_mesh, self.moved))

    def get(self, i=None):
        """The piece (slice ``i`` of dim 0 of it)."""
        t = self.local if i is None else self.local[i]
        return t if self.peer is None else _exchange(t, self.peer)

    def put(self, value, i=None) -> None:
        """Write back ``value``, the piece ``get(i)`` gave, updated."""
        if self.peer is not None:
            t = self.local if i is None else self.local[i]
            t.copy_(_exchange(value, self.peer))

    def close(self) -> None:
        if self.moved is not None:
            _local(self.x).copy_(_local(
                _as(self.local, self.x, self.moved).redistribute(
                    self.x.device_mesh, self.x.placements)))


class _Whole:
    """A leaf read whole on every rank (Adafactor's factors), slice ``j``
    of dim 0 at a time where the update goes so, and written back: its
    own local tensor where nothing splits it, else gathered."""

    def __init__(self, x):
        self.x, self.local = x, _local(x)
        self.own = _Piece(x.shape, x.device_mesh, x.placements) \
            if _dtensor(x) else _Piece(x.shape)

    def get(self, j=None):
        if self.own.whole:
            return self.local if j is None else self.local[j]
        return (self.x if j is None else self.x[j]).full_tensor()

    def put(self, value, j=None) -> None:
        """Write back ``value``, the whole ``get(j)`` gave, updated."""
        own = self.own
        if own.whole:
            return
        if j is None:
            self.local.copy_(own.region(value, range(value.dim())))
            return
        k = j - own.start[0]
        if 0 <= k < own.size[0]:
            self.local[k].copy_(own.row(k).region(value,
                                                  range(value.dim())))


def _on_pieces(upd, p, moments=(), wholes=()) -> None:
    """``upd(pc, p, *moments, *wholes)`` in place on this rank's piece
    ``p`` of a parameter (``pc`` its :class:`_Piece`), the pieces of its
    ``moments`` in its layout and its ``wholes`` whole (a plain tensor is
    its own whole piece); slice by slice over dim 0 for huge stacked
    leaves."""
    pc = _Piece(p.shape, p.device_mesh, p.placements) if _dtensor(p) \
        else _Piece(p.shape)
    rows = _chunks(p)
    ms = [_Moment(x, p, rows) for x in moments]
    ws = [_Whole(x) for x in wholes]
    pl = _local(p)
    for i in range(pl.shape[0]) if rows else (None,):
        j = None if i is None else pc.start[0] + i
        parts = [m.get(i) for m in ms]
        whole = [w.get(j) for w in ws]
        upd(pc if i is None else pc.row(i), pl if i is None else pl[i],
            *parts, *whole)
        for m, part in zip(ms, parts):
            m.put(part, i)
        for w, part in zip(ws, whole):
            w.put(part, j)
    for m in ms:
        m.close()


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def adamw_init(params, moment_dtype=torch.float32) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr=1e-3, b1=0.9,
                 b2=0.999, eps=1e-8, weight_decay=0.01):
    step = state.step + 1
    t = _local(step).float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t

    def upd(pc, p, g, m, v):
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        del gf
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        m.copy_(m_new)
        v.copy_(v_new)
        del m_new, v_new
        pf = p.float()
        p.copy_(pf - lr * (delta + weight_decay * pf))

    tree_map(lambda g, m, v, p: _on_pieces(upd, p, (g, m, v)),
             grads, state.m, state.v, params)
    return params, AdamWState(step=step, m=state.m, v=state.v)


class AdafactorState(NamedTuple):
    """Factored second moment (Shazeer & Stern, arXiv:1804.04235) and a
    low-precision momentum."""

    step: torch.Tensor
    vr: Any      # row factors  (mean over the last dim)
    vc: Any      # col factors  (mean over the second-to-last dim)
    v: Any       # full second moment of rank < 2 leaves
    m: Any       # momentum


def _factored(p) -> bool:
    return p.dim() >= 2


def adafactor_init(params, momentum_dtype=torch.bfloat16) -> AdafactorState:
    def zeros(shape, p, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=p.device)

    def vr(p):
        return zeros(p.shape[:-1] if _factored(p) else (1,), p)

    def vc(p):
        return zeros(p.shape[:-2] + p.shape[-1:] if _factored(p) else (1,),
                     p)

    def v(p):
        return zeros((1,) if _factored(p) else p.shape, p)

    return AdafactorState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        vr=tree_map(vr, params), vc=tree_map(vc, params),
        v=tree_map(v, params),
        m=tree_map(lambda p: zeros(p.shape, p, momentum_dtype), params))


@torch.no_grad()
def adafactor_update(grads, state: AdafactorState, params, *, lr=1e-3,
                     decay=0.999, beta1=0.9, eps=1e-30, clip_rms=1.0):
    step = state.step + 1

    def clipped_step(pc, u, m, p):
        rms = torch.sqrt(pc.mean(u * u, tuple(range(u.dim()))) + eps)
        u = u / torch.clamp_min(rms / clip_rms, 1.0)
        m_n = beta1 * m.float() + (1 - beta1) * u
        p.copy_(p.float() - lr * m_n)
        m.copy_(m_n)

    def upd_factored(pc, p, g, m, vr, vc):
        n = p.dim()
        rows, cols = range(n - 1), [*range(n - 2), n - 1]
        gf = g.float()
        g2 = gf * gf + eps
        vr_n = decay * pc.region(vr, rows) + (1 - decay) * pc.mean(g2, (-1,))
        vc_n = decay * pc.region(vc, cols) + (1 - decay) * pc.mean(g2, (-2,))
        del g2
        denom = torch.clamp_min(pc.mean(vr_n, (-2,), (-1,), keepdim=True),
                                eps)
        vhat = (vr_n[..., None] * vc_n[..., None, :]) / denom[..., None]
        vr.copy_(pc.assemble(vr_n, rows))
        vc.copy_(pc.assemble(vc_n, cols))
        clipped_step(pc, gf / torch.sqrt(vhat + eps), m, p)

    def upd(pc, p, g, m, v):
        gf = g.float()
        v_n = decay * v + (1 - decay) * (gf * gf + eps)
        v.copy_(v_n)
        clipped_step(pc, gf / torch.sqrt(v_n + eps), m, p)

    def one(g, vr, vc, v, m, p):
        if _factored(p):
            _on_pieces(upd_factored, p, (g, m), (vr, vc))
        else:
            _on_pieces(upd, p, (g, m, v))

    tree_map(one, grads, state.vr, state.vc, state.v, state.m, params)
    return params, AdafactorState(step=step, vr=state.vr, vc=state.vc,
                                  v=state.v, m=state.m)


class AdagradState(NamedTuple):
    accum: Any


def adagrad_init(params) -> AdagradState:
    return AdagradState(accum=tree_map(
        lambda p: torch.full(p.shape, 0.1, dtype=torch.float32,
                             device=p.device), params))


@torch.no_grad()
def adagrad_update(grads, state: AdagradState, params, *, lr=1e-2,
                   eps=1e-10):
    def upd(g, a, p):
        gf = g.float()
        a_new = a + gf * gf
        p.copy_(p.float() - lr * gf / (torch.sqrt(a_new) + eps))
        a.copy_(a_new)

    tree_map(upd, grads, state.accum, params)
    return params, state
