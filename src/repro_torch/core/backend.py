"""The engines the stage bodies call: two hot-loop operations per bandit
round and two graph sweeps per stage 2.

  ``InteractBackend.choose``     UCB scores -> first-index argmax -> the
                                 chosen context (``kernels/interact``)
  ``InteractBackend.update_inv`` masked M-free Sherman-Morrison
                                 (``kernels/rank1``)
  ``InteractBackend.update_lin`` the same with M (CLUB's user rows)
  ``GraphBackend.prune_rows``    CLUB edge pruning on the packed rows
  ``GraphBackend.cc_hop``        one min-label hop    (``kernels/graph``)
  ``RetrievalBackend.shortlist`` streaming UCB top-K over a catalog,
                                 unpruned or cluster-pruned
                                 (``kernels/topk``)

There is no kind flag: the tensors' device decides.  CPU tensors go
through the plain PyTorch versions, CUDA tensors through the hand-written
kernels, and nothing falls back from one to the other.  Shapes are
logical throughout (the kernels mask their own ragged edges), so the
engines pad nothing.

``BackendConfig`` keeps the construction surface of
``repro.core.backend``: one resolved ``Precision`` builds every engine.
Reduced precision changes what the tensors hold (a bf16 ``Minv``, bf16
or int8 catalog banks with per-slot scales), and the kernels' wrappers
pick their variant from the dtypes they are given: every engine takes
``Minv`` in f32 or bf16 (each kernel widens a bf16 ``Minv`` exactly as it
loads it, and the updates round it back to nearest even), as
``repro``'s pallas-kind engines hand a bf16 state to their kernels.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..kernels.graph import ops as graph_ops
from ..kernels.interact import ops as interact_ops
from ..kernels.rank1 import ops as rank1_ops
from ..kernels.topk import ops as topk_ops
from ..kernels.topk.ref import tile_bounds
from . import clustering
from .types import LinUCBState


_PRECISION_ENV_FLAG = "REPRO_PRECISION"

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
_STATE_DTYPES = ("f32", "bf16")             # Minv blocks (SPD: never int8)
_CATALOG_DTYPES = ("f32", "bf16", "int8")   # embedding banks


class Precision(NamedTuple):
    """Storage-precision policy for the state that dominates memory
    (``repro.core.backend.Precision``).

    ``state_dtype``    per-user ``Minv`` d^2 blocks ("f32" | "bf16");
                       ``b``/``occ`` stay f32/i32.
    ``catalog_dtype``  catalog embedding banks ("f32" | "bf16" | "int8";
                       int8 adds a per-slot f32 scale, ``core.catalog``).
    ``accum_dtype``    accumulation of every contraction; always "f32".
    ``scale_block``    int8 scale granularity at initial quantization:
                       slots in blocks of this size share one scale
                       (churn-added rows get their own).
    """

    state_dtype: str = "f32"
    catalog_dtype: str = "f32"
    accum_dtype: str = "f32"
    scale_block: int = 512

    @property
    def torch_state(self) -> torch.dtype:
        return _DTYPES[self.state_dtype]

    @property
    def torch_catalog(self) -> torch.dtype:
        return _DTYPES[self.catalog_dtype]


# presets: the names the REPRO_PRECISION env flag accepts
Precision.f32 = Precision()
Precision.bf16 = Precision(state_dtype="bf16", catalog_dtype="bf16")
Precision.int8 = Precision(state_dtype="bf16", catalog_dtype="int8")
_PRECISION_PRESETS = {"f32": Precision.f32, "bf16": Precision.bf16,
                      "int8": Precision.int8}


def resolve_precision(precision=None) -> Precision:
    """The one place the precision policy is resolved: the explicit
    argument (a :class:`Precision` or a preset name), else the
    ``REPRO_PRECISION`` environment variable, else f32."""
    if precision is None:
        precision = os.environ.get(_PRECISION_ENV_FLAG) or "f32"
    if isinstance(precision, str):
        if precision not in _PRECISION_PRESETS:
            raise ValueError(
                f"unknown precision {precision!r}; want "
                f"{'|'.join(_PRECISION_PRESETS)} or a Precision instance")
        precision = _PRECISION_PRESETS[precision]
    if not isinstance(precision, Precision):
        raise TypeError(f"precision must be a Precision or preset name, "
                        f"got {type(precision).__name__}")
    if precision.state_dtype not in _STATE_DTYPES:
        raise ValueError(f"state_dtype {precision.state_dtype!r}; "
                         f"want {'|'.join(_STATE_DTYPES)}")
    if precision.catalog_dtype not in _CATALOG_DTYPES:
        raise ValueError(f"catalog_dtype {precision.catalog_dtype!r}; "
                         f"want {'|'.join(_CATALOG_DTYPES)}")
    if precision.accum_dtype != "f32":
        raise ValueError("accum_dtype must be 'f32' (every contraction "
                         "accumulates in f32)")
    if precision.scale_block < 1:
        raise ValueError(f"scale_block must be >= 1, "
                         f"got {precision.scale_block}")
    return precision


class InteractBackend(NamedTuple):
    """Fused-interaction engine; shapes come from the tensors."""

    def choose(self, w, Minv, contexts, occ, alpha):
        """(x [n, d], choice [n] i32); ``Minv`` f32 or bf16 (the pick of
        its f32 widening)."""
        choice, x = interact_ops.choose(w, Minv, contexts, occ, alpha)
        return x, choice

    def update_inv(self, Minv, b, x, r, mask):
        """(Minv', b'), updated in place on either device; a bf16 ``Minv``
        stays bf16."""
        return rank1_ops.rank1_update_inv(Minv, b, x, r, mask)

    def update_lin(self, lin: LinUCBState, x, r, mask) -> LinUCBState:
        """One masked interaction for every user of ``lin``: M, Minv and b
        in one kernel, then ``occ + mask``.  All four tensors are updated
        IN PLACE and returned; they may be one user's row views
        (``lin.M[u:u+1]`` ...).  ``lin.Minv`` may be bf16 (M and b f32): it
        is updated in f32 and rounded back to nearest even, in place."""
        M, Minv, b = rank1_ops.rank1_update(lin.M, lin.Minv, lin.b, x, r,
                                            mask)
        return LinUCBState(M, Minv, b, lin.occ.add_(mask.to(torch.int32)))


class GraphBackend(NamedTuple):
    """Stage-2 graph engine over ``[n_rows, ceil(n_cols/32)]`` int32 rows."""

    n_rows: int
    n_cols: int

    @property
    def words(self) -> int:
        return graph_ops.packed_words(self.n_cols)

    def init_adj(self, row_offset: int = 0, device=None):
        """Fully-connected packed adjacency minus self edges."""
        return graph_ops.init_packed_adj(self.n_rows, self.n_cols,
                                         row_offset=row_offset, device=device)

    def pack(self, dense):
        return graph_ops.pack_bits(dense, self.words)

    def unpack(self, packed):
        return graph_ops.unpack_bits(packed, self.n_cols)

    def prune_rows(self, adj, v_i, occ_i, v_j, occ_j, gamma):
        """AND the CLUB keep-mask into the packed rows."""
        return graph_ops.prune_packed(
            adj, v_i, clustering.cb_width(occ_i), v_j,
            clustering.cb_width(occ_j), gamma)

    def cc_hop(self, adj, labels_self, labels_j):
        """One min-label hop over the packed rows (no pointer doubling)."""
        return graph_ops.cc_hop_packed(adj, labels_self, labels_j)


class RetrievalBackend(NamedTuple):
    """Catalog-scale retrieval engine: each user's ``K_short`` best items
    by UCB score, (score desc, id asc), without the ``[n, N_items]``
    score matrix.  The feature width comes from the tensors."""

    K_short: int

    def shortlist(self, w, Minv, occ, items, live, alpha, row0_items=0,
                  scales=None):
        """(scores [n, K_short], ids [n, K_short] i32 GLOBAL item ids);
        ``row0_items`` is the global id of the catalog slice's first row.
        Entries that hold no live item keep score -inf and id -1.
        ``items`` may be f32, bf16 or int8; int8 needs the per-slot
        ``scales [N]`` f32.  ``Minv`` may be f32 or bf16 (the shortlist of
        its f32 widening)."""
        s, i = topk_ops.topk(w, Minv, occ, items, live, alpha, self.K_short,
                             scales=scales)
        return s, torch.where(torch.isfinite(s), i + row0_items, -1)

    def shortlist_pruned(self, w, Minv, occ, items_sorted, live_sorted,
                         ids_sorted, tile_mu, tile_r, tile_xn, tile_n,
                         alpha, scales_sorted=None):
        """Cluster-pruned shortlist over a SORTED catalog (``core.itemclub``
        lays it out): per-(user, tile) UCB upper bounds, then only the
        tiles that can still beat a user's running floor.  Returns
        ``(scores, ids, tiles_skipped, tile_visits)`` with the shortlist
        BIT-EQUAL to :meth:`shortlist` over the unsorted catalog.  The
        caller keeps the tables fresh: ``serve`` falls back to
        :meth:`shortlist` when the cluster epoch is not the catalog's."""
        tb = tile_bounds(w, Minv, occ, alpha, tile_mu, tile_r, tile_xn,
                         tile_n)
        s, i, skipped, total = topk_ops.topk_pruned(
            w, Minv, occ, items_sorted, live_sorted, ids_sorted, alpha,
            self.K_short, tb, scales=scales_sorted)
        return s, torch.where(torch.isfinite(s), i, -1), skipped, total


class BackendConfig(NamedTuple):
    """Builds the engines under one resolved :class:`Precision`."""

    precision: Precision = Precision.f32

    @classmethod
    def create(cls, precision=None) -> "BackendConfig":
        """``precision`` through :func:`resolve_precision`."""
        return cls(precision=resolve_precision(precision))

    def interact(self) -> InteractBackend:
        return InteractBackend()

    def graph(self, n_rows: int, n_cols: int | None = None) -> GraphBackend:
        return GraphBackend(n_rows=n_rows,
                            n_cols=n_rows if n_cols is None else n_cols)

    def retrieval(self, K_short: int) -> RetrievalBackend:
        return RetrievalBackend(K_short=K_short)
