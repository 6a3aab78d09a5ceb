"""The engines the stage bodies call: two hot-loop operations per bandit
round and two graph sweeps per stage 2.

  ``InteractBackend.choose``     UCB scores -> first-index argmax -> the
                                 chosen context (``kernels/interact``)
  ``InteractBackend.update_inv`` masked M-free Sherman-Morrison
                                 (``kernels/rank1``)
  ``GraphBackend.prune_rows``    CLUB edge pruning on the packed rows
  ``GraphBackend.cc_hop``        one min-label hop    (``kernels/graph``)

There is no kind flag: the tensors' device decides.  CPU tensors go
through the plain PyTorch versions, CUDA tensors through the hand-written
kernels, and nothing falls back from one to the other.  Shapes are
logical throughout (the kernels mask their own ragged edges), so the
engines pad nothing.

``BackendConfig`` keeps the construction surface of
``repro.core.backend`` for the f32 state this port stores; reduced
precision is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

from ..kernels.graph import ops as graph_ops
from ..kernels.interact import ops as interact_ops
from ..kernels.rank1 import ops as rank1_ops
from . import clustering


class InteractBackend(NamedTuple):
    """Fused-interaction engine; shapes come from the tensors."""

    def choose(self, w, Minv, contexts, occ, alpha):
        """(x [n, d], choice [n] i32)."""
        choice, x = interact_ops.choose(w, Minv, contexts, occ, alpha)
        return x, choice

    def update_inv(self, Minv, b, x, r, mask):
        """(Minv', b'), updated in place on either device."""
        return rank1_ops.rank1_update_inv(Minv, b, x, r, mask)


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


class BackendConfig(NamedTuple):
    """Builds the engines; f32 state is the only precision ported."""

    precision: str = "f32"

    @classmethod
    def create(cls, precision: str | None = None) -> "BackendConfig":
        precision = precision or "f32"
        if precision != "f32":
            raise ValueError(f"precision {precision!r} is not ported; "
                             "repro_torch stores f32 state only")
        return cls(precision=precision)

    def interact(self) -> InteractBackend:
        return InteractBackend()

    def graph(self, n_rows: int, n_cols: int | None = None) -> GraphBackend:
        return GraphBackend(n_rows=n_rows,
                            n_cols=n_rows if n_cols is None else n_cols)
