"""The serving ``Policy`` protocol and its ported implementations
(``repro.serve.policies``).

A policy is what an ``OnlineBandit`` session needs to turn a request
batch into choices and fold feedback back, four hooks over a state
record:

  init(device)                    -> state
  gather_score(state, idx)        -> (w, minv_eff, occ) rows for the
                                     fused choose, gathered per request
  apply_pass(state, idx, x, r, live, be)
                                  -> state    one masked feedback pass;
                                     ``live`` rows are DISTINCT users
  refresh(state, col)             -> state    the periodic stage, over the
                                     session's collectives

| policy     | scores with                      | refresh                    |
|------------|----------------------------------|----------------------------|
| `distclub` | beta gate: own vs cluster stats  | stage 2 (prune+CC+reduce)  |
| `club`     | cluster stats always             | stage 2 (prune+CC+reduce)  |
| `linucb`   | own stats always                 | none                       |
| `dccb`     | lagged buffered stats            | one gossip round           |

The clustered policies read the stage-2 per-user snapshots
(``uMcinv``/``ubc``/``umean_occ``) frozen until the next refresh, as
stages 3 and 4 do.  They and linucb keep ``Minv`` and ``uMcinv`` in the
session's ``Precision.state_dtype`` (bf16 halves the bytes of the
``[n, d, d]`` state); ``gather_score`` upcasts the gathered rows once, so
scoring and retrieval run in f32.  dccb keeps f32 state, as ``repro``'s.
``gather_score`` is also what catalog retrieval scores the catalog with.

On a sharded session (``OnlineBandit.sharded``: distclub, club and
linucb) the per-user rows are this rank's users only, ``idx`` indexes
them, and the clustered policies' refresh is stage 2 over the session's
collectives; ``labels`` and the counters stay replicated.  Each policy's
``state_specs()`` says which fields are split (``repro``'s
``state_specs``, a ``PartitionSpec`` tree there): a state record holding
0 for a field split on its user axis and None for a replicated one.
dccb has none: its gossip graph is dense, so it is single-host only.
:func:`shard_rows` and :func:`gather_rows` move such a record between
its global arrays and one rank's slice of them, for checkpoints,
snapshots and catalogs (``core.catalog.specs``) alike.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core import dccb, distclub, env_ops, linucb
from ..core.backend import BackendConfig, Precision, resolve_precision
from ..core.clustering import segment_sum
from ..core.types import (BanditHyper, ClusterStats, DistCLUBState,
                          GraphState, LinUCBState)
from ..distributed.sharding import local_slice
from ..kernels.graph import ops as graph_ops
from ..runtime import stages
from ..runtime.collectives import NullCollectives

POLICIES = ("distclub", "club", "linucb", "dccb")
_NULL = NullCollectives()


class ServeCfg(NamedTuple):
    """Static facts of one serving session."""

    n_users: int
    d: int
    hyper: BanditHyper
    refresh_every: int      # interactions between refreshes; <= 0 = never
    seed: int = 0           # keys a randomized refresh (dccb's peer draw)
    precision: Precision = Precision.f32   # the session's storage policy


def _rank1_pass(Minv, b, occ, idx, x, r, live, be):
    """One fused masked Sherman-Morrison pass over gathered rows (the
    in-place kernel works on the gathered copy), scattered back for the
    live (distinct-user) rows only; new tensors, the inputs untouched."""
    Minv2, b2 = be.update_inv(Minv[idx], b[idx], x, r, live)
    rows = idx[live]
    Minv, b, occ = Minv.clone(), b.clone(), occ.clone()
    Minv[rows] = Minv2[live]
    b[rows] = b2[live]
    occ[rows] += 1
    return Minv, b, occ


def _eye_rows(n, d, device, dtype=torch.float32):
    return torch.eye(d, dtype=dtype, device=device).expand(n, d, d).clone()


def _zero():
    return torch.zeros((), dtype=torch.int32)


# ---------------------------------------------------------------------------
# distclub / club: the clustered policies (stage-2 refresh)
# ---------------------------------------------------------------------------


class ClusteredState(NamedTuple):
    """DistCLUB/CLUB serving state: LinUCB rows, the packed graph and the
    frozen per-user stage-2 snapshots."""

    Minv: torch.Tensor          # [n, d, d]
    b: torch.Tensor             # [n, d]
    occ: torch.Tensor           # [n] i32
    adj: torch.Tensor           # [n, ceil(n/32)] i32 packed rows
    labels: torch.Tensor        # [n] i32
    uMcinv: torch.Tensor        # [n, d, d]  frozen cluster snapshot
    ubc: torch.Tensor           # [n, d]
    umean_occ: torch.Tensor     # [n] f32
    since_refresh: torch.Tensor  # [] i32
    comm_bytes: torch.Tensor     # [] f32 modeled stage-2 traffic


class ClusteredPolicy(NamedTuple):
    cfg: ServeCfg
    use_beta: bool            # True = distclub (beta gate), False = club

    @property
    def name(self) -> str:
        return "distclub" if self.use_beta else "club"

    @property
    def has_refresh(self) -> bool:
        return True

    def state_specs(self) -> ClusteredState:
        return ClusteredState(Minv=0, b=0, occ=0, adj=0, labels=None,
                              uMcinv=0, ubc=0, umean_occ=0,
                              since_refresh=None, comm_bytes=None)

    def init(self, device, col=_NULL) -> ClusteredState:
        """The initial state of this rank's users (every user on one
        process)."""
        n, d = self.cfg.n_users, self.cfg.d
        sdt = self.cfg.precision.torch_state
        row0, m = local_slice(n, col.axis_index(), col.n_shards)
        return ClusteredState(
            Minv=_eye_rows(m, d, device, sdt),
            b=torch.zeros(m, d, dtype=torch.float32, device=device),
            occ=torch.zeros(m, dtype=torch.int32, device=device),
            adj=graph_ops.init_packed_adj(m, n, row_offset=row0,
                                          device=device),
            labels=torch.zeros(n, dtype=torch.int32, device=device),
            uMcinv=_eye_rows(m, d, device, sdt),
            ubc=torch.zeros(m, d, dtype=torch.float32, device=device),
            umean_occ=torch.zeros(m, dtype=torch.float32, device=device),
            since_refresh=_zero().to(device),
            comm_bytes=torch.zeros((), dtype=torch.float32, device=device))

    def occ_of(self, state):
        return state.occ

    def gather_score(self, state: ClusteredState, idx):
        # reduced rows upcast once, after the gather (f32: as they are)
        Minv, b, occ = state.Minv[idx].float(), state.b[idx], state.occ[idx]
        uMcinv = state.uMcinv[idx].float()
        v_own = linucb.user_vector(Minv, b)
        v_clu = linucb.user_vector(uMcinv, state.ubc[idx])
        if self.use_beta:
            use_own = stages.beta_gate(self.cfg.hyper, occ,
                                       state.umean_occ[idx])
        else:
            use_own = torch.zeros(occ.shape, dtype=torch.bool,
                                  device=occ.device)   # CLUB: cluster always
        w, minv_eff = stages.mix_scores(use_own, v_own, v_clu, Minv, uMcinv)
        return w, minv_eff, occ

    def apply_pass(self, state: ClusteredState, idx, x, r, live, be):
        Minv, b, occ = _rank1_pass(state.Minv, state.b, state.occ, idx, x, r,
                                   live, be)
        return state._replace(Minv=Minv, b=b, occ=occ)

    def refresh(self, state: ClusteredState, col=_NULL) -> ClusteredState:
        cfg = self.cfg
        gb = BackendConfig.create().graph(state.occ.shape[0], cfg.n_users)
        res = stages.stage2_refresh(col, gb, cfg.hyper, cfg.d, state.Minv,
                                    state.b, state.occ, state.adj)
        return state._replace(
            adj=res.adj, labels=res.labels,
            uMcinv=res.uMcinv.to(state.uMcinv.dtype), ubc=res.ubc,
            umean_occ=res.umean_occ,
            comm_bytes=state.comm_bytes + res.comm_bytes)


# ---------------------------------------------------------------------------
# linucb: the per-user baseline (no clustering, no refresh)
# ---------------------------------------------------------------------------


class LinUCBServeState(NamedTuple):
    Minv: torch.Tensor           # [n, d, d]
    b: torch.Tensor              # [n, d]
    occ: torch.Tensor            # [n] i32
    since_refresh: torch.Tensor  # [] i32 (counted; never fires)


class LinUCBPolicy(NamedTuple):
    cfg: ServeCfg

    @property
    def name(self) -> str:
        return "linucb"

    @property
    def has_refresh(self) -> bool:
        return False

    def state_specs(self) -> LinUCBServeState:
        return LinUCBServeState(Minv=0, b=0, occ=0, since_refresh=None)

    def init(self, device, col=_NULL) -> LinUCBServeState:
        """The initial state of this rank's users (every user on one
        process)."""
        _, m = local_slice(self.cfg.n_users, col.axis_index(), col.n_shards)
        d = self.cfg.d
        return LinUCBServeState(
            Minv=_eye_rows(m, d, device, self.cfg.precision.torch_state),
            b=torch.zeros(m, d, dtype=torch.float32, device=device),
            occ=torch.zeros(m, dtype=torch.int32, device=device),
            since_refresh=_zero().to(device))

    def occ_of(self, state):
        return state.occ

    def gather_score(self, state: LinUCBServeState, idx):
        Minv = state.Minv[idx].float()
        return linucb.user_vector(Minv, state.b[idx]), Minv, state.occ[idx]

    def apply_pass(self, state: LinUCBServeState, idx, x, r, live, be):
        Minv, b, occ = _rank1_pass(state.Minv, state.b, state.occ, idx, x, r,
                                   live, be)
        return state._replace(Minv=Minv, b=b, occ=occ)

    def refresh(self, state, col=_NULL):
        return state


# ---------------------------------------------------------------------------
# dccb: the buffered-gossip baseline (Korda et al.)
# ---------------------------------------------------------------------------


class DCCBServeState(NamedTuple):
    core: dccb.DCCBState         # the full DCCB record (dense adj, buffers)
    since_refresh: torch.Tensor  # [] i32


class DCCBPolicy(NamedTuple):
    """DCCB as a serving policy: lagged buffered scoring, refresh = one
    gossip round.  The lockstep driver adapted to requests: the buffer
    cursor advances once per feedback pass, and inactive users keep their
    pending entries buffered until their next active pass pops them.
    Single host only (the gossip graph is dense).

    A refresh draws each user's neighbour with ``peers_fn(seed, step,
    adj)``, ``seed`` being the session's (``cfg.seed``) and ``step`` its
    lifetime interaction count, so successive refreshes draw anew and
    sessions of other seeds gossip with other peers."""

    cfg: ServeCfg
    peers_fn: Callable = env_ops.draw_peers

    @property
    def name(self) -> str:
        return "dccb"

    @property
    def has_refresh(self) -> bool:
        return True

    @property
    def L(self) -> int:
        return self.cfg.hyper.buffer_size

    def state_specs(self):
        raise NotImplementedError(
            "dccb serving is single-host only (dense gossip graph)")

    def init(self, device) -> DCCBServeState:
        return DCCBServeState(
            core=dccb.init_state(self.cfg.n_users, self.cfg.d, self.L,
                                 device=device),
            since_refresh=_zero().to(device))

    def occ_of(self, state: DCCBServeState):
        return state.core.occ

    def gather_score(self, state: DCCBServeState, idx):
        core = state.core
        w, Minv = dccb.lagged_score(core.Mw[idx], core.bw[idx])
        return w, Minv, core.occ[idx]

    def apply_pass(self, state: DCCBServeState, idx, x, r, live, be):
        """Buffer pushes are plain adds, not Sherman-Morrison: ``be`` is
        not used.  The pass scatters the live (distinct-user) rows to full
        width and pushes on a copy of the fields the push writes (it works
        in place, and sessions leave their input as it was): at the paper's
        width that copy, the ``[n, L, d, d]`` buffer above all, is most of
        a pass's cost."""
        core = state.core
        n = core.occ.shape[0]
        rows = idx[live]
        x_full = torch.zeros(n, x.shape[1], dtype=x.dtype, device=x.device)
        r_full = torch.zeros(n, dtype=x.dtype, device=x.device)
        m_full = torch.zeros(n, dtype=torch.bool, device=x.device)
        x_full[rows] = x[live]
        r_full[rows] = r[live]
        m_full[rows] = True
        core = core._replace(Mw=core.Mw.clone(), bw=core.bw.clone(),
                             Mbuf=core.Mbuf.clone(), bbuf=core.bbuf.clone(),
                             occ=core.occ.clone())
        core = dccb.buffered_push(core, x_full, r_full, m_full, self.L)
        return state._replace(core=core)

    def refresh(self, state: DCCBServeState, col=_NULL) -> DCCBServeState:
        core = state.core
        step = int(torch.sum(core.occ))
        peer = self.peers_fn(self.cfg.seed, step, core.adj)
        return state._replace(core=dccb.gossip_round(
            core, peer, self.cfg.hyper, self.L, self.cfg.d))


# ---------------------------------------------------------------------------
# construction + offline interop
# ---------------------------------------------------------------------------


def make_cfg(n_users: int, d: int, hyper: BanditHyper, *,
             refresh_every: int = 0, seed: int = 0,
             precision=None) -> ServeCfg:
    """``precision`` (a ``Precision``, a preset name, or None) through
    ``core.backend.resolve_precision``: the one source of the state dtype
    and of the checkpoint's precision tag."""
    return ServeCfg(n_users=n_users, d=d, hyper=hyper,
                    refresh_every=refresh_every, seed=seed,
                    precision=resolve_precision(precision))


def get_policy(name: str, cfg: ServeCfg):
    if name == "distclub":
        return ClusteredPolicy(cfg, use_beta=True)
    if name == "club":
        return ClusteredPolicy(cfg, use_beta=False)
    if name == "linucb":
        return LinUCBPolicy(cfg)
    if name == "dccb":
        return DCCBPolicy(cfg)
    raise ValueError(f"unknown policy {name!r}; want one of {POLICIES}")


def from_distclub_state(state: DistCLUBState) -> ClusteredState:
    """Warm-start serving state from an offline ``distclub.run`` state:
    the per-user snapshots are gathered as stage 3 would."""
    uMcinv, ubc, umean_occ = distclub.serving_snapshot(state)
    return ClusteredState(
        Minv=state.lin.Minv, b=state.lin.b, occ=state.lin.occ,
        adj=state.graph.adj, labels=state.graph.labels,
        uMcinv=uMcinv, ubc=ubc, umean_occ=umean_occ,
        since_refresh=_zero().to(state.lin.b.device),
        comm_bytes=state.comm_bytes)


def _map_split(fn, record, specs):
    """``fn(field, axis)`` on every tensor field of ``record`` (a state or
    a catalog), ``axis`` its split axis in ``specs`` (None: replicated);
    other fields (host ints) as they are."""
    return type(record)(*(fn(v, a) if isinstance(v, torch.Tensor) else v
                          for v, a in zip(record, specs)))


def shard_rows(record, col, specs):
    """This rank's slice of the global ``record``: each field split by
    ``specs`` narrowed to rank ``col.axis_index()``'s piece of its axis,
    the rest as it is.  Raises unless the ranks divide each split axis."""
    def piece(x, axis):
        if axis is None or col.n_shards == 1:
            return x
        row0, m = local_slice(x.shape[axis], col.axis_index(), col.n_shards)
        return x.narrow(axis, row0, m).contiguous()

    return _map_split(piece, record, specs)


def gather_rows(record, col, specs):
    """The global arrays of a record split over ``col`` by ``specs``: each
    split field all-gathered in rank order along its axis (one process:
    ``record`` as it is).  The inverse of :func:`shard_rows`."""
    def whole(x, axis):
        if axis is None or col.n_shards == 1:
            return x
        return col.all_gather(x.movedim(axis, 0)).movedim(0, axis) \
            .contiguous()

    return _map_split(whole, record, specs)


def to_distclub_state(state: ClusteredState, hyper: BanditHyper,
                      d: int) -> DistCLUBState:
    """The offline record from a serving state (label tables rebuilt from
    the per-user rows; M recovered from Minv)."""
    n = state.occ.shape[0]
    Minv = state.Minv.float()           # the offline record is f32
    M = torch.linalg.inv(Minv)
    lin = LinUCBState(M=M, Minv=Minv, b=state.b, occ=state.occ)
    eye = torch.eye(d, dtype=torch.float32, device=M.device)
    labels = state.labels
    Mc = segment_sum(M - eye, labels, n) + eye
    stats = ClusterStats(
        Mc=Mc, Mcinv=torch.linalg.inv(Mc), bc=segment_sum(state.b, labels, n),
        size=segment_sum(torch.ones_like(labels), labels, n),
        seen=segment_sum(state.occ, labels, n))
    rounds = torch.full((n,), hyper.sigma, dtype=torch.int32,
                        device=M.device)
    return DistCLUBState(
        lin=lin, graph=GraphState(adj=state.adj, labels=labels),
        clusters=stats, u_rounds=rounds, c_rounds=rounds.clone(),
        comm_bytes=state.comm_bytes)
