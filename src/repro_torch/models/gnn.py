"""GAT (arXiv:1710.10903) by segment ops (``repro.models.gnn``).

Message passing from first principles, as ``repro`` builds it: SDDMM-style
edge scores -> per-destination segment softmax (segment max and sum) ->
SpMM-style weighted scatter.  The four gat-cora cells flow through the
same forward:

  full_graph_sm / ogb_products : full-batch edge list
  minibatch_lg                 : fixed-fanout sampled blocks
                                 (``NeighborSampler``, host numpy)
  molecule                     : batched small graphs = one disjoint union

The segment max is ``scatter_reduce("amax", include_self=False)``: a
node that no edge enters keeps -inf there, as ``jax.ops.segment_max``
gives it, and maps to 0.  Sums are ``index_add``.  Parameters are a list
of ``{W, a_src, a_dst}`` dicts of tensors, ``repro``'s tree.

Sharded (``gat_loss_local``): nodes and their features, labels and mask
are row blocks of the ranks; each rank holds the edges whose destination
lies in its block, so every segment reduction stays local.  The one
collective a layer is the all-gather of the node embeddings, on the
collectives object ``col`` (``runtime.collectives``) where ``repro``
names mesh axes.  Gradients follow ``repro``'s shard_map transposes
(``distributed.spmd``'s ``gather`` and ``psum``): an all-gather's
backward is the reduce-scatter of the cotangents, a psum's the psum; so
a rank's gradient is its own, and ``launch.steps`` averages them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed import spmd
from . import layers


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str = "gat"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_feat: int = 1433
    n_classes: int = 7
    dtype: torch.dtype = torch.float32
    # int8 gathers with per-row scales halve the bf16 gather bytes
    # (straight-through gradients; the backward reduce-scatter stays
    # f32).  Off by default; on in the ogb_products cell.
    quantized_gather: bool = False


def layer_dims(cfg: GNNConfig) -> list[tuple[int, int]]:
    """(d_in, per-head width) of each layer."""
    dims, d_in = [], cfg.d_feat
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        dh = cfg.n_classes if last else cfg.d_hidden
        dims.append((d_in, dh))
        d_in = cfg.n_heads * dh if not last else cfg.n_classes
    return dims


def init_gat(gen: torch.Generator, cfg: GNNConfig) -> list[dict]:
    """The parameter list, drawn on the generator's device."""
    params = []
    for d_in, dh in layer_dims(cfg):
        params.append({
            "W": layers.dense_init(gen, d_in, cfg.n_heads * dh, cfg.dtype),
            "a_src": (torch.randn(cfg.n_heads, dh, generator=gen,
                                  device=gen.device) * 0.1).to(cfg.dtype),
            "a_dst": (torch.randn(cfg.n_heads, dh, generator=gen,
                                  device=gen.device) * 0.1).to(cfg.dtype)})
    return params


def _segment_max(e, seg, n: int):
    """Per-segment max of the rows of ``e`` [E, H]; -inf where empty."""
    out = torch.full((n, *e.shape[1:]), float("-inf"), dtype=e.dtype,
                     device=e.device)
    return out.scatter_reduce(0, seg[:, None].expand_as(e), e, "amax",
                              include_self=False)


def _segment_sum(vals, seg, n: int):
    out = torch.zeros((n, *vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add(0, seg, vals)


def _gat_layer_local(p, h_all, src, dst_global, dst_local, n_local: int,
                     n_heads: int, dh: int, *, last: bool):
    """h_all: [N, H * dh] node embeddings (gathered when sharded);
    src / dst_global: global ids; dst_local in [0, n_local).  Returns
    [n_local, ...]."""
    src, dst_global, dst_local = (t.long() for t in (src, dst_global,
                                                     dst_local))
    h = h_all.reshape(h_all.shape[0], n_heads, dh)
    alpha_src = torch.sum(h * p["a_src"], dim=-1)             # [N, H]
    alpha_dst = torch.sum(h * p["a_dst"], dim=-1)
    e = F.leaky_relu(alpha_src[src] + alpha_dst[dst_global], 0.2)
    m = _segment_max(e, dst_local, n_local)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    pexp = torch.exp(e - m[dst_local])
    z = _segment_sum(pexp, dst_local, n_local)
    att = pexp / torch.clamp(z[dst_local], min=1e-9)          # [E, H]
    msg = att[..., None] * h[src]                             # [E, H, dh]
    out = _segment_sum(msg, dst_local, n_local)
    if last:
        return out.mean(dim=1)                                # [n, classes]
    return F.elu(out.reshape(n_local, n_heads * dh))


def _gat_layer(p, x, src, dst, n_nodes: int, n_heads: int, dh: int, *,
               last: bool):
    return _gat_layer_local(p, x @ p["W"], src, dst, dst, n_nodes, n_heads,
                            dh, last=last)


def gat_fwd(params, cfg: GNNConfig, feats, src, dst):
    """feats [N, F], src/dst [E] int -> logits [N, n_classes]."""
    n = feats.shape[0]
    x = feats
    for i, (p, (_, dh)) in enumerate(zip(params, layer_dims(cfg))):
        x = _gat_layer(p, x, src, dst, n, cfg.n_heads, dh,
                       last=i == cfg.n_layers - 1)
    return x


def _nll_terms(logits, labels, mask):
    """(sum of masked -log p(label), count of the mask)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    m = mask.float()
    return torch.sum((lse - ll) * m), torch.sum(m)


def gat_loss(params, cfg: GNNConfig, feats, src, dst, labels, mask):
    num, den = _nll_terms(gat_fwd(params, cfg, feats, src, dst), labels,
                          mask)
    return num / torch.clamp(den, min=1.0)


# --- sharded message passing -----------------------------------------------


def quantize_rows(h):
    """Per-row int8 codes of ``h`` [n, w] and their f32 scales [n, 1]:
    ``max(max |h| / 127, 1e-9)``, ``round`` half to even, clipped to
    +-127."""
    scale = torch.clamp(h.abs().amax(dim=-1, keepdim=True) / 127.0,
                        min=1e-9)
    q = torch.clamp(torch.round(h / scale), -127, 127).to(torch.int8)
    return q, scale


class _QuantizedGather(torch.autograd.Function):
    """The int8 gather: codes and bf16 scales all-gathered, then widened
    to f32; the backward is the exact (f32) reduce-scatter of the
    cotangents, straight through the quantization (``repro``'s
    ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, h, col):
        ctx.col = col
        q, scale = quantize_rows(h)
        q_all = col.all_gather(q)
        s_all = col.all_gather(scale.to(torch.bfloat16))
        return q_all.float() * s_all.float()

    @staticmethod
    def backward(ctx, ct):
        return ctx.col.psum_scatter(ct), None


def gather_features(h, cfg: GNNConfig, col):
    """All ranks' rows of ``h`` [n_local, w] -> [N, w] f32: int8 with
    per-row scales under ``cfg.quantized_gather``, else through bf16."""
    if cfg.quantized_gather:
        return _QuantizedGather.apply(h, col)
    return spmd.gather(h.to(torch.bfloat16), 0, col).float()


def gat_loss_local(params, cfg: GNNConfig, feats, src, dst, labels, mask,
                   col):
    """One rank's GAT loss: feats/labels/mask its node rows, src/dst its
    edges (every dst inside its block) with global ids; dst is made local
    with the rank's row offset.  The loss is the masked mean over all
    ranks."""
    n_local = feats.shape[0]
    row0 = col.axis_index() * n_local
    dst_local = torch.clamp(dst - row0, 0, n_local - 1)

    x_local = feats
    for i, (p, (_, dh)) in enumerate(zip(params, layer_dims(cfg))):
        h_all = gather_features(x_local @ p["W"], cfg, col)  # [N, H*dh]
        x_local = _gat_layer_local(p, h_all, src, dst, dst_local, n_local,
                                   cfg.n_heads, dh,
                                   last=i == cfg.n_layers - 1)

    num, den = _nll_terms(x_local, labels, mask)
    return spmd.psum(num, col) / torch.clamp(col.psum(den), min=1.0)


# --- neighbor sampler (host side) ------------------------------------------


class NeighborSampler:
    """Fixed-fanout k-hop sampler over a CSR adjacency (numpy, host side).

    Produces fixed-shape padded blocks: the device graph never changes
    shape, and every round is the same amount of work.
    """

    def __init__(self, n_nodes: int, src: np.ndarray, dst: np.ndarray):
        order = np.argsort(dst, kind="stable")
        self.nbr = src[order]
        counts = np.bincount(dst, minlength=n_nodes)
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        self.n_nodes = n_nodes

    def sample(self, rng: np.random.Generator, seeds: np.ndarray,
               fanouts: tuple[int, ...]):
        """Sample a fixed-fanout union subgraph around ``seeds``.

        Returns (nodes [N_tot] global ids, src [E], dst [E] local indices
        into ``nodes``).  Shapes depend only on (len(seeds), fanouts):
        N_tot = seeds * (1 + f1 + f1*f2 + ...), E = seeds * (f1 + f1*f2 +
        ...).  Missing neighbors pad with self-loops (the standard
        self-edge convention), keeping every round identically shaped.
        """
        frontier = seeds
        nodes = [seeds]
        srcs, dsts = [], []
        base = 0
        for f in fanouts:
            lo = self.offsets[frontier]
            hi = self.offsets[frontier + 1]
            deg = hi - lo
            r = rng.integers(0, np.maximum(deg, 1)[:, None],
                             (len(frontier), f))
            idx = lo[:, None] + r
            picked = np.where(
                deg[:, None] > 0, self.nbr[np.minimum(idx, len(self.nbr) - 1)],
                frontier[:, None],   # isolated node -> self loop
            )
            new = picked.reshape(-1)
            srcs.append(base + len(frontier) + np.arange(len(new), dtype=np.int64))
            dsts.append(base + np.repeat(np.arange(len(frontier), dtype=np.int64), f))
            base += len(frontier)
            nodes.append(new)
            frontier = new
        return (
            np.concatenate(nodes),
            np.concatenate(srcs).astype(np.int32),
            np.concatenate(dsts).astype(np.int32),
        )
