"""The heads a rank of "model" computes (``models.attention``
``heads_layout``, ``rank_heads``) where the q heads do not split over
the ranks: yi-34b's 56 q heads and llama4-maverick's 40 over 16 ranks
(3.5 and 2.5 heads of columns a rank), and the small configs of
``tests/test_torch_gspmd_layouts.py``.  Each rank computes the q heads
its columns of ``wq`` overlap, at most ceil(H / m) + 1 of them, and the
kv heads those read; ``_rank_wq`` gives it exactly those heads' columns
of ``wq`` (from its neighbours, or from every rank where a head spans
three); ``attention_fwd`` hands the flash kernel those heads only (a
stand-in collective gives the gathers their shapes)."""
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.kernels.flash import ops as flash_ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402

# (H, Hkv, m, layout)
GEOMETRIES = [(56, 8, 16, "wq_gathered"), (40, 8, 16, "wq_gathered"),
              (3, 1, 2, "wq_gathered"), (6, 3, 2, "kv_gathered"),
              (32, 8, 16, "kv_gathered"), (16, 16, 16, "local")]
DH = 8


def _cfg(H, Hkv):
    return SimpleNamespace(n_heads=H, n_kv_heads=Hkv, d_head=DH,
                           d_model=16, qk_norm=False, rope_base=10000.0)


@pytest.mark.parametrize("H,Hkv,m,layout", GEOMETRIES)
def test_rank_heads_cover_the_rank_columns(H, Hkv, m, layout):
    cfg = _cfg(H, Hkv)
    assert attention.heads_layout(cfg, m) == layout
    c, g = H * DH // m, H // Hkv
    for r in range(m):
        (lo, hi), (klo, khi) = attention.rank_heads(cfg, m, r)
        assert lo * DH <= r * c and (r + 1) * c <= hi * DH
        assert (lo + 1) * DH > r * c and (hi - 1) * DH < (r + 1) * c
        assert hi - lo <= math.ceil(H / m) + 1
        assert (klo, khi) == (lo // g, (hi - 1) // g + 1)
        if layout != "wq_gathered":
            assert (lo, hi) == (r * H // m, (r + 1) * H // m)


class _Stand:
    """A collective of ``m`` ranks seen from rank ``r`` that gives each
    result its shape (a gather tiles the rank's own piece)."""

    def __init__(self, m, r):
        self.n_shards, self.r = m, r

    def axis_index(self):
        return self.r

    def all_gather(self, x, axis=0, tiled=True):
        return torch.cat([x] * self.n_shards, dim=axis)

    def psum(self, x):
        return x

    def psum_scatter(self, x, axis=0):
        return x.narrow(axis, 0, x.shape[axis] // self.n_shards)

    def permute(self, x, shift=1):
        return x.clone()


class _Ring:
    """The pieces of ``full`` split over ``m`` ranks on its last dim, seen
    from rank ``r``: a gather gives ``full``, a permute the piece of the
    rank ``shift`` before at the same columns."""

    def __init__(self, full, m, r):
        self.full, self.n_shards, self.r = full, m, r

    def axis_index(self):
        return self.r

    def own(self, r):
        c = self.full.shape[-1] // self.n_shards
        return self.full[:, r * c:(r + 1) * c]

    def all_gather(self, x, axis=0, tiled=True):
        assert torch.equal(x, self.own(self.r))
        return self.full

    def permute(self, x, shift=1):
        own, w = self.own(self.r), x.shape[-1]
        at = [a for a in range(own.shape[-1] - w + 1)
              if torch.equal(own[:, a:a + w], x)]
        assert len(at) == 1
        return self.own((self.r - shift) % self.n_shards)[
            :, at[0]:at[0] + w].clone()


# (H, m): a head over two ranks (neighbours' columns), and over three or
# more (every rank's columns gathered)
@pytest.mark.parametrize("H,m", [(56, 16), (40, 16), (3, 2), (6, 4),
                                 (3, 4), (5, 8)])
def test_rank_wq_is_the_rank_heads_columns(H, m):
    cfg = _cfg(H, 1)
    g = torch.Generator().manual_seed(H * 31 + m)
    full = torch.randn(cfg.d_model, H * DH, generator=g)
    for r in range(m):
        ring = _Ring(full, m, r)
        heads = attention.rank_heads(cfg, m, r)
        (lo, hi), _ = heads
        got = attention._rank_wq(ring.own(r), DH, heads[0],
                                 spmd.Axes(model=ring))
        assert torch.equal(got, full[:, lo * DH:hi * DH]), r


@pytest.mark.parametrize("H,Hkv,m", [(56, 8, 16), (40, 8, 16)])
def test_attention_computes_only_the_rank_heads(H, Hkv, m, monkeypatch):
    cfg = _cfg(H, Hkv)
    seen = []

    def attend(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1]))
        return torch.zeros_like(q)

    monkeypatch.setattr(flash_ops, "attention", attend)
    d, B, S = cfg.d_model, 1, 4
    g = torch.Generator().manual_seed(0)
    for r in range(m):
        col = _Stand(m, r)
        ax = spmd.Axes(model=col)
        params = {"wq": torch.randn(d, H * DH // m, generator=g),
                  "wk": torch.randn(d, Hkv * DH // m, generator=g),
                  "wv": torch.randn(d, Hkv * DH // m, generator=g),
                  "wo": torch.randn(H * DH // m, d, generator=g)}
        out, _ = attention.attention_fwd(
            params, cfg, torch.randn(B, S, d, generator=g),
            positions=torch.arange(S), ax=ax)
        (lo, hi), _ = attention.rank_heads(cfg, m, r)
        assert seen[-1][0] == hi - lo <= math.ceil(H / m) + 1
        assert out.shape == (B, S, d)
    assert max(h for h, _ in seen) < H
