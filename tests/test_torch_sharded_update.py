"""The optimizers' update on each rank's pieces of DTensor leaves
(``train.optimizer``, as the LM train cells run it) against the same
update on whole tensors in one process, and the update's temporaries
in the dry run's ``Counter``.

  pieces     on 4 gloo ranks, mesh (2, 2) over ("data", "model"): leaves
             in ZeRO layouts over both axes (stacked 3-D and 4-D leaves,
             one past ``_CHUNK_BYTES``, lowered here, so that it is
             updated slice by slice; a 2-D and a 1-D leaf), a moment in
             another layout than its parameter (as ``repro``'s
             ``opt_shardings`` give a leaf the first same-shaped
             parameter's), Adafactor's factors whole or split; two
             steps. Adafactor within 1e-6 of one process, AdamW bit for
             bit;
  temps      one rank of 16 (a fake group, mesh (4, 4)) runs a small
             MoE LM's ``train_4k`` with Adafactor under the dry run's
             ``Counter``: no storage the update of a leaf makes holds
             more than the rank's piece of the slice being updated (a
             chunked slice, or the leaf), in f32; a moment in a swapped
             layout and a factor split over "data" included.
"""
import math
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.distributed.sharding import P, shard  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402

CHUNK = 2048           # bytes: ``_CHUNK_BYTES`` for the pieces test
SHAPES = {             # leaf: (shape, parameter spec, moment spec)
    "stack3": ((4, 8, 12), P(None, "data", "model"), None),
    "stack4": ((3, 4, 8, 6), P(None, "model", None, "data"), None),
    "stack3_chunked": ((5, 8, 16), P(None, "data", "model"),
                       P(None, "model", "data")),
    "mat": ((8, 12), P("model", "data"), P("data", "model")),
    "vec": ((8,), P("data"), P()),
}
# the factors' layouts: whole, but for one split (a ``_by_shape`` match)
FACTOR_SPECS = {"stack3_chunked": (P(None, "data"), P())}
TOL = 1e-6
SPAWN_S = 120


def _leaves(seed):
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randn(*sd[0]).astype(np.float32))
            for k, sd in SHAPES.items()}


def _factor_shapes(shape):
    if len(shape) < 2:
        return (1,), (1,)
    return shape[:-1], shape[:-2] + shape[-1:]


def _run(kind, wrap):
    """Two steps of ``kind`` on the leaves of ``wrap`` (whole tensors, or
    DTensors of their pieces); every state leaf after them, whole."""
    params = {k: wrap(v, SHAPES[k][1]) for k, v in _leaves(0).items()}
    if kind == "adamw":
        state = optimizer.AdamWState(
            step=wrap(torch.zeros((), dtype=torch.int32), P()),
            m=_moments(wrap, torch.float32), v=_moments(wrap, torch.float32))
        update = optimizer.adamw_update
    else:
        def factor(k, i):
            shape = _factor_shapes(SHAPES[k][0])[i]
            spec = FACTOR_SPECS.get(k, (P(), P()))[i]
            return wrap(torch.zeros(shape), spec)

        def v(k):
            shape = (1,) if len(SHAPES[k][0]) >= 2 else SHAPES[k][0]
            return wrap(torch.zeros(shape), SHAPES[k][1] if shape != (1,)
                        else P())

        state = optimizer.AdafactorState(
            step=wrap(torch.zeros((), dtype=torch.int32), P()),
            vr={k: factor(k, 0) for k in SHAPES},
            vc={k: factor(k, 1) for k in SHAPES},
            v={k: v(k) for k in SHAPES},
            m=_moments(wrap, torch.bfloat16))
        update = optimizer.adafactor_update
    with mock.patch.object(optimizer, "_CHUNK_BYTES", CHUNK):
        for seed in (1, 2):
            grads = {k: wrap(g, SHAPES[k][1])
                     for k, g in _leaves(seed).items()}
            params, state = update(grads, state, params)
    out = {}
    for name, tree in (("p", params), *((f, getattr(state, f))
                                        for f in state._fields[1:])):
        for k, x in tree.items():
            x = x.full_tensor() if hasattr(x, "full_tensor") else x
            out[f"{name}.{k}"] = x.float()
    return out


def _moments(wrap, dtype):
    return {k: wrap(torch.zeros(sd[0], dtype=dtype), sd[2] or sd[1])
            for k, sd in SHAPES.items()}


def _rank(rank, col, device, kind):
    from repro_torch.launch.steps import _dt

    m = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    return _run(kind, lambda t, spec: _dt(shard(t, spec, m).clone(), spec,
                                          tuple(t.shape), m))


@pytest.fixture(scope="module")
def ranks():
    return {kind: mesh_lib.spawn(_rank, 4, "gloo", device="cpu",
                                 args=(kind,), timeout=SPAWN_S)
            for kind in ("adafactor", "adamw")}


def test_leaves_chunk_as_intended():
    # one leaf updated slice by slice, one whole (both stacked)
    big = [k for k, sd in SHAPES.items() if len(sd[0]) >= 3
           and math.prod(sd[0]) * 4 > CHUNK]
    assert big == ["stack4", "stack3_chunked"]


@pytest.mark.parametrize("kind", ["adafactor", "adamw"])
def test_update_on_pieces_matches_one_process(kind, ranks):
    want = _run(kind, lambda t, spec: t.clone())
    for rank, got in enumerate(ranks[kind]):
        assert set(got) == set(want)
        for k, w in want.items():
            g = torch.as_tensor(got[k])
            if kind == "adamw":
                assert torch.equal(g, w), (rank, k)
            else:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL,
                                           atol=TOL, err_msg=f"{rank} {k}")


# wk, wo and wq of one shape: wo's moment takes wk's layout, the splits of
# "data" and "model" swapped (as yi-34b's wq and wo), exchanged point to
# point; the expert leaves each in their own layout (as llama4's); 8
# stacked blocks, so that wk's factor ``vr`` [8, 64], laid out as the
# norms' scales (split over "data"), is more than a slice's piece whole
MOE = dict(n_layers=16, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
           d_ff=128, vocab=256, microbatches=2, attn_chunk=16, n_experts=8,
           top_k=2, n_shared=1, d_ff_expert=32, moe_every=2)
TB, TS = 32, 16


def test_update_temporaries_stay_within_a_slice_piece():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs.base import ArchSpec, ShapeCell
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import transformer as tr

    cfg = tr.LMConfig(**MOE)
    spec = ArchSpec("tiny-moe", "lm", cfg, {"train_4k": ShapeCell(
        "train", lambda c: {"tokens": ((TB, TS), torch.int32),
                            "labels": ((TB, TS), torch.int32)})})
    seen = {"bound": 0, "leaves": [], "worst": (0.0, None)}
    on_pieces = optimizer._on_pieces

    def watched(upd, p, moments=(), wholes=()):
        # the rank's piece of the slice being updated, in f32
        piece = tuple(p.to_local().shape)
        if optimizer._chunks(p):
            piece = piece[1:]
        seen["bound"] = math.prod(piece) * 4
        seen["leaves"].append((tuple(p.shape), bool(wholes)))
        try:
            return on_pieces(upd, p, moments, wholes)
        finally:
            seen["bound"] = 0

    class Watch(dryrun.Counter):
        def track(self, t):
            if (seen["bound"] and id(t) not in self._tracked
                    and dryrun._key(t) not in self._count):
                ratio = dryrun._nbytes(t) / seen["bound"]
                if ratio > seen["worst"][0]:
                    seen["worst"] = (ratio, tuple(t.shape),
                                     seen["leaves"][-1])
            super().track(t)

    chunk = 32 * 1024          # bytes: the stacked leaves go slice by slice
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=5, world_size=16, store=FakeStore())
    try:
        m = mesh_lib.make_mesh((4, 4), ("data", "model"), "cpu")
        with mock.patch.object(tr.LMConfig, "param_count",
                               lambda self: 2e11), \
                mock.patch.object(optimizer, "_on_pieces", watched), \
                mock.patch.object(optimizer, "_CHUNK_BYTES", chunk), \
                mock.patch.object(dryrun, "Counter", Watch):
            bundle = steps.build_lm_cell(spec, "train_4k", m)
            rec = dryrun._run(bundle, fake=True)
    finally:
        dist.destroy_process_group()
    shapes = tr.param_shapes(cfg)
    expert = tuple(shapes["blocks"]["l1"]["moe"]["experts"]["gate"][0])
    wk = tuple(shapes["blocks"]["l0"]["attn"]["wk"][0])
    assert (expert, True) in seen["leaves"] and (wk, True) in seen["leaves"]
    assert math.prod(wk) * 4 > chunk and wk[0] == 8
    assert rec["memory"]["temp_bytes"] > 0
    assert 0 < seen["worst"][0] <= 1, seen["worst"]
