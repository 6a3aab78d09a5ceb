"""The port's GAT (``repro_torch.models.gnn``) against ``repro``'s on the
CPU: the same numpy parameters (carried by ``convert.gat_from_numpy``)
and random graphs through ``gat_fwd``, ``gat_loss`` and its gradients at
every gat-cora cell's ``cell_cfg`` (with tests/test_arch_smoke.py's
d_feat 12 and 5 classes), on a graph with nodes that no edge enters,
the ``NeighborSampler`` draw for draw, the cells' configs and input
specs, and ``launch.steps.gnn_train_step`` on a world of one against
``repro``'s own step (``build_gnn_cell`` on a one-device mesh).  The
sharded loss is in ``test_torch_gnn_sharded.py``.

Tolerances: logits, losses and gradients within 1e-5 (gradients: rtol
1e-5, atol 1e-5 x the leaf's largest |g|); a step's parameters within
1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.train import optimizer as joptim  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs import gat_cora  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.runtime.collectives import NullCollectives  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CELLS = list(jconfigs.get("gat-cora").shapes)


def _cfgs(cell, **over):
    over = {"d_feat": 12, "n_classes": 5, **over}
    return (dataclasses.replace(jconfigs.get("gat-cora").cell_cfg(cell),
                                **over),
            dataclasses.replace(configs.get("gat-cora").cell_cfg(cell),
                                **over))


def _graph(n, e, d_feat, n_classes, seed, dst_hi=None):
    """Random graph arrays: feats N(0, 1), src uniform, dst uniform below
    ``dst_hi`` (default n), labels uniform, a random mask."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d_feat)).astype(np.float32),
            rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, dst_hi or n, e).astype(np.int32),
            rng.integers(0, n_classes, n).astype(np.int32),
            rng.random(n) < 0.7)


def _pair(cell, seed=0, **over):
    jcfg, cfg = _cfgs(cell, **over)
    params = jgnn.init_gat(jax.random.PRNGKey(seed), jcfg)
    tp = convert.gat_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    return jcfg, cfg, params, tp


def _grads_close(got, want):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def _check_cell(cell, graph):
    jcfg, cfg, params, tp = _pair(cell)
    jargs = [jnp.asarray(a) for a in graph]
    targs = [torch.from_numpy(a) for a in graph]
    want = jgnn.gat_fwd(params, jcfg, *jargs[:3])
    _build.reset_launches()
    got = gnn.gat_fwd(tp, cfg, *targs[:3])
    assert not any(_build.LAUNCHES.values())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    jloss, jgrads = jax.value_and_grad(jgnn.gat_loss)(params, jcfg, *jargs)
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    loss, grads = train.value_and_grad(gnn.gat_loss, tp, tp, cfg, *targs)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _grads_close(grads, jgrads)
    return got


@pytest.mark.parametrize("cell", CELLS)
def test_gat_fwd_loss_and_grads_match_reference(cell):
    _check_cell(cell, _graph(64, 256, 12, 5, seed=1))


def test_gat_with_nodes_that_no_edge_enters_matches_reference():
    """Edges enter only the first 40 of 64 nodes: the other 24 have empty
    segments (segment max -inf, mapped to 0), so their logits are 0."""
    logits = _check_cell("full_graph_sm",
                         _graph(64, 256, 12, 5, seed=2, dst_hi=40))
    assert bool((logits[40:] == 0).all())
    assert bool((logits[:40] != 0).any())


def test_neighbor_sampler_matches_reference_draw_for_draw():
    """The CSR arrays, then three rounds of 1024-free sampling (seeds 32,
    fanouts 15-10 and 4-3-2) from the same ``default_rng`` seeds, on a
    graph with nodes of in-degree 0 (self loops)."""
    rng = np.random.default_rng(0)
    n, e = 500, 3000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - 50, e)            # the last 50: in-degree 0
    ours = gnn.NeighborSampler(n, src, dst)
    theirs = jgnn.NeighborSampler(n, src, dst)
    np.testing.assert_array_equal(ours.nbr, theirs.nbr)
    np.testing.assert_array_equal(ours.offsets, theirs.offsets)
    for seed, fanouts in ((1, (15, 10)), (2, (4, 3, 2)), (3, (15, 10))):
        seeds = np.random.default_rng(seed + 10).choice(n, 32, replace=False)
        got = ours.sample(np.random.default_rng(seed), seeds, fanouts)
        want = theirs.sample(np.random.default_rng(seed), seeds, fanouts)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        n_tot = 32 * (1 + sum(np.cumprod(fanouts)))
        assert got[0].shape == (n_tot,)


def test_cells_are_the_reference_cells():
    spec, jspec = configs.get("gat-cora"), jconfigs.get("gat-cora")
    assert spec.family == jspec.family == "gnn"
    assert spec.source == jspec.source
    assert list(spec.shapes) == list(jspec.shapes)
    assert gat_cora.FANOUTS == jconfigs.gat_cora.FANOUTS
    assert gat_cora.BATCH_NODES == jconfigs.gat_cora.BATCH_NODES
    assert gat_cora.CELL_DIMS == jconfigs.gat_cora.CELL_DIMS
    for cell in jspec.shapes:
        ours, theirs = spec.shapes[cell], jspec.shapes[cell]
        assert (ours.kind, ours.note, ours.cfg_overrides) == (
            theirs.kind, theirs.note, theirs.cfg_overrides)
        cfg, jcfg = spec.cell_cfg(cell), jspec.cell_cfg(cell)
        for f in dataclasses.fields(cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.dtype == torch.float32
        got, want = spec.input_specs(cell), jspec.input_specs(cell)
        assert list(got) == list(want)
        for name, (shape, dtype) in got.items():
            assert shape == tuple(want[name].shape), (cell, name)
            assert str(dtype).split(".")[-1] == str(want[name].dtype), (
                cell, name)
    # a registered spec with no overrides hands back its own config
    lm = configs.get("qwen3-4b")
    assert lm.cell_cfg("train_4k") is lm.cfg


@pytest.mark.parametrize("cell,n_steps", [("molecule", 3),
                                          ("ogb_products", 1)])
def test_gnn_train_step_on_one_rank_matches_reference(cell, n_steps):
    """Steps of ``gnn_train_step`` on a world of one against ``repro``'s
    ``build_gnn_cell`` step on a one-device mesh, at the cell's own
    config: losses and every parameter and moment.  molecule (the exact
    gather through bf16, 16 features) for three steps.  ogb_products (the
    int8 gather, 100 features) for its first: once the two packages'
    parameters differ by round-off, an int8 code whose ``h / scale`` lies
    near a .5 boundary rounds apart, a step of 1/127 of its row's largest
    value, and the next losses part by ~3e-6."""
    jspec, spec = jconfigs.get("gat-cora"), configs.get("gat-cora")
    jcfg, cfg = jspec.cell_cfg(cell), spec.cell_cfg(cell)
    bundle = jsteps.build_gnn_cell(jspec, cell, jax.make_mesh((1,), ("d",)))
    step = jax.jit(bundle.step_fn)
    params = jgnn.init_gat(jax.random.PRNGKey(3), jcfg)
    jopt = joptim.adamw_init(params)
    tp = convert.gat_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    opt = optimizer.adamw_init(tp)
    graph = _graph(64, 256, cfg.d_feat, cfg.n_classes, seed=4)
    for _ in range(n_steps):
        params, jopt, jloss = step(
            params, jopt, *(jnp.asarray(a) for a in graph))
        tp, opt, loss = steps.gnn_train_step(
            tp, opt, cfg, *(torch.from_numpy(a) for a in graph),
            NullCollectives())
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for got, want in zip(tree_leaves((tp, opt.m, opt.v)),
                             jax.tree.leaves((params, jopt.m, jopt.v))):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=1e-5,
                                       atol=1e-5)
    assert int(opt.step) == int(jopt.step) == n_steps


def test_gat_from_numpy_checks_shapes():
    jcfg, cfg = _cfgs("molecule")
    params = jax.tree.map(np.asarray,
                          jgnn.init_gat(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="layer 1"):
        convert.gat_from_numpy(params, dataclasses.replace(cfg, n_classes=6),
                               device="cpu")
    with pytest.raises(ValueError, match="layers"):
        convert.gat_from_numpy(params[:1], cfg, device="cpu")
    tp = convert.gat_from_numpy(params, cfg, device="cpu")
    assert [sorted(layer) for layer in tp] == [["W", "a_dst", "a_src"]] * 2
    assert tp[0]["W"].dtype == torch.float32
