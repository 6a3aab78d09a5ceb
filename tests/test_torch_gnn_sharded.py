"""The port's sharded GAT loss (``models.gnn.gat_loss_local``) on 8 gloo
CPU ranks (``launch.mesh.spawn``) against ``repro``'s 8-device
``shard_map`` run of tests/test_distributed.py's setup (128 nodes of 16
features, 512 edges partitioned by destination block, 5 classes), run
once in a subprocess that writes its inputs and results to a file:

  * the loss, with the exact gather (through bf16) and the int8 one;
  * the first layer's int8 codes, equal except where ``|h / scale|`` lies
    within one ulp of a .5 boundary (the two packages' ``x @ W`` sum in
    other orders);
  * the gradients averaged over the ranks (``launch.steps``' mean), both
    gathers; and the int8 gather's backward equal to the exact
    reduce-scatter of the cotangents (straight through).

The ranks import this module, so it imports neither JAX nor ``repro``
at top level.  Tolerances: losses and gradients within 1e-5 (gradients
atol 1e-5 x the leaf's largest |g|)."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RANKS = 8

_REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.models import gnn

mesh = jax.make_mesh((8,), ("d",))
n, e = 128, 512
cfg = gnn.GNNConfig(d_feat=16, n_classes=5)
params = gnn.init_gat(jax.random.PRNGKey(0), cfg)
feats = jax.random.normal(jax.random.PRNGKey(1), (n, 16))
dst = jnp.concatenate([jax.random.randint(jax.random.PRNGKey(i), (e // 8,),
                                          i * 16, (i + 1) * 16)
                       for i in range(8)])
src = jax.random.randint(jax.random.PRNGKey(9), (e,), 0, n)
labels = jax.random.randint(jax.random.PRNGKey(3), (n,), 0, 5)
mask = jnp.ones((n,), bool)
node = (P(), P("d", None), P("d"), P("d"), P("d"), P("d"))
out = {}
for quant in (False, True):
    c = gnn.GNNConfig(d_feat=16, n_classes=5, quantized_gather=quant)

    def body(p, fe, s, d_, l, m, c=c):
        loss, g = jax.value_and_grad(lambda p: gnn.gat_loss_local(
            p, c, fe, s, d_, l, m, ("d",)))(p)
        return loss, jax.lax.pmean(g, "d")

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=node,
                          out_specs=(P(), P()), check_rep=False))
    loss, grads = f(params, feats, src, dst, labels, mask)
    out[f"loss_{int(quant)}"] = np.asarray(loss)
    for i, g in enumerate(jax.tree.leaves(grads)):
        out[f"grad_{int(quant)}_{i}"] = np.asarray(g)


def codes(p, fe):
    # the int8 gather's codes of this shard's first-layer rows (gnn.py)
    h = fe @ p[0]["W"]
    scale = jnp.maximum(jnp.max(jnp.abs(h), axis=-1, keepdims=True) / 127.0,
                        1e-9)
    return jnp.clip(jnp.round(h / scale), -127, 127).astype(jnp.int8)


out["codes"] = np.asarray(jax.jit(shard_map(
    codes, mesh=mesh, in_specs=(P(), P("d", None)), out_specs=P("d", None),
    check_rep=False))(params, feats))
for i, leaf in enumerate(jax.tree.leaves(params)):
    out[f"param_{i}"] = np.asarray(leaf)
for name, a in (("feats", feats), ("src", src), ("dst", dst),
                ("labels", labels), ("mask", mask)):
    out[name] = np.asarray(a)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("gnn") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={RANKS}",
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                          str(path)], capture_output=True, text=True,
                         env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(path) as f:
        return dict(f)


def _params(ref):
    """``repro``'s parameter leaves (W, a_dst, a_src a layer, keys
    sorted) as the port's list of dicts."""
    leaves = [torch.from_numpy(ref[f"param_{i}"]) for i in range(6)]
    return [dict(zip(("W", "a_dst", "a_src"), leaves[3 * j:3 * j + 3]))
            for j in range(2)]


def _rank(rank, col, dev, ref):
    """One rank: its rows and its destination block of edges."""
    n_loc, e_loc = 128 // col.n_shards, 512 // col.n_shards
    rows = slice(rank * n_loc, (rank + 1) * n_loc)
    cut = slice(rank * e_loc, (rank + 1) * e_loc)
    args = [torch.from_numpy(ref[k][s]) for k, s in (
        ("feats", rows), ("src", cut), ("dst", cut), ("labels", rows),
        ("mask", rows))]
    params = _params(ref)
    out = {}
    for quant in (False, True):
        cfg = gnn.GNNConfig(d_feat=16, n_classes=5, quantized_gather=quant)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = gnn.gat_loss_local(params, cfg, *args, col)
        grads = torch.autograd.grad(loss, leaves)
        out[f"loss_{int(quant)}"] = loss.detach()
        out[f"grads_{int(quant)}"] = [col.psum(g) / col.n_shards
                                      for g in grads]
    with torch.no_grad():
        out["codes"], _ = gnn.quantize_rows(args[0] @ params[0]["W"])
        out["h"] = args[0] @ params[0]["W"]
    # straight through: the int8 gather's backward is the exact f32
    # gather's, the reduce-scatter of the cotangent
    h = (args[0] @ params[0]["W"]).detach().requires_grad_(True)
    ct = torch.randn(128, h.shape[1],
                     generator=torch.Generator().manual_seed(7))
    q8 = gnn.gather_features(h, gnn.GNNConfig(quantized_gather=True), col)
    (dq,) = torch.autograd.grad(q8, h, ct)
    out["straight_through"] = bool(torch.equal(dq, col.psum_scatter(ct)))
    return out


@pytest.fixture(scope="module")
def ranks(reference):
    return mesh.spawn(_rank, RANKS, "gloo", "cpu", args=(reference,),
                      timeout=60.0)


@pytest.mark.parametrize("quant", [0, 1], ids=["exact", "int8"])
def test_sharded_loss_matches_reference(reference, ranks, quant):
    want = float(reference[f"loss_{quant}"])
    for r in ranks:
        np.testing.assert_allclose(float(r[f"loss_{quant}"]), want,
                                   rtol=1e-5)
    # the int8 gather moves the loss by well under repro's own 5% bound
    exact, q8 = (float(ranks[0][f"loss_{i}"]) for i in (0, 1))
    assert abs(exact - q8) / abs(exact) < 0.05


@pytest.mark.parametrize("quant", [0, 1], ids=["exact", "int8"])
def test_sharded_grads_match_reference(reference, ranks, quant):
    for r in ranks:
        for i, g in enumerate(r[f"grads_{quant}"]):
            w = reference[f"grad_{quant}_{i}"]
            assert g.shape == w.shape and np.abs(w).max() > 0
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())
    # every rank ends with the same mean
    for r in ranks[1:]:
        for a, b in zip(r[f"grads_{quant}"], ranks[0][f"grads_{quant}"]):
            np.testing.assert_array_equal(a, b)


def test_int8_codes_match_reference_off_half_boundaries(reference, ranks):
    got = np.concatenate([r["codes"] for r in ranks])
    h = np.concatenate([r["h"] for r in ranks])
    want = reference["codes"]
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape
    scale = np.maximum(np.abs(h).max(-1, keepdims=True) / 127.0, 1e-9)
    r = np.abs(h / scale)
    near_half = np.abs(r - np.floor(r) - 0.5) <= np.spacing(r)
    differ = got != want
    assert not (differ & ~near_half).any()
    assert np.abs(got.astype(int) - want).max() <= 1
    assert int((got == 127).sum() + (got == -127).sum()) >= 128


def test_int8_backward_is_the_exact_reduce_scatter(ranks):
    assert all(r["straight_through"] for r in ranks)
