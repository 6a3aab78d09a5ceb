"""The port's sharded serving session (``serve.OnlineBandit.sharded``,
the ``distclub`` policy, users and items split over 8 gloo CPU ranks)
against ``repro``'s ``OnlineBandit.sharded`` on 8 XLA host devices, at
``tests/test_retrieval.py``'s item-sharded sizes, on the same traffic.

``repro``'s side runs once in a subprocess (``_run_with_devices``): a
one-process session, then sharded sessions unpruned and cluster-pruned,
each over two slate batches and five catalog batches (the port's
pruned run serves its slate batches through ``recommend`` and
``observe``, its unpruned run through ``step``; a permutation of
the users with a duplicate and two padding rows a batch; stage 2 every
other batch).  It hands back the catalog, the traffic, its Bernoulli
draws and its results.  The port's 8 ranks (one ``mesh.spawn`` group, a
60 s limit) serve the same traffic unpruned and pruned from their item
slices (``catalog.item_shard``): chosen slots and items and rewards must
be equal in every batch, occ, labels and the adjacency equal, and Minv
and b within 1e-6, against ``repro`` and against the port's one-process
session.

The catalog's items are scaled per id, ``(1 + i / (2 N_ITEMS))``: a user
whose one reward so far was 0 scores every item by its ``Minv`` norm
alone, and unit items nearly orthogonal to its first context then tie to
the last ulp, where the two packages may round apart (unscaled, batch 2
of this traffic has one such tie: 154 against 229 for user 17)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_distributed import _run_with_devices  # noqa: E402

from repro_torch import serve  # noqa: E402
from repro_torch.core import catalog, env  # noqa: E402
from repro_torch.core.types import BanditHyper, Metrics  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.runtime import collectives  # noqa: E402

RANKS = 8
N, D, N_ITEMS, KS, TILE = 64, 8, 256, 16, 16
B, BATCHES, SLATES, K_SLATE = N, 7, 2, 10
REFRESH = 2 * N
HYPER = dict(sigma=4, max_rounds=1, gamma=1.5, n_candidates=10)
RETIRED = [3, 17, 200]
PATHS = ("unpruned", "pruned")

REFERENCE = """
import numpy as np
import jax, jax.numpy as jnp
from repro import serve
from repro.core import catalog as catalog_mod, env
from repro.core.types import BanditHyper
from repro.distributed.distclub_shard import named_shardings

N, D, N_ITEMS, KS, TILE = %(N)d, %(D)d, %(N_ITEMS)d, %(KS)d, %(TILE)d
B, BATCHES, SLATES, K_SLATE = %(B)d, %(BATCHES)d, %(SLATES)d, %(K_SLATE)d
hyper = BanditHyper(sigma=4, max_rounds=1, gamma=1.5, n_candidates=10)
e, _ = env.make_catalog_env(jax.random.PRNGKey(0), N, D, 4, N_ITEMS,
                            n_candidates=10)
# items scaled per id, as tests/test_torch_serve.py scales dccb's catalog
emb = env.catalog_embeddings(e) * (
    1.0 + jnp.arange(N_ITEMS, dtype=jnp.float32) / (2 * N_ITEMS))[:, None]
cat = serve.make_catalog(emb)
cat, _ = serve.retire_items(cat, jnp.array(%(RETIRED)r, jnp.int32))
cat = serve.publish(cat)
theta = e.theta

def reward_fn(key, uids, ctx, choice):
    return env.step_rewards(key, theta[uids], ctx, choice)

mesh = jax.make_mesh((8,), ("users",))
cat8 = jax.device_put(cat, named_shardings(mesh,
                                           catalog_mod.specs(("users",))))
clusters = serve.build_clusters(cat, tile_items=TILE, kind="reference")
out = {"emb": np.asarray(emb), "theta": np.asarray(theta)}
rng = np.random.default_rng(0)
for i in range(BATCHES):
    u = np.array(jax.random.permutation(jax.random.PRNGKey(100 + i), N),
                 np.int32)
    u[5], u[9], u[13] = u[0], -1, N + 3
    s = rng.normal(size=(B, K_SLATE, D))
    out[f"uids.{i}"] = u
    out[f"slates.{i}"] = (s / np.linalg.norm(s, axis=-1, keepdims=True)
                          ).astype(np.float32)
    out[f"uniforms.{i}"] = np.asarray(
        jax.random.uniform(jax.random.PRNGKey(i), (B,)))
for path in ("single", "unpruned", "pruned"):
    kw = dict(policy="distclub", refresh_every=%(REFRESH)d,
              backend="reference")
    if path == "single":
        s, c = serve.OnlineBandit.create(N, D, hyper, **kw), cat
    else:
        s, c = serve.OnlineBandit.sharded(mesh, N, D, hyper, **kw), cat8
    for i in range(BATCHES):
        k, u = jax.random.PRNGKey(i), jnp.asarray(out[f"uids.{i}"])
        if i < SLATES:
            s, it, m = serve.step(s, k, u, jnp.asarray(out[f"slates.{i}"]),
                                  reward_fn)
        elif path == "pruned":
            s, it, m, rm = serve.step_catalog(s, k, u, c, reward_fn,
                                              k_short=KS, clusters=clusters)
            assert int(rm.pruned_active) == 1
        else:
            s, it, m = serve.step_catalog(s, k, u, c, reward_fn, k_short=KS)
        out[f"{path}.items.{i}"] = np.asarray(it)
        out[f"{path}.reward.{i}"] = np.asarray(m.reward)
    for f in ("Minv", "b", "occ", "adj", "labels", "since_refresh"):
        out[f"{path}.state.{f}"] = np.asarray(getattr(s.state, f))
np.savez(OUT_PATH, **out)
print("REFERENCE-OK")
""" % dict(N=N, D=D, N_ITEMS=N_ITEMS, KS=KS, TILE=TILE, B=B,
           BATCHES=BATCHES, SLATES=SLATES, K_SLATE=K_SLATE, RETIRED=RETIRED,
           REFRESH=REFRESH)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve_sharded") / "reference.npz"
    out = _run_with_devices(REFERENCE.replace("OUT_PATH", repr(str(path))))
    assert "REFERENCE-OK" in out
    with np.load(path) as z:
        return dict(z)


def _traffic(ref):
    keys = ["emb", "theta"] + [f"{k}.{i}" for i in range(BATCHES)
                               for k in ("uids", "slates", "uniforms")]
    return {k: ref[k] for k in keys}


def _serve(session, col, t, paths):
    """Serve the traffic ``t`` on each of ``paths`` from ``session()``,
    against this rank's item slice; returns items, rewards and the final
    state (rows gathered over the ranks)."""
    theta = torch.from_numpy(t["theta"])
    full = catalog.make_catalog(torch.from_numpy(t["emb"]))
    full, _ = catalog.retire_items(full, torch.tensor(RETIRED))
    full = catalog.publish(full)
    cat = catalog.item_shard(full, col.axis_index(), col.n_shards)
    clusters = serve.build_clusters(full, tile_items=TILE)

    def reward(i, uids, ctx, choice):
        th = theta[uids.clamp(0, N - 1).long()]
        return env.step_rewards(torch.from_numpy(t[f"uniforms.{i}"]), th,
                                ctx, choice)

    out = {}
    for path in paths:
        s, items, rewards = session(), [], []
        for i in range(BATCHES):
            u = torch.from_numpy(t[f"uids.{i}"])
            ctx = torch.from_numpy(t[f"slates.{i}"])
            if i < SLATES and path == "pruned":
                # the transaction's two halves, which must equal ``step``
                it = serve.recommend(s, u, ctx)
                realized = reward(i, u, ctx, it)[0]
                s = serve.observe(s, u, ctx, it, realized)
                m = Metrics(torch.sum(realized * ((u >= 0) & (u < N))),
                            None, None, None)
            elif i < SLATES:
                s, it, m = serve.step(s, i, u, ctx, reward)
            elif path == "pruned":
                s, it, m, rm = serve.step_catalog(s, i, u, cat, reward,
                                                  k_short=KS,
                                                  clusters=clusters)
                assert rm.pruned_active == 1
            else:
                s, it, m = serve.step_catalog(s, i, u, cat, reward,
                                              k_short=KS)
            items.append(it)
            rewards.append(m.reward)
        st = s.state
        out[path] = dict(
            items=torch.stack(items), reward=torch.stack(rewards),
            labels=st.labels,
            since_refresh=st.since_refresh,
            **{f: col.all_gather(getattr(st, f))
               for f in ("Minv", "b", "occ", "adj")})
    return out


def _serve_rank(rank, col, dev, t):
    hyper = BanditHyper(**HYPER)
    return _serve(lambda: serve.OnlineBandit.sharded(
        col, N, D, hyper, refresh_every=REFRESH, device=dev), col, t, PATHS)


@pytest.fixture(scope="module")
def port_runs(reference):
    return mesh.spawn(_serve_rank, RANKS, "gloo", "cpu",
                      args=(_traffic(reference),), timeout=60)


def _assert_served_equal(got, ref, path):
    for i in range(BATCHES):
        np.testing.assert_array_equal(got["items"][i],
                                      ref[f"{path}.items.{i}"])
        assert got["reward"][i] == ref[f"{path}.reward.{i}"]
    want = {k.rsplit(".", 1)[1]: v for k, v in ref.items()
            if k.startswith(f"{path}.state.")}
    for f in ("occ", "labels", "since_refresh"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_array_equal(np.asarray(got["adj"]).view(np.uint32),
                                  want["adj"])
    for f in ("Minv", "b"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("path", PATHS)
def test_sharded_session_matches_reference_on_8_ranks(path, reference,
                                                      port_runs):
    got = port_runs[0][path]
    # the reference's own sharded and one-process sessions agree
    for i in range(BATCHES):
        np.testing.assert_array_equal(reference[f"{path}.items.{i}"],
                                      reference[f"single.items.{i}"])
    _assert_served_equal(got, reference, path)
    for other in port_runs[1:]:
        for k in ("items", "reward", "labels", "Minv", "occ"):
            np.testing.assert_array_equal(other[path][k], got[k])
    # retired items are never served, padding rows get -1
    items = got["items"][SLATES:]
    assert not set(items.ravel().tolist()) & set(RETIRED)
    assert (items[:, [9, 13]] == -1).all()
    if path == "pruned":
        np.testing.assert_array_equal(got["items"],
                                      port_runs[0]["unpruned"]["items"])

    # the port's one-process session on the same traffic
    one = _serve(lambda: serve.OnlineBandit.create(
        N, D, BanditHyper(**HYPER), refresh_every=REFRESH, device="cpu"),
        collectives.NullCollectives(), _traffic(reference), (path,))[path]
    _assert_served_equal({k: np.asarray(v) for k, v in one.items()},
                         reference, "single")


def test_sharded_session_refuses_uneven_users_and_other_policies():
    three = collectives.DistCollectives(group=None, rank=1, shards=3,
                                        host_staged=False)
    hyper = BanditHyper(**HYPER)
    with pytest.raises(ValueError, match="divide evenly"):
        serve.OnlineBandit.sharded(three, N, D, hyper, device="cpu")
    # dccb has no sharded session, as in ``repro``; club and linucb do
    with pytest.raises(NotImplementedError, match="single-host only"):
        serve.OnlineBandit.sharded(three, 63, D, hyper, policy="dccb",
                                   device="cpu")
    for policy in ("club", "linucb"):
        s = serve.OnlineBandit.sharded(three, 63, D, hyper, policy=policy,
                                       device="cpu")
        assert s.state.Minv.shape == (21, D, D)
    s = serve.OnlineBandit.sharded(three, 63, D, hyper, device="cpu")
    assert s.state.Minv.shape == (21, D, D) and s.state.labels.shape == (63,)
    # rank 1's packed rows start at user 21: its self edges are cleared
    rows = torch.arange(21)
    assert not bool(((s.state.adj[rows, (rows + 21) // 32]
                      >> ((rows + 21) % 32)) & 1).any())
    with pytest.raises(ValueError, match="divide evenly"):
        catalog.item_shard(catalog.make_catalog(torch.ones(10, D)), 0, 3)
