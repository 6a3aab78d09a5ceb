"""The port's sharded ``club`` and ``linucb`` sessions
(``serve.OnlineBandit.sharded(policy=...)``, users and items split over 8
gloo CPU ranks) against ``repro``'s ``OnlineBandit.sharded`` of the same
policies on 8 XLA host devices, on the same traffic; ``dccb`` is refused
by both with the same reason.

``repro``'s side runs once in a subprocess (``_run_with_devices``): each
policy's 8-device session over 5 slate batches and 3 catalog batches (a
permutation of the users with a duplicate and two padding rows a batch;
club's stage 2 every other batch, over the mesh, at gamma 0.45, where it
splits the users into several clusters).  It hands back the
catalog, the traffic, its Bernoulli draws and its results.  The port's 8
ranks (one ``mesh.spawn`` group, a 60 s limit) serve the same traffic
from their item slices (``catalog.item_shard``): chosen slots and items
and rewards must be equal in every batch, occ, labels and the adjacency
equal, and Minv and b within 1e-5.  The catalog's items are scaled per
id as in ``tests/test_torch_serve_sharded.py``, so that cold users'
scores do not tie.  The ranks import this module, so it imports neither
JAX nor ``repro`` at top level."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_distributed import _run_with_devices  # noqa: E402

from repro_torch import serve  # noqa: E402
from repro_torch.core import catalog, env  # noqa: E402
from repro_torch.core.types import BanditHyper  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.runtime.collectives import DistCollectives  # noqa: E402

RANKS = 8
N, D, N_ITEMS, KS = 64, 8, 256, 16
B, BATCHES, SLATES, K_SLATE = N, 8, 5, 10
REFRESH = 2 * N
HYPER = dict(sigma=4, max_rounds=1, gamma=0.45, n_candidates=10)
POLICIES = ("club", "linucb")
FIELDS = {"club": ("Minv", "b", "occ", "adj", "labels", "since_refresh"),
          "linucb": ("Minv", "b", "occ", "since_refresh")}

REFERENCE = """
import numpy as np
import jax, jax.numpy as jnp
from repro import serve
from repro.core import catalog as catalog_mod, env
from repro.core.types import BanditHyper
from repro.distributed.distclub_shard import named_shardings

N, D, N_ITEMS, KS = %(N)d, %(D)d, %(N_ITEMS)d, %(KS)d
B, BATCHES, SLATES, K_SLATE = %(B)d, %(BATCHES)d, %(SLATES)d, %(K_SLATE)d
hyper = BanditHyper(sigma=4, max_rounds=1, gamma=0.45, n_candidates=10)
e, _ = env.make_catalog_env(jax.random.PRNGKey(0), N, D, 4, N_ITEMS,
                            n_candidates=10)
emb = env.catalog_embeddings(e) * (
    1.0 + jnp.arange(N_ITEMS, dtype=jnp.float32) / (2 * N_ITEMS))[:, None]
cat = serve.make_catalog(emb)
theta = e.theta

def reward_fn(key, uids, ctx, choice):
    return env.step_rewards(key, theta[uids], ctx, choice)

mesh = jax.make_mesh((8,), ("users",))
cat8 = jax.device_put(cat, named_shardings(mesh,
                                           catalog_mod.specs(("users",))))
out = {"emb": np.asarray(emb), "theta": np.asarray(theta)}
rng = np.random.default_rng(1)
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
for policy in %(POLICIES)r:
    s = serve.OnlineBandit.sharded(mesh, N, D, hyper, policy=policy,
                                   refresh_every=%(REFRESH)d,
                                   backend="reference")
    for i in range(BATCHES):
        k, u = jax.random.PRNGKey(i), jnp.asarray(out[f"uids.{i}"])
        if i < SLATES:
            s, it, m = serve.step(s, k, u, jnp.asarray(out[f"slates.{i}"]),
                                  reward_fn)
        else:
            s, it, m = serve.step_catalog(s, k, u, cat8, reward_fn,
                                          k_short=KS)
        out[f"{policy}.items.{i}"] = np.asarray(it)
        out[f"{policy}.reward.{i}"] = np.asarray(m.reward)
    for f in s.state._fields:
        out[f"{policy}.state.{f}"] = np.asarray(getattr(s.state, f))
try:
    serve.OnlineBandit.sharded(mesh, N, D, hyper, policy="dccb")
except NotImplementedError as err:
    print("DCCB-REFUSED:", err)
np.savez(OUT_PATH, **out)
print("REFERENCE-OK")
""" % dict(N=N, D=D, N_ITEMS=N_ITEMS, KS=KS, B=B, BATCHES=BATCHES,
           SLATES=SLATES, K_SLATE=K_SLATE, REFRESH=REFRESH,
           POLICIES=POLICIES)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve_sharded_policies") / "ref.npz"
    out = _run_with_devices(REFERENCE.replace("OUT_PATH", repr(str(path))))
    assert "REFERENCE-OK" in out
    with np.load(path) as z:
        ref = dict(z)
    ref["dccb_reason"] = out.split("DCCB-REFUSED: ", 1)[1].splitlines()[0]
    return ref


def _traffic(ref):
    keys = ["emb", "theta"] + [f"{k}.{i}" for i in range(BATCHES)
                               for k in ("uids", "slates", "uniforms")]
    return {k: ref[k] for k in keys}


def _serve_rank(rank, col, dev, t):
    """Each policy's sharded session over the traffic ``t``, against this
    rank's item slice; items, rewards and the state's rows gathered."""
    hyper = BanditHyper(**HYPER)
    theta = torch.from_numpy(t["theta"])
    full = catalog.make_catalog(torch.from_numpy(t["emb"]))
    cat = catalog.item_shard(full, col.axis_index(), col.n_shards)

    def reward(i, uids, ctx, choice):
        th = theta[uids.clamp(0, N - 1).long()]
        return env.step_rewards(torch.from_numpy(t[f"uniforms.{i}"]), th,
                                ctx, choice)

    out = {}
    for policy in POLICIES:
        s = serve.OnlineBandit.sharded(col, N, D, hyper, policy=policy,
                                       refresh_every=REFRESH, device=dev)
        items, rewards = [], []
        for i in range(BATCHES):
            u = torch.from_numpy(t[f"uids.{i}"])
            if i < SLATES:
                s, it, m = serve.step(s, i, u,
                                      torch.from_numpy(t[f"slates.{i}"]),
                                      reward)
            else:
                s, it, m = serve.step_catalog(s, i, u, cat, reward,
                                              k_short=KS)
            items.append(it)
            rewards.append(m.reward)
        out[policy] = dict(items=torch.stack(items),
                           reward=torch.stack(rewards),
                           state=s.global_state()._asdict())
    return out


@pytest.fixture(scope="module")
def port_runs(reference):
    return mesh.spawn(_serve_rank, RANKS, "gloo", "cpu",
                      args=(_traffic(reference),), timeout=60)


@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_policy_matches_reference_on_8_ranks(policy, reference,
                                                     port_runs):
    got = port_runs[0][policy]
    for i in range(BATCHES):
        np.testing.assert_array_equal(got["items"][i],
                                      reference[f"{policy}.items.{i}"],
                                      err_msg=f"batch {i}")
        assert got["reward"][i] == reference[f"{policy}.reward.{i}"], i
    st = got["state"]
    for f in FIELDS[policy]:
        want = reference[f"{policy}.state.{f}"]
        if f in ("Minv", "b"):
            np.testing.assert_allclose(st[f], want, rtol=0, atol=1e-5,
                                       err_msg=f)
        elif f == "adj":
            np.testing.assert_array_equal(st[f].view(np.uint32), want)
        else:
            np.testing.assert_array_equal(st[f], want, err_msg=f)
    if policy == "club":     # stage 2 ran over the ranks and pruned edges
        bits = np.unpackbits(st["adj"].view(np.uint8)).sum()
        assert 0 < bits < N * (N - 1) and len(np.unique(st["labels"])) > 1
    for other in port_runs[1:]:
        for k in ("items", "reward"):
            np.testing.assert_array_equal(other[policy][k], got[k])
        for f in FIELDS[policy]:
            np.testing.assert_array_equal(other[policy]["state"][f], st[f])
    items = got["items"][SLATES:]
    assert (items[:, [9, 13]] == -1).all()


def test_sharded_dccb_is_refused_as_in_reference(reference):
    two = DistCollectives(group=None, rank=1, shards=2, host_staged=False)
    with pytest.raises(NotImplementedError) as err:
        serve.OnlineBandit.sharded(two, N, D, BanditHyper(**HYPER),
                                   policy="dccb", device="cpu")
    assert str(err.value) == reference["dccb_reason"]
    # the sharded policies build this rank's rows only
    for policy in ("club", "linucb"):
        s = serve.OnlineBandit.sharded(two, N, D, BanditHyper(**HYPER),
                                       policy=policy, device="cpu")
        assert s.state.Minv.shape == (N // 2, D, D)
        assert s.state.occ.shape == (N // 2,)
