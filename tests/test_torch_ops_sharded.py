"""Delayed feedback on the port's users-sharded session and a one-arm
experiment over a sharded arm, on 8 gloo CPU ranks, against ``repro``'s
8-device runs of ``tests/test_faults.py`` (the delay-0 parity of the
sharded split session with the synchronous sharded ``step``) and
``tests/test_experiments.py`` (the single-arm parity on a sharded arm).

``repro``'s side runs once in a subprocess (``_run_with_devices``) and
hands back its traffic, its Bernoulli draws and its results; the port's
8 ranks (one ``mesh.spawn`` group, a 60 s limit) serve the same traffic.
The split session must be bit-equal to the synchronous one on the same
ranks (choices, state, a replicated ring with every decision matched),
the one-arm experiment bit-equal to the plain sharded session, and both
equal to ``repro``: choices and decision ids, occ and labels exactly,
Minv and b within 1e-6.  The ranks import this module, so it imports
neither JAX nor ``repro`` at top level."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_distributed import _run_with_devices  # noqa: E402

from repro_torch import serve  # noqa: E402
from repro_torch.core import env  # noqa: E402
from repro_torch.core.types import BanditHyper  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.serve import experiments  # noqa: E402

RANKS = 8
N, D, K, B = 64, 8, 10, 16
SPLIT_ROUNDS, EXP_ROUNDS = 5, 4
HYPER = dict(sigma=4, max_rounds=1, gamma=1.5, n_candidates=K)
FIELDS = ("Minv", "b", "occ", "labels")

REFERENCE = """
import numpy as np
import jax, jax.numpy as jnp
from repro import serve
from repro.serve import experiments
from repro.core import env
from repro.core.types import BanditHyper

N, D, K, B = %(N)d, %(D)d, %(K)d, %(B)d
hyper = BanditHyper(sigma=4, max_rounds=1, gamma=1.5, n_candidates=K)
e, _ = env.make_synthetic_env(jax.random.PRNGKey(0), N, D, 4, K)
theta = e.theta
mesh = jax.make_mesh((8,), ("users",))
out = {"theta": np.asarray(theta)}

def reward_fn(key, uids, ctx, choice):
    return env.step_rewards(key, theta[uids], ctx, choice)

# tests/test_faults.py: the delay-0 split on the sharded session
sync = serve.OnlineBandit.sharded(mesh, N, D, hyper, policy="distclub",
                                  refresh_every=N)
split = serve.OnlineBandit.sharded(mesh, N, D, hyper, policy="distclub",
                                   refresh_every=N, pending_capacity=64,
                                   pending_ttl=8)
for i in range(%(SPLIT_ROUNDS)d):
    key = jax.random.PRNGKey(i)
    uids = jax.random.randint(jax.random.PRNGKey(100 + i), (B,), 0, N)
    ctx = jax.random.normal(jax.random.PRNGKey(200 + i),
                            (B, K, D)) / jnp.sqrt(jnp.float32(D))
    sync, ch_a, _ = serve.step(sync, key, uids, ctx, reward_fn)
    split, ch_b, ids = serve.recommend(split, uids, ctx)
    realized, _, _, _ = reward_fn(key, uids, ctx, ch_b)
    split = serve.observe_delayed(split, ids, realized, key=key)
    out[f"split.uids.{i}"] = np.asarray(uids)
    out[f"split.ctx.{i}"] = np.asarray(ctx)
    out[f"split.uniforms.{i}"] = np.asarray(jax.random.uniform(key, (B,)))
    out[f"split.choices.{i}"] = np.asarray(ch_b)
    out[f"split.ids.{i}"] = np.asarray(ids)
for f in %(FIELDS)r:
    out[f"split.state.{f}"] = np.asarray(getattr(split.state, f))
out["split.matched"] = np.asarray(serve.pending_stats(split)["matched"])

# tests/test_experiments.py: a one-arm experiment on a sharded arm
mk = lambda: serve.OnlineBandit.sharded(
    mesh, N, D, hyper, policy="distclub", refresh_every=2 * N,
    pending_capacity=128, pending_ttl=16)
exp = experiments.create([mk()])
for i in range(%(EXP_ROUNDS)d):
    u = jax.random.randint(jax.random.PRNGKey(100 + i), (B,), -2, N)
    ctx = jax.random.normal(jax.random.PRNGKey(200 + i),
                            (B, K, D)) / np.sqrt(D)
    exp, c_e, ids_e = experiments.recommend(exp, u, ctx)
    r, _, _, _ = env.step_rewards(jax.random.PRNGKey(300 + i),
                                  theta[u], ctx, c_e)
    exp = experiments.observe_delayed(exp, ids_e, r,
                                      key=jax.random.PRNGKey(400 + i))
    out[f"exp.uids.{i}"] = np.asarray(u)
    out[f"exp.ctx.{i}"] = np.asarray(ctx)
    out[f"exp.uniforms.{i}"] = np.asarray(
        jax.random.uniform(jax.random.PRNGKey(300 + i), (B,)))
    out[f"exp.choices.{i}"] = np.asarray(c_e)
    out[f"exp.ids.{i}"] = np.asarray(ids_e)
for f in %(FIELDS)r:
    out[f"exp.state.{f}"] = np.asarray(getattr(exp.arms[0].state, f))
np.savez(OUT_PATH, **out)
print("REFERENCE-OK")
""" % dict(N=N, D=D, K=K, B=B, SPLIT_ROUNDS=SPLIT_ROUNDS,
           EXP_ROUNDS=EXP_ROUNDS, FIELDS=FIELDS)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ops_sharded") / "reference.npz"
    out = _run_with_devices(REFERENCE.replace("OUT_PATH", repr(str(path))))
    assert "REFERENCE-OK" in out
    with np.load(path) as z:
        return dict(z)


def _rewards(theta, t, kind, i, u, c, choice):
    return env.step_rewards(torch.from_numpy(t[f"{kind}.uniforms.{i}"]),
                            theta[u.clamp(0, N - 1).long()], c, choice)


def _gathered(col, state):
    return {f: (col.all_gather(getattr(state, f)) if f != "labels"
                else state.labels) for f in FIELDS}


def _ops_rank(rank, col, dev, t):
    """Both scenarios on this rank: the synchronous and the split sharded
    session on the same traffic, then a one-arm experiment beside the
    plain sharded session."""
    hyper = BanditHyper(**HYPER)
    theta = torch.from_numpy(t["theta"])

    def session(**kw):
        return serve.OnlineBandit.sharded(col, N, D, hyper, device=dev,
                                          **kw)

    sync = session(refresh_every=N)
    split = session(refresh_every=N, pending_capacity=64, pending_ttl=8)
    out = {"split": {"choices": [], "ids": []}}
    for i in range(SPLIT_ROUNDS):
        u = torch.from_numpy(t[f"split.uids.{i}"])
        c = torch.from_numpy(t[f"split.ctx.{i}"])
        sync, ch_a, _ = serve.step(sync, i, u, c, lambda k, u, c, ch:
                                   _rewards(theta, t, "split", k, u, c, ch))
        split, ch_b, ids = serve.recommend(split, u, c)
        assert torch.equal(ch_a, ch_b)
        realized = _rewards(theta, t, "split", i, u, c, ch_b)[0]
        split = serve.observe_delayed(split, ids, realized)
        out["split"]["choices"].append(ch_b)
        out["split"]["ids"].append(ids)
    for a, b in zip(sync.state, split.state):
        assert torch.equal(a, b)
    out["split"].update(_gathered(col, split.state),
                        pending=serve.pending_stats(split),
                        ring=tuple(split.pending))

    def arm():
        return session(refresh_every=2 * N, pending_capacity=128,
                       pending_ttl=16)

    exp, plain = experiments.create([arm()]), arm()
    out["exp"] = {"choices": [], "ids": []}
    for i in range(EXP_ROUNDS):
        u = torch.from_numpy(t[f"exp.uids.{i}"])
        c = torch.from_numpy(t[f"exp.ctx.{i}"])
        exp, c_e, ids_e = experiments.recommend(exp, u, c)
        plain, c_p, ids_p = serve.recommend(plain, u, c)
        assert torch.equal(c_e, c_p) and torch.equal(ids_e, ids_p)
        r = _rewards(theta, t, "exp", i, u, c, c_e)[0]
        exp = experiments.observe_delayed(exp, ids_e, r)
        plain = serve.observe_delayed(plain, ids_p, r)
        out["exp"]["choices"].append(c_e)
        out["exp"]["ids"].append(ids_e)
    for a, b in zip(exp.arms[0].state, plain.state):
        assert torch.equal(a, b)
    out["exp"].update(_gathered(col, exp.arms[0].state))
    return out


@pytest.fixture(scope="module")
def port_runs(reference):
    traffic = {k: v for k, v in reference.items()
               if k == "theta" or ".state." not in k}
    return mesh.spawn(_ops_rank, RANKS, "gloo", "cpu", args=(traffic,),
                      timeout=60)


@pytest.mark.parametrize("kind,rounds", [("split", SPLIT_ROUNDS),
                                         ("exp", EXP_ROUNDS)])
def test_sharded_ops_match_reference_on_8_ranks(kind, rounds, reference,
                                                port_runs):
    got = port_runs[0][kind]
    for i in range(rounds):
        np.testing.assert_array_equal(got["choices"][i],
                                      reference[f"{kind}.choices.{i}"])
        np.testing.assert_array_equal(got["ids"][i],
                                      reference[f"{kind}.ids.{i}"])
    for f in ("occ", "labels"):
        np.testing.assert_array_equal(got[f], reference[f"{kind}.state.{f}"])
    for f in ("Minv", "b"):
        np.testing.assert_allclose(got[f], reference[f"{kind}.state.{f}"],
                                   rtol=0, atol=1e-6, err_msg=f)
    for other in port_runs[1:]:
        for f in ("choices", "ids", "Minv", "occ", "labels"):
            np.testing.assert_array_equal(np.asarray(other[kind][f]),
                                          np.asarray(got[f]))
    if kind == "split":
        st = got["pending"]
        assert st["in_flight"] == 0 and st["unmatched"] == 0
        assert st["matched"] == int(reference["split.matched"])
        assert st["matched"] == SPLIT_ROUNDS * B
        for other in port_runs[1:]:          # the ring is replicated
            assert other[kind]["pending"] == st
            for a, b in zip(other[kind]["ring"], got["ring"]):
                np.testing.assert_array_equal(a, b)


def test_sharded_session_refuses_a_catalog_ring():
    """Catalog transactions with a pending ring stay single-host."""
    from repro_torch.core import catalog
    from repro_torch.runtime.collectives import DistCollectives
    two = DistCollectives(group=None, rank=0, shards=2, host_staged=False)
    s = serve.OnlineBandit.sharded(two, N, D, BanditHyper(**HYPER),
                                   pending_capacity=32, device="cpu")
    assert s.pending.capacity == 32 and s.state.b.shape == (N // 2, D)
    cat = catalog.make_catalog(torch.eye(D))
    with pytest.raises(ValueError, match="sharded session"):
        serve.recommend_catalog(s, torch.arange(B), cat, k_short=4)
    with pytest.raises(ValueError, match="sharded session"):
        serve.observe_delayed(s, torch.full((B,), -1), torch.zeros(B),
                              catalog=cat)
