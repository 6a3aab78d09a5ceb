"""The port's sharded runtime (``repro_torch.distributed``,
``runtime.collectives.DistCollectives``, ``launch.mesh``) on 8 gloo CPU
ranks against ``repro``'s ``shard_map`` runs on 8 XLA host devices, on
the same inputs.

``repro``'s side runs once, in a subprocess (``_run_with_devices``, as
``tests/test_parity.py``), and hands back its results, its environment
tables and its draws (the port replays them through
``env_ops.tape_draws``).  The port's ranks run in processes of their
own (``mesh.spawn``, three groups in this file, each with a 60 s limit);
they import this module, so it imports neither JAX nor ``repro``.

  (a) the binding: tiled all-gather in rank order, psum on a copy, the
      ring permute, the byte counter;
  (b) ``distclub_shard`` on the synthetic, drift and replay kinds
      (``test_parity.py``'s sizes): exact on interactions, rewards, occ,
      labels, adjacency words, budgets, cluster counts and comm bytes;
      Minv and b within 1e-6, regret and rand_reward within 1e-4; and the
      same 8 ranks against the port's one-process ``core.distclub.run``;
  (c) ``dccb_shard`` (contexts scaled per slot, the reference's choose
      as its Pallas kernel in interpret mode: DCCB's first rounds tie,
      ``tests/test_torch_dccb.py``): exact on occ, rewards, comm bytes;
  (d) ``itemclub.shard_slice`` at 2 and 8 shards.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_distributed import _run_with_devices  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import distclub, env, env_ops, itemclub  # noqa: E402
from repro_torch.core.types import BanditHyper, Metrics  # noqa: E402
from repro_torch.distributed import dccb_shard, distclub_shard  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.runtime import collectives  # noqa: E402

RANKS = 8
N, D, K, E = 64, 8, 10, 3
HYPER = dict(sigma=8, max_rounds=16, gamma=1.5, n_candidates=K)
KINDS = ("synthetic", "drift", "replay")
DN, DD, DK, DL, DE = 64, 8, 10, 8, 6          # the DCCB run
DHYPER = dict(alpha=0.3, gamma=1.0, n_candidates=DK, buffer_size=DL)
N_ITEMS, TILE = 256, 16                         # shard_slice's clusters
SPAWN_S = 60

REFERENCE = """
import numpy as np
import jax, jax.numpy as jnp
from repro.core import backend as jbackend, catalog, env, env_ops, itemclub
from repro.core.types import BanditHyper
from repro.data.datasets import DatasetSpec, make_env
from repro.distributed import dccb_shard, distclub_shard

out = {}
mesh = jax.make_mesh((8,), ("users",))
ref = jbackend.BackendConfig.create("reference")

def uniforms(k_rew, n):
    keys = env_ops._user_keys(k_rew, n, 0)
    return jax.vmap(lambda kk: jax.random.uniform(kk, ()))(keys)

# ---- DistCLUB: test_parity.py's sizes and kinds ------------------------
N, D, K, E = %(N)d, %(D)d, %(K)d, %(E)d
hyper = BanditHyper(sigma=8, max_rounds=16, gamma=1.5, n_candidates=K)
run_keys = jax.random.split(jax.random.PRNGKey(1), E)
round_keys = [tuple(jax.random.split(k)) for ke in run_keys
              for ks in jax.random.split(ke)
              for k in jax.random.split(ks, hyper.max_rounds)]
for kind in ("synthetic", "drift", "replay"):
    if kind == "synthetic":
        e, _ = env.make_synthetic_env(jax.random.PRNGKey(0), N, D, 4, K)
        ops, tables = env_ops.synthetic_ops(e), {"theta": e.theta}
    elif kind == "drift":
        e, _ = env.make_drift_env(jax.random.PRNGKey(0), N, D, 4, K,
                                  drift_period=24, n_phases=3)
        ops, tables = env_ops.drift_ops(e), e._asdict()
    else:
        spec = DatasetSpec("tiny", 4096, N, D, 4, n_candidates=K)
        ops, _ = make_env(spec, seed=3, kind="replay")
        # make_replay_env's tables, by its key schedule (replay.py:32-46)
        k_env, k_items, k_cands = jax.random.split(jax.random.PRNGKey(3), 3)
        e, _ = env.make_synthetic_env(k_env, N, D, 4, K,
                                      within_cluster_noise=0.05)
        feats = jax.random.normal(k_items, (2048, D))
        feats = feats / jnp.linalg.norm(feats, axis=-1, keepdims=True)
        ids = jax.random.randint(k_cands, (N, 64, K), 1, 2048)
        probs = env.expected_reward(e.theta[:, None, None, :], feats[ids])
        assert np.array_equal(ops.contexts_fn(run_keys[0], jnp.zeros(
            N, jnp.int32)), feats[ids[:, 0]])
        tables = {"feats": feats, "ids": ids, "probs": probs}
    for name, v in tables.items():
        out[f"{kind}.env.{name}"] = np.asarray(v)
    draw = jax.jit(lambda kc, kr: (env_ops._unit_contexts(kc, N, K, D, 0),
                                   uniforms(kr, N)))
    ctx, uni = zip(*(draw(kc, kr) for kc, kr in round_keys))
    out[f"{kind}.tape.contexts"] = np.stack(ctx)
    out[f"{kind}.tape.uniforms"] = np.stack(uni)

    init_fn, epoch = distclub_shard.make_runtime(
        mesh, ("users",), N, D, hyper, ops=ops,
        backend=ref.interact(N // 8, D, K), graph=ref.graph(N // 8, N))
    st = init_fn(None)
    ms, ncs = [], []
    for k in run_keys:
        st, m, nc = epoch(st, k)
        ms.append(jax.tree.map(np.asarray, m))
        ncs.append(int(nc))
    for f in st._fields:
        out[f"{kind}.state.{f}"] = np.asarray(getattr(st, f))
    for f in ms[0]._fields:
        out[f"{kind}.metrics.{f}"] = np.stack([getattr(m, f) for m in ms])
    out[f"{kind}.n_clusters"] = np.array(ncs)

# ---- DCCB: contexts scaled per slot, choose as Pallas in interpret ------
n, d, Kd, L, E2 = %(DN)d, %(DD)d, %(DK)d, %(DL)d, %(DE)d
dhyper = BanditHyper(alpha=0.3, gamma=1.0, n_candidates=Kd, buffer_size=L)
e, _ = env.make_synthetic_env(jax.random.PRNGKey(0), n, d, 3, Kd,
                              within_cluster_noise=0.05)
base = env_ops.synthetic_ops(e)
scale = 1.0 + jnp.arange(Kd, dtype=jnp.float32) / (2 * Kd)
ops = base._replace(contexts_fn=lambda key, occ, row0=0:
                    base.contexts_fn(key, occ, row0) * scale[None, :, None])
be = jbackend.BackendConfig.create("pallas").interact(n // 8, d, Kd,
                                                      interpret=True)
epoch = jax.jit(dccb_shard.build_epoch_fn(mesh, ("users",), n, d, L, dhyper,
                                          ops, backend=be))
st = dccb_shard.init_state(n, d, L)
draw = jax.jit(lambda kc, kr: (ops.contexts_fn(kc, jnp.zeros(n, jnp.int32)),
                               uniforms(kr, n)))
ctx, uni, ms = [], [], []
for ke in jax.random.split(jax.random.PRNGKey(5), E2):
    k_int, _ = jax.random.split(ke)
    for k in jax.random.split(k_int, L):
        c, u = draw(*jax.random.split(k))
        ctx.append(np.asarray(c))
        uni.append(np.asarray(u))
    st, m = epoch(st, ke)
    ms.append(jax.tree.map(np.asarray, m))
out["dccb.env.theta"] = np.asarray(e.theta)
out["dccb.tape.contexts"] = np.stack(ctx)
out["dccb.tape.uniforms"] = np.stack(uni)
for f in st._fields:
    out[f"dccb.state.{f}"] = np.asarray(getattr(st, f))
for f in ms[0]._fields:
    out[f"dccb.metrics.{f}"] = np.stack([getattr(m, f) for m in ms])

# ---- shard_slice at 2 and 8 shards ------------------------------------
items = jax.random.normal(jax.random.PRNGKey(7), (%(N_ITEMS)d, 8))
items = items / jnp.linalg.norm(items, axis=-1, keepdims=True)
cl = itemclub.build_clusters(catalog.make_catalog(items),
                             tile_items=%(TILE)d, kind="reference")
for f in cl._fields:
    out[f"clusters.{f}"] = np.asarray(getattr(cl, f))
for S in (2, 8):
    for s in range(S):
        for i, v in enumerate(itemclub.shard_slice(cl, s, %(N_ITEMS)d // S)):
            out[f"slice.{S}.{s}.{i}"] = np.asarray(v)
np.savez(OUT_PATH, **out)
print("REFERENCE-OK")
""" % dict(N=N, D=D, K=K, E=E, DN=DN, DD=DD, DK=DK, DL=DL, DE=DE,
           N_ITEMS=N_ITEMS, TILE=TILE)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded") / "reference.npz"
    out = _run_with_devices(REFERENCE.replace("OUT_PATH", repr(str(path))))
    assert "REFERENCE-OK" in out
    with np.load(path) as z:
        return dict(z)


def _part(ref, prefix):
    """``{field: array}`` of the reference's ``prefix.*`` entries."""
    return {k[len(prefix) + 1:]: v for k, v in ref.items()
            if k.startswith(prefix + ".")}


def _record(fields: dict):
    return collections.namedtuple("Record", list(fields))(**fields)


# ---------------------------------------------------------------------------
# (a) the binding
# ---------------------------------------------------------------------------


def _binding_rank(rank, col, dev):
    collectives.reset_bytes()
    x = torch.arange(3, dtype=torch.int32, device=dev) + 10 * rank
    f = torch.full((2, 2), float(rank + 1), device=dev)
    out = dict(index=col.axis_index(), shards=col.n_shards,
               gathered=col.all_gather(x), summed=col.psum(f), f=f,
               ring=col.permute(x), ring3=col.permute(x, shift=3))
    return out | {"bytes": dict(collectives.BYTES)}


def test_binding_gathers_sums_and_permutes_on_8_ranks():
    outs = mesh.spawn(_binding_rank, RANKS, "gloo", "cpu", timeout=SPAWN_S)
    xs = [np.arange(3, dtype=np.int32) + 10 * r for r in range(RANKS)]
    for r, o in enumerate(outs):
        assert o["index"] == r and type(o["index"]) is int
        assert o["shards"] == RANKS
        np.testing.assert_array_equal(o["gathered"], np.concatenate(xs))
        np.testing.assert_array_equal(o["summed"], np.full((2, 2), 36.0))
        np.testing.assert_array_equal(o["f"], np.full((2, 2), r + 1.0))
        np.testing.assert_array_equal(o["ring"], xs[(r - 1) % RANKS])
        np.testing.assert_array_equal(o["ring3"], xs[(r - 3) % RANKS])
        # ring schedules: 12 bytes to 7 peers; 2 * 7/8 of 16 bytes; 12 + 12
        assert o["bytes"] == {"all_gather": 84, "psum": 28, "permute": 24}


def test_null_collectives_are_the_identity():
    col = collectives.NullCollectives()
    x = torch.arange(4.0)
    assert col.n_shards == 1 and col.axis_index() == 0
    for fn in (col.all_gather, col.psum):
        assert fn(x) is x


# ---------------------------------------------------------------------------
# (b) DistCLUB
# ---------------------------------------------------------------------------


def _distclub_ops(kind, part):
    """The port's ops of ``kind`` on the reference's tables and tape."""
    t = {k: torch.from_numpy(v) for k, v in part.items()}
    if kind == "synthetic":
        return env_ops.tape_ops(t["env.theta"], t["tape.contexts"],
                                t["tape.uniforms"])
    draws = env_ops.tape_draws(t["tape.uniforms"],
                               contexts=t["tape.contexts"])
    if kind == "drift":
        tables = _record({k[4:]: v for k, v in part.items()
                          if k.startswith("env.")})
        return env_ops.drift_ops(
            convert.record_from_numpy(tables, env.DriftEnv, device="cpu"),
            draws)
    return env_ops.replay_ops(t["env.feats"], t["env.ids"], t["env.probs"],
                              draws=draws)


def _inputs(part):
    return {k: v for k, v in part.items() if k.startswith(("env.", "tape."))}


def _distclub_rank(rank, col, dev, inputs):
    hyper = BanditHyper(**HYPER)
    out = {}
    for kind, part in inputs.items():
        init, epoch = distclub_shard.make_runtime(
            col, N, D, hyper, _distclub_ops(kind, part), device=dev)
        st = init()
        ms, ncs = [], []
        for e in range(E):
            st, m, nc = epoch(st, 0, e)
            ms.append(m)
            ncs.append(nc)
        out[kind] = (distclub_shard.gather_state(st, col),
                     Metrics(*(torch.stack(c) for c in zip(*ms))),
                     torch.stack(ncs), st.occ.shape[0])
    return out


@pytest.fixture(scope="module")
def distclub_runs(reference):
    inputs = {k: _inputs(_part(reference, k)) for k in KINDS}
    return mesh.spawn(_distclub_rank, RANKS, "gloo", "cpu", args=(inputs,),
                      timeout=SPAWN_S)


@pytest.mark.parametrize("kind", KINDS)
def test_distclub_shard_matches_reference_on_8_ranks(kind, reference,
                                                     distclub_runs):
    ref = _part(reference, kind)
    st, m, nc, n_local = distclub_runs[0][kind]
    assert n_local == N // RANKS
    # the gathered state and the summed metrics are the same on every rank
    for other in distclub_runs[1:]:
        for a, b in zip(other[kind][0] + other[kind][1],
                        st + m):
            np.testing.assert_array_equal(a, b)
    want = _part(ref, "state")
    for f in ("occ", "labels", "u_rounds", "c_rounds", "comm_bytes"):
        np.testing.assert_array_equal(getattr(st, f), want[f], err_msg=f)
    np.testing.assert_array_equal(st.adj.view(np.uint32), want["adj"])
    np.testing.assert_allclose(st.Minv, want["Minv"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.b, want["b"], rtol=0, atol=1e-6)
    got_m, want_m = m, _part(ref, "metrics")
    np.testing.assert_array_equal(got_m.reward, want_m["reward"])
    np.testing.assert_array_equal(got_m.interactions,
                                  want_m["interactions"])
    np.testing.assert_allclose(got_m.regret, want_m["regret"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got_m.rand_reward, want_m["rand_reward"],
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(nc, ref["n_clusters"])
    assert int(got_m.interactions.sum()) > 0

    # the port's one-process run on the same draws, exact in the same way
    _build.reset_launches()
    s1, m1, c1 = distclub.run(_distclub_ops(kind, _inputs(ref)), 0,
                              BanditHyper(**HYPER), E, D, device="cpu")
    assert not any(_build.LAUNCHES.values())
    np.testing.assert_array_equal(got_m.reward.reshape(-1), m1.reward)
    np.testing.assert_array_equal(got_m.interactions.reshape(-1),
                                  m1.interactions)
    np.testing.assert_array_equal(nc, c1)
    for got, one in ((st.occ, s1.lin.occ), (st.labels, s1.graph.labels),
                     (st.adj, s1.graph.adj), (st.u_rounds, s1.u_rounds),
                     (st.c_rounds, s1.c_rounds),
                     (st.comm_bytes, s1.comm_bytes)):
        np.testing.assert_array_equal(got, one.numpy())
    np.testing.assert_allclose(st.Minv, s1.lin.Minv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.b, s1.lin.b, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# (c) DCCB
# ---------------------------------------------------------------------------


def _dccb_rank(rank, col, dev, part):
    t = {k: torch.from_numpy(v) for k, v in part.items()}
    ops = env_ops.tape_ops(t["env.theta"], t["tape.contexts"],
                           t["tape.uniforms"])
    collectives.reset_bytes()
    init, epoch = dccb_shard.make_runtime(
        col, DN, DD, DL, BanditHyper(**DHYPER), ops, device=dev)
    st = init()
    ms = []
    for e in range(DE):
        st, m = epoch(st, 0, e)
        ms.append(m)
    ring = collectives.BYTES["permute"]
    return (dccb_shard.gather_state(st, col),
            Metrics(*(torch.stack(c) for c in zip(*ms))), ring)


def test_dccb_shard_matches_reference_on_8_ranks(reference):
    ref = _part(reference, "dccb")
    outs = mesh.spawn(_dccb_rank, RANKS, "gloo", "cpu",
                      args=(_inputs(ref),), timeout=SPAWN_S)
    st, m, ring = outs[0]
    want, want_m = _part(ref, "state"), _part(ref, "metrics")
    np.testing.assert_array_equal(st.occ, want["occ"])
    assert int(st.occ.min()) == DE * DL
    np.testing.assert_array_equal(m.reward, want_m["reward"])
    np.testing.assert_array_equal(m.interactions, want_m["interactions"])
    per_user = (DL + 1) * (DD * DD + DD) * 4
    assert float(st.comm_bytes) == float(want["comm_bytes"]) \
        == DE * DN * per_user
    # the ring moved each rank's (current + buffer) statistics once an
    # epoch: Mw, bw, xbuf, rbuf and occ of its 8 users
    local = DN // RANKS
    assert ring == DE * local * 4 * (DD * DD + DD + DL * DD + DL + 1)
    for f in ("Mw", "bw", "xbuf", "rbuf"):
        np.testing.assert_allclose(getattr(st, f), want[f], rtol=0,
                                   atol=1e-5, err_msg=f)
    for other in outs[1:]:
        np.testing.assert_array_equal(other[0].Mw, st.Mw)


# ---------------------------------------------------------------------------
# (d) shard_slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 8])
def test_shard_slice_matches_reference(shards, reference):
    cl = convert.record_from_numpy(_record(_part(reference, "clusters")),
                                   itemclub.ItemClusters, device="cpu")
    n_local = N_ITEMS // shards
    for s in range(shards):
        got = itemclub.shard_slice(cl, s, n_local)
        want = [reference[f"slice.{shards}.{s}.{i}"] for i in range(8)]
        assert len(got) == len(want) == 8      # scale_sorted at index 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        assert got[0].shape == (n_local, 8) and got[5].shape == (
            n_local // TILE,)
    with pytest.raises(ValueError, match="tile_items"):
        itemclub.shard_slice(cl, 0, TILE + TILE // 2)
