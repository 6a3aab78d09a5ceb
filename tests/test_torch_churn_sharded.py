"""Item-sharded catalog churn on the port (``core.catalog``'s
transactions over ``col``, the churn quarantine of a users- and
item-sharded session with a pending ring, ``serve.faults
.run_faulted_catalog`` on an item-sharded catalog), on 8 gloo CPU ranks.

``repro``'s side runs once in a subprocess (``_run_with_devices``):

  * a sequence of catalog transactions on a whole f32 and int8 catalog
    of 100 items in 128 slots (retirements with padding, duplicates,
    dead and out-of-range ids; adds that overflow the free slots, which
    lie on several ranks' slices; a torn publish, a publish, more
    adds);
  * ``run_faulted_catalog`` under every churn fault at once
    (``tests/test_torch_faults.py``'s mix: sustained churn, swap stalls,
    torn publishes, a flash crowd, a mass retirement; delivery delays,
    loss and duplicates) on a one-host distclub session with a ring.
    Its traffic and churn items come back as a ``faults.Tape``.

``repro``'s own item-sharded churn run is no oracle: its eager catalog
transactions raise a ``ShardingTypeError`` on an item-sharded catalog
(``tests/test_churn.py::test_conservation_and_parity_8dev_item_sharded``
fails in ``repro`` itself).  So the port's 8 ranks (one ``mesh.spawn``
group, a 60 s limit) are held to ``repro``'s one-host results: each
sharded transaction returns ``item_shard`` of the port's whole-catalog
result, itself ``repro``'s, with the same global slot ids, counts and
scales on every rank; the sharded churn run gives ``repro``'s report
(every pending counter, publishes, items added and retired, reward) on
every rank, with the conservation identity checked after every delivery.
The ranks import this module, so it imports neither JAX nor ``repro`` at
top level."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_distributed import _run_with_devices  # noqa: E402

from repro_torch import convert, serve  # noqa: E402
from repro_torch.core import catalog, env  # noqa: E402
from repro_torch.core.types import BanditHyper  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.serve import faults, pending  # noqa: E402

RANKS = 8
N, D, K, B = 64, 8, 10, 16
ROUNDS, N_ITEMS, CAPACITY = 14, 96, 160
HYPER = dict(sigma=4, max_rounds=1, gamma=1.5, n_candidates=K)
CHURN = dict(seed=4, p_delay=0.3, max_delay=3, p_loss=0.05, p_dup=0.05,
             churn_every=3, churn_add=12, churn_retire=10,
             swap_stall_rounds=1, p_torn=0.5, flash_crowd_at=4,
             flash_crowd_size=16, mass_retire_at=7)
# the transaction sequence: 100 items in 128 slots (16 a rank)
TX_ITEMS, TX_CAPACITY = 100, 128
RETIRE = [3, 17, 50, 99, 120, -1, 200, 17, 33]
ADDS = (40, 6)          # the first overflows: 33 free slots

REFERENCE = """
import numpy as np
import jax, jax.numpy as jnp
from repro import serve
from repro.core import catalog as catalog_mod, env
from repro.core.types import BanditHyper
from repro.serve import faults

N, D, K, B = @SIZES@
ROUNDS, N_ITEMS, CAPACITY = @RUN@
TX_ITEMS, TX_CAPACITY = @TX@
out = {}

# the transaction sequence on a whole catalog, f32 and int8
g = np.random.default_rng(0)
base = g.normal(size=(TX_ITEMS, D)).astype(np.float32)
adds = [g.normal(size=(m, D)).astype(np.float32) * (1 + np.arange(m))[:, None]
        for m in @ADDS@]
keep = g.random(TX_CAPACITY) < 0.5
out["tx.base"], out["tx.keep"] = base, keep
for j, a in enumerate(adds):
    out[f"tx.add.{j}"] = a
for prec in ("f32", "int8"):
    c = serve.make_catalog(jnp.asarray(base), capacity=TX_CAPACITY,
                           precision=prec)
    c, n_ret = catalog_mod.retire_items(c, jnp.asarray(@RETIRE@))
    c, slots0, n0 = catalog_mod.add_items(c, jnp.asarray(adds[0]))
    churn = catalog_mod.staged_churn(c)
    c = catalog_mod.torn_publish(c, jnp.asarray(keep))
    c, slots1, n1 = catalog_mod.add_items(c, jnp.asarray(adds[1]))
    c = catalog_mod.publish(c)
    out[f"tx.{prec}.counts"] = np.array([int(n_ret), int(n0), int(churn),
                                         int(n1)])
    out[f"tx.{prec}.slots"] = np.concatenate([np.asarray(slots0),
                                              np.asarray(slots1)])
    for f in ("emb", "live", "born", "scale", "active", "epoch"):
        out[f"tx.{prec}.{f}"] = np.asarray(getattr(c, f))

# run_faulted_catalog under every churn fault, on one host
spec = faults.FaultSpec(**@CHURN@)
hyper = BanditHyper(sigma=4, max_rounds=1, gamma=1.5, n_candidates=K)
e, _ = env.make_catalog_env(jax.random.PRNGKey(1), N, D, 4, N_ITEMS,
                            n_candidates=K)
cat = serve.make_catalog(env.catalog_embeddings(e), capacity=CAPACITY)
for f in e._fields:
    out[f"env.{f}"] = np.asarray(getattr(e, f))
s = faults.TrafficStream(9, B, N, K=K, d=D)
for i in range(ROUNDS):
    u, kr, _ = s.catalog_batch(i)
    out[f"tape.users.{i}"] = np.asarray(u)
    out[f"tape.uniforms.{i}"] = np.asarray(jax.random.uniform(kr, (B,)))
hot = int(np.bincount(np.asarray(e.item_region), minlength=4).argmax())
steps = {2 * spec.flash_crowd_at: (spec.flash_crowd_size, hot)}
for i in range(ROUNDS):
    if (i + 1) % spec.churn_every == 0:
        steps[2 * i + 1] = (spec.churn_add, None)
for step, (m, region) in steps.items():
    k = jax.random.fold_in(jax.random.PRNGKey(spec.seed + 0x5EED), step)
    out[f"tape.churn.{step}"] = np.asarray(
        env.sample_churn_items(e, k, m, region=region)[0])
sess = serve.OnlineBandit.create(N, D, hyper, policy="distclub",
                                 refresh_every=N, pending_capacity=128,
                                 pending_ttl=4, backend="reference")
_, rep = faults.run_faulted_catalog(sess, e, ROUNDS, spec, catalog=cat,
                                    k_short=8, batch=B, key=9,
                                    assert_conservation=True)
out["rep.pending"] = np.array([rep.pending[k] for k in sorted(rep.pending)],
                              np.float64)
out["rep.pending_keys"] = np.array(sorted(rep.pending))
for f in ("interactions", "delivered", "publishes", "items_added",
          "items_retired", "reward"):
    out[f"rep.{f}"] = np.asarray(getattr(rep, f))
np.savez(@OUT_PATH@, **out)
print("REFERENCE-OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("churn_sharded") / "reference.npz"
    code = REFERENCE
    for name, value in (("OUT_PATH", str(path)), ("SIZES", (N, D, K, B)),
                        ("RUN", (ROUNDS, N_ITEMS, CAPACITY)),
                        ("TX", (TX_ITEMS, TX_CAPACITY)),
                        ("RETIRE", RETIRE), ("ADDS", ADDS),
                        ("CHURN", CHURN)):
        code = code.replace(f"@{name}@", repr(value))
    out = _run_with_devices(code)
    assert "REFERENCE-OK" in out
    with np.load(path, allow_pickle=False) as z:
        return dict(z)


def _transactions(t, prec, col):
    """The sequence on the catalog ``col`` holds (the whole one on one
    process, else this rank's slice): the final catalog and each
    transaction's returns."""
    c = catalog.make_catalog(torch.from_numpy(t["tx.base"]),
                             capacity=TX_CAPACITY, precision=prec)
    c = catalog.item_shard(c, col.axis_index(), col.n_shards)
    c, n_ret = catalog.retire_items(c, torch.tensor(RETIRE), col)
    c, slots0, n0 = catalog.add_items(c, torch.from_numpy(t["tx.add.0"]),
                                      col)
    churn = catalog.staged_churn(c, col)
    c = catalog.torn_publish(c, torch.from_numpy(t["tx.keep"]), col)
    c, slots1, n1 = catalog.add_items(c, torch.from_numpy(t["tx.add.1"]),
                                      col)
    c = catalog.publish(c)
    return c, [n_ret, n0, churn, n1, c.n_live(col)], torch.cat([slots0,
                                                                slots1])


def _tape(t):
    churn = {int(k.rsplit(".", 1)[1]): torch.from_numpy(v)
             for k, v in t.items() if k.startswith("tape.churn.")}
    return faults.Tape(
        users=torch.stack([torch.from_numpy(t[f"tape.users.{i}"])
                           for i in range(ROUNDS)]),
        uniforms=torch.stack([torch.from_numpy(t[f"tape.uniforms.{i}"])
                              for i in range(ROUNDS)]),
        churn=churn)


def _churn_run(t, col, dev):
    """``run_faulted_catalog`` on this rank's share: users (a sharded
    session on more than one rank) and the catalog slice."""
    e = convert.record_from_numpy(types.SimpleNamespace(**{
        f: t[f"env.{f}"] for f in env.CatalogEnv._fields}), env.CatalogEnv,
        device=dev)
    kw = dict(policy="distclub", refresh_every=N, pending_capacity=128,
              pending_ttl=4, device=dev)
    hyper = BanditHyper(**HYPER)
    sess = (serve.OnlineBandit.create(N, D, hyper, **kw)
            if col.n_shards == 1
            else serve.OnlineBandit.sharded(col, N, D, hyper, **kw))
    cat = catalog.item_shard(
        catalog.make_catalog(env.catalog_embeddings(e), capacity=CAPACITY),
        col.axis_index(), col.n_shards)
    stream = faults.TrafficStream(9, B, N, device=dev, tape=_tape(t))
    sess, rep = faults.run_faulted_catalog(
        sess, e, ROUNDS, faults.FaultSpec(**CHURN), catalog=cat, k_short=8,
        batch=B, stream=stream, assert_conservation=True)
    assert pending.conservation_gap(sess.pending) == 0
    return rep._replace(tx_per_s=0.0), sess.global_state()


def _churn_rank(rank, col, dev, t):
    """Every transaction on this rank's slice beside ``item_shard`` of
    the whole-catalog result, then the sharded churn run."""
    from repro_torch.runtime.collectives import NullCollectives
    out = {}
    for prec in ("f32", "int8"):
        whole, w_ret, w_slots = _transactions(t, prec, NullCollectives())
        part, p_ret, p_slots = _transactions(t, prec, col)
        want = catalog.item_shard(whole, col.axis_index(), col.n_shards)
        out[prec] = dict(
            slices_equal=[torch.equal(a, b) if isinstance(a, torch.Tensor)
                          else a == b for a, b in zip(part, want)],
            returns=(p_ret, w_ret), slots=(p_slots, w_slots),
            whole=whole)
    out["churn"] = _churn_run(t, col, dev)
    return out


@pytest.fixture(scope="module")
def port_runs(reference):
    return mesh.spawn(_churn_rank, RANKS, "gloo", "cpu", args=(reference,),
                      timeout=60)


@pytest.mark.parametrize("prec", ["f32", "int8"])
def test_sharded_transactions_are_slices_of_the_whole(prec, reference,
                                                      port_runs):
    """Each rank's catalog is ``item_shard`` of the whole-catalog result
    (the first add overflows: 7 of its rows get slot -1, and the slots
    it fills lie on several ranks); every rank returns the global slot
    ids and counts; the whole catalog is ``repro``'s."""
    slots = reference[f"tx.{prec}.slots"]
    assert (slots == -1).sum() == 7
    assert len({int(s) // (TX_CAPACITY // RANKS) for s in slots
                if s >= 0}) > 2
    for run in port_runs:
        got = run[prec]
        assert all(got["slices_equal"]), got["slices_equal"]
        (p_ret, w_ret), (p_slots, w_slots) = got["returns"], got["slots"]
        assert p_ret == w_ret
        assert p_ret[:4] == list(reference[f"tx.{prec}.counts"])
        np.testing.assert_array_equal(p_slots, w_slots)
        np.testing.assert_array_equal(p_slots, slots)
        for f in ("emb", "live", "born", "scale", "active", "epoch"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got["whole"], f)),
                reference[f"tx.{prec}.{f}"], err_msg=f)


def test_sharded_churn_run_matches_reference(reference, port_runs):
    """The 8-rank ``run_faulted_catalog`` (quarantine resolved on the
    owning slice, churn over the ranks) reports ``repro``'s one-host
    counters and reward on every rank, and the port's one-process run on
    the same tape ends in the same state (its float statistics within
    1e-5, the tolerance of ``repro``'s own sharded tests)."""
    keys = [str(k) for k in reference["rep.pending_keys"]]
    want = dict(zip(keys, (float(v) for v in reference["rep.pending"])))
    assert want["stale"] > 0 and int(reference["rep.publishes"]) >= 4
    for run in port_runs:
        rep = run["churn"][0]
        assert rep.pending == want
        for f in ("interactions", "delivered", "publishes", "items_added",
                  "items_retired"):
            assert getattr(rep, f) == int(reference[f"rep.{f}"]), f
        assert rep.reward == float(reference["rep.reward"])
        assert rep == port_runs[0]["churn"][0]
    from repro_torch.runtime.collectives import NullCollectives
    _, one = _churn_run(reference, NullCollectives(), "cpu")
    for f, a, b in zip(one._fields, port_runs[0]["churn"][1], one):
        if f in ("Minv", "b", "uMcinv", "ubc", "umean_occ", "comm_bytes"):
            np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(a, b.numpy(), err_msg=f)
