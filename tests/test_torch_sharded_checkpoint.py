"""Checkpoints of the port's sharded serving session, and what rests on
them, on 8 gloo CPU ranks, against ``repro`` on 8 XLA host devices:
``OnlineBandit.save``/``restore`` across rank counts, ``Guarded`` with a
tracked catalog, ``shortlist_recall`` and ``experiments.save``/``restore``
with sharded arms.

``repro``'s side runs once in a subprocess (``_run_with_devices``):

  A. a distclub session on 8 devices serves 4 catalog batches (a
     permutation of the users with a duplicate and two padding rows a
     batch, stage 2 every batch's worth), is saved, and serves 3 more;
     restored onto a 4-device mesh and onto one host, it serves the same
     3 batches.
  B. ``shortlist_recall`` of served items and of items it did not serve,
     over 3 batches of a one-host session (on a mesh session ``repro``'s
     eager ``gather_score`` raises a ``ShardingTypeError``).
  C. ``Guarded`` with a tracked catalog: a small churn admitted, an
     oversized retirement rolled back, on one host (``repro``'s eager
     ``retire_items`` raises a ``ShardingTypeError`` on an item-sharded
     catalog).
  D. a two-arm experiment (distclub and linucb arms on 8 devices, each
     with a ring) saved after 3 rounds, restored, 3 more rounds.

The port runs each on 8 ranks (one ``mesh.spawn`` group, a 60 s limit),
the restore of A also on 4 ranks (a second group) and in one process.
Items, choices, decision ids, recall values and guardrail events must be
``repro``'s; the rolled-back catalog ``repro``'s; a sharded save must
write the files of a one-process save of the gathered state, and its
manifest holds ``repro``'s keys and global shapes.  The ranks import this
module, so it imports neither JAX nor ``repro`` at top level."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_distributed import _run_with_devices  # noqa: E402

from repro_torch import serve  # noqa: E402
from repro_torch.core import catalog, env  # noqa: E402
from repro_torch.core.types import BanditHyper  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.runtime.collectives import NullCollectives  # noqa: E402
from repro_torch.serve import experiments, guardrails  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402

SIZES = N, D, N_ITEMS, KS, K = 64, 8, 256, 16, 10
SCHEDULE = B, BATCHES, SAVE_AT = 64, 7, 4
EXP_SCHEDULE = EXP_B, EXP_ROUNDS, EXP_SAVE_AT = 16, 6, 3
HYPER = dict(sigma=4, max_rounds=1, gamma=1.5, n_candidates=K)
GUARD = dict(churn_ceiling=0.25, snapshot_every=2, cooldown=1)

REFERENCE = """import json, pathlib
import numpy as np
import jax, jax.numpy as jnp
from repro import serve
from repro.core import catalog as catalog_mod, env
from repro.core.types import BanditHyper
from repro.distributed.distclub_shard import named_shardings
from repro.serve import experiments, guardrails
from repro.train.checkpoint import CheckpointManager

N, D, N_ITEMS, KS, K = SIZES
B, BATCHES, SAVE_AT = SCHEDULE
EXP_B, EXP_ROUNDS, EXP_SAVE_AT = EXP_SCHEDULE
DIR = pathlib.Path(OUT_DIR)
hyper = BanditHyper(sigma=4, max_rounds=1, gamma=1.5, n_candidates=K)
e, _ = env.make_catalog_env(jax.random.PRNGKey(0), N, D, 4, N_ITEMS,
                            n_candidates=K)
emb = env.catalog_embeddings(e) * (
    1.0 + jnp.arange(N_ITEMS, dtype=jnp.float32) / (2 * N_ITEMS))[:, None]
cat = serve.make_catalog(emb)
theta = e.theta

def reward_fn(key, uids, ctx, choice):
    return env.step_rewards(key, theta[uids], ctx, choice)

def mesh_of(n):
    return jax.make_mesh((n,), ("users",), devices=jax.devices()[:n])

def on(mesh, c):
    return jax.device_put(c, named_shardings(mesh,
                                             catalog_mod.specs(("users",))))

mesh8, mesh4 = mesh_of(8), mesh_of(4)
out = {"emb": np.asarray(emb), "theta": np.asarray(theta)}
for i in range(BATCHES):
    u = np.array(jax.random.permutation(jax.random.PRNGKey(100 + i), N),
                 np.int32)
    u[5], u[9], u[13] = u[0], -1, N + 3
    out[f"uids.{i}"] = u
    out[f"uniforms.{i}"] = np.asarray(
        jax.random.uniform(jax.random.PRNGKey(i), (B,)))

def session(mesh):
    kw = dict(policy="distclub", refresh_every=N, backend="reference")
    if mesh is None:
        return serve.OnlineBandit.create(N, D, hyper, **kw)
    return serve.OnlineBandit.sharded(mesh, N, D, hyper, **kw)

def serve_batches(s, c, lo, hi, tag):
    for i in range(lo, hi):
        s, it, m = serve.step_catalog(s, jax.random.PRNGKey(i),
                                      jnp.asarray(out[f"uids.{i}"]), c,
                                      reward_fn, k_short=KS)
        out[f"{tag}.items.{i}"] = np.asarray(it)
    return s

# A. save on 8 devices, restore onto 4 devices and onto one host
ck = CheckpointManager(DIR / "ckpt")
s = serve_batches(session(mesh8), on(mesh8, cat), 0, SAVE_AT, "unbroken")
s.save(ck, SAVE_AT)
serve_batches(s, on(mesh8, cat), SAVE_AT, BATCHES, "unbroken")
for tag, mesh, c in (("r4", mesh4, on(mesh4, cat)), ("r1", None, cat)):
    r, step = session(mesh).restore(ck)
    assert step == SAVE_AT
    serve_batches(r, c, SAVE_AT, BATCHES, tag)
out["manifest"] = np.frombuffer(
    (ck._step_dir(SAVE_AT) / "manifest.json").read_bytes(), np.uint8)

# B. shortlist_recall of served and of other items (on one host: on a
# mesh session its eager gather_score raises a ShardingTypeError)
s = session(None)
for i in range(3):
    u = jnp.asarray(out[f"uids.{i}"])
    s2, it, _ = serve.step_catalog(s, jax.random.PRNGKey(i), u, cat,
                                   reward_fn, k_short=KS)
    bad = jnp.where(jnp.arange(B) % 3 == 0, N_ITEMS - 1 - it, it)
    out[f"recall.{i}"] = np.array(
        [guardrails.shortlist_recall(s, cat, u, x, k_short=KS)
         for x in (it, bad)])
    s = s2
c8 = on(mesh8, cat)

# C. Guarded with a tracked catalog: a small churn admitted, an oversized
# retirement rolled back (state, catalog and epoch); on one host (on an
# item-sharded catalog the eager retire_items raises a ShardingTypeError)
g = guardrails.Guarded.create(
    session(None), CheckpointManager(DIR / "guard", keep=4),
    guardrails.GuardrailConfig(**GUARD),
    catalog=cat)
for i in range(3):
    g, it, _ = g.step_catalog(jax.random.PRNGKey(i),
                              jnp.asarray(out[f"uids.{i}"]),
                              reward_fn=reward_fn, k_short=KS)
    out[f"guard.items.{i}"] = np.asarray(it)
    if i == 1:
        g, slots = g.stage_churn(retire=jnp.array([0, 1, 40, 200]),
                                 add=jnp.eye(D)[:3])
        out["guard.slots"] = np.asarray(slots)
        g = g.publish()
g, _ = g.stage_churn(retire=jnp.arange(2, 90))
g = g.publish()
i = 3
g, it, _ = g.step_catalog(jax.random.PRNGKey(i),
                          jnp.asarray(out[f"uids.{i}"]),
                          reward_fn=reward_fn, k_short=KS)
out["guard.items.3"] = np.asarray(it)
out["guard.events"] = np.frombuffer(json.dumps(
    [list(map(str, ev)) for ev in g.events]).encode(), np.uint8)
for f in ("emb", "live", "born", "scale", "active", "epoch"):
    out[f"guard.catalog.{f}"] = np.asarray(getattr(g.catalog, f))

# D. a two-arm experiment of sharded arms, saved and restored mid-run
def arms():
    return [serve.OnlineBandit.sharded(mesh8, N, D, hyper, policy=p,
                                       refresh_every=2 * N,
                                       backend="reference",
                                       pending_capacity=128, pending_ttl=16)
            for p in ("distclub", "linucb")]

def exp_round(x, i, tag):
    u = jax.random.randint(jax.random.PRNGKey(500 + i), (EXP_B,), -2, N)
    c = jax.random.normal(jax.random.PRNGKey(600 + i),
                          (EXP_B, K, D)) / np.sqrt(D)
    out[f"exp.uids.{i}"] = np.asarray(u)
    out[f"exp.ctx.{i}"] = np.asarray(c)
    out[f"exp.uniforms.{i}"] = np.asarray(
        jax.random.uniform(jax.random.PRNGKey(700 + i), (EXP_B,)))
    x, ch, ids = experiments.recommend(x, u, c)
    r, _, _, _ = env.step_rewards(jax.random.PRNGKey(700 + i), theta[u], c,
                                  ch)
    x = experiments.observe_delayed(x, ids, r, key=jax.random.PRNGKey(i))
    out[f"exp.{tag}.choices.{i}"] = np.asarray(ch)
    out[f"exp.{tag}.ids.{i}"] = np.asarray(ids)
    return x

x = experiments.create(arms())
for i in range(EXP_SAVE_AT):
    x = exp_round(x, i, "unbroken")
experiments.save(x, CheckpointManager(DIR / "exp"), EXP_SAVE_AT)
for i in range(EXP_SAVE_AT, EXP_ROUNDS):
    x = exp_round(x, i, "unbroken")
y, step = experiments.restore(experiments.create(arms()),
                              CheckpointManager(DIR / "exp"))
assert step == EXP_SAVE_AT
for i in range(EXP_SAVE_AT, EXP_ROUNDS):
    y = exp_round(y, i, "restored")
np.savez(DIR / "reference.npz", **out)
print("REFERENCE-OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_ckpt_ref")
    code = REFERENCE
    for name, value in (("OUT_DIR", str(d)), ("EXP_SCHEDULE", EXP_SCHEDULE),
                        ("SCHEDULE", SCHEDULE), ("SIZES", SIZES),
                        ("GUARD", GUARD)):
        code = code.replace(name, repr(value))
    out = _run_with_devices(code)
    assert "REFERENCE-OK" in out
    with np.load(d / "reference.npz") as z:
        return dict(z)


def _traffic(ref):
    keys = ["emb", "theta"] + [k for k in ref if k.startswith(
        ("uids.", "uniforms.", "exp.uids.", "exp.ctx.", "exp.uniforms."))]
    return {k: ref[k] for k in keys}


class _World:
    """The traffic ``t`` on one rank: its catalog slice, its rewards."""

    def __init__(self, t, col):
        self.t, self.col = t, col
        self.theta = torch.from_numpy(t["theta"])
        self.full = catalog.make_catalog(torch.from_numpy(t["emb"]))
        self.cat = catalog.item_shard(self.full, col.axis_index(),
                                      col.n_shards)

    def reward(self, i, uids, ctx, choice):
        th = self.theta[uids.clamp(0, N - 1).long()]
        return env.step_rewards(torch.from_numpy(self.t[f"uniforms.{i}"]),
                                th, ctx, choice)

    def users(self, i):
        return torch.from_numpy(self.t[f"uids.{i}"])

    def session(self, dev, **kw):
        kw = dict(policy="distclub", refresh_every=N, device=dev, **kw)
        if self.col.n_shards == 1:
            return serve.OnlineBandit.create(N, D, BanditHyper(**HYPER), **kw)
        return serve.OnlineBandit.sharded(self.col, N, D,
                                          BanditHyper(**HYPER), **kw)

    def serve(self, s, lo, hi):
        items = []
        for i in range(lo, hi):
            s, it, _ = serve.step_catalog(s, i, self.users(i), self.cat,
                                          self.reward, k_short=KS)
            items.append(it)
        return s, torch.stack(items)


def _restore_rank(rank, col, dev, t, ckdir):
    """A's restore on these ranks: the batches after the save."""
    w = _World(t, col)
    s, step = w.session(dev).restore(CheckpointManager(ckdir / "ckpt"))
    assert step == SAVE_AT
    return w.serve(s, SAVE_AT, BATCHES)[1]


def _experiment_round(x, t, i, theta):
    u = torch.from_numpy(t[f"exp.uids.{i}"])
    c = torch.from_numpy(t[f"exp.ctx.{i}"])
    x, ch, ids = experiments.recommend(x, u, c)
    r = env.step_rewards(torch.from_numpy(t[f"exp.uniforms.{i}"]),
                         theta[u.clamp(0, N - 1).long()], c, ch)[0]
    return experiments.observe_delayed(x, ids, r), ch, ids


def _ckpt_rank(rank, col, dev, t, ckdir):
    """A, B, C and D on this rank."""
    w, out = _World(t, col), {}
    ck = CheckpointManager(ckdir / "ckpt")

    # A: save after SAVE_AT batches, then the unbroken run
    s, first = w.serve(w.session(dev), 0, SAVE_AT)
    s.save(ck, SAVE_AT)
    out["saved"] = s.global_state()
    _, rest = w.serve(s, SAVE_AT, BATCHES)
    out["unbroken"] = torch.cat([first, rest])
    try:
        w.session(dev, precision="bf16").restore(ck)
    except ValueError as err:
        out["precision_error"] = str(err)

    # B: the recall probe over the ranks
    s, out["recall"] = w.session(dev), []
    for i in range(3):
        s2, it, _ = serve.step_catalog(s, i, w.users(i), w.cat, w.reward,
                                       k_short=KS)
        bad = torch.where(torch.arange(B) % 3 == 0, N_ITEMS - 1 - it, it)
        out["recall"].append([guardrails.shortlist_recall(
            s, w.cat, w.users(i), x, k_short=KS) for x in (it, bad)])
        s = s2

    # C: a guarded session with its catalog slice tracked
    g = guardrails.Guarded.create(
        w.session(dev), CheckpointManager(ckdir / "guard", keep=4),
        guardrails.GuardrailConfig(recall_floor=0.99, warmup=0, **GUARD),
        catalog=w.cat)
    out["guard_items"] = []
    for i in range(3):
        g, it, _ = g.step_catalog(i, w.users(i), reward_fn=w.reward,
                                  k_short=KS, probe_recall=True)
        out["guard_items"].append(it)
        if i == 1:
            g, out["guard_slots"] = g.stage_churn(
                retire=torch.tensor([0, 1, 40, 200]), add=torch.eye(D)[:3])
            g = g.publish()
    out["guard_recall"] = g.gs.ema_recall
    snap = g.ckpt.restore(g.last_snapshot, {"state": g.session.state,
                                            "catalog": g.catalog})
    g, _ = g.stage_churn(retire=torch.arange(2, 90))
    g = g.publish()
    # the rolled-back pair is the snapshot's, this rank's slices of it
    whole = serve.policies.gather_rows(g.catalog, col, catalog.specs())
    out["rolled_back_to_snapshot"] = all(
        torch.equal(a, b) for a, b in zip(
            (*g.session.global_state(), *whole[:4]),
            (*snap["state"], *snap["catalog"][:4])))
    assert (whole.active, whole.epoch) == (snap["catalog"].active,
                                           snap["catalog"].epoch)
    g, it, _ = g.step_catalog(3, w.users(3), reward_fn=w.reward, k_short=KS)
    out["guard_items"].append(it)
    out["guard_events"] = [list(map(str, ev)) for ev in g.events]
    out["guard_catalog"] = serve.policies.gather_rows(g.catalog, col,
                                                      catalog.specs())

    # D: two sharded arms, saved and restored mid-run
    def arms():
        return [serve.OnlineBandit.sharded(
            col, N, D, BanditHyper(**HYPER), policy=p, refresh_every=2 * N,
            pending_capacity=128, pending_ttl=16, device=dev)
            for p in ("distclub", "linucb")]

    x, out["exp"] = experiments.create(arms()), {}
    for tag in ("unbroken", "restored"):
        out["exp"][tag] = {"choices": [], "ids": []}
    for i in range(EXP_ROUNDS):
        if i == EXP_SAVE_AT:
            experiments.save(x, CheckpointManager(ckdir / "exp"), i)
        x, ch, ids = _experiment_round(x, t, i, w.theta)
        out["exp"]["unbroken"]["choices"].append(ch)
        out["exp"]["unbroken"]["ids"].append(ids)
    y, step = experiments.restore(experiments.create(arms()),
                                  CheckpointManager(ckdir / "exp"))
    assert step == EXP_SAVE_AT
    for i in range(EXP_SAVE_AT, EXP_ROUNDS):
        y, ch, ids = _experiment_round(y, t, i, w.theta)
        out["exp"]["restored"]["choices"].append(ch)
        out["exp"]["restored"]["ids"].append(ids)
    for a, b in zip(x.arms, y.arms):
        assert all(torch.equal(p, q) for p, q in zip(a.state, b.state))
        assert all(torch.equal(p, q) for p, q in zip(a.pending, b.pending))
    return out


@pytest.fixture(scope="module")
def port_runs(reference, tmp_path_factory):
    ckdir = tmp_path_factory.mktemp("sharded_ckpt_port")
    t = _traffic(reference)
    runs = mesh.spawn(_ckpt_rank, 8, "gloo", "cpu", args=(t, ckdir),
                      timeout=60)
    r4 = mesh.spawn(_restore_rank, 4, "gloo", "cpu", args=(t, ckdir),
                    timeout=60)
    r1 = _restore_rank(0, NullCollectives(), "cpu", t, ckdir)
    return dict(runs=runs, r4=r4, r1=r1.numpy(), ckdir=ckdir)


def test_sharded_restore_resumes_on_8_4_and_1_ranks(reference, port_runs):
    """A: saved on 8 ranks, restored onto 4 and onto one process, the
    next batches are the unbroken run's and ``repro``'s on its 4-device
    mesh and its one host."""
    for run in port_runs["runs"]:
        for i in range(BATCHES):
            np.testing.assert_array_equal(run["unbroken"][i],
                                          reference[f"unbroken.items.{i}"])
    for tag, got in (("r4", port_runs["r4"]), ("r1", [port_runs["r1"]])):
        for items in got:
            for j, i in enumerate(range(SAVE_AT, BATCHES)):
                np.testing.assert_array_equal(
                    items[j], reference[f"{tag}.items.{i}"], err_msg=tag)
                np.testing.assert_array_equal(
                    items[j], reference[f"unbroken.items.{i}"])


def test_sharded_save_writes_the_files_of_a_single_host_save(
        reference, port_runs, tmp_path):
    """One checkpoint, written by rank 0: its manifest and arrays are a
    one-process save's of the gathered state, and its keys and shapes
    ``repro``'s (the adjacency stored as int32 holding ``repro``'s uint32
    bits, the port's layout)."""
    run = port_runs["runs"][0]
    state = type(serve.OnlineBandit.create(
        N, D, BanditHyper(**HYPER), device="cpu").state)(
            *(torch.from_numpy(np.asarray(v)) for v in run["saved"]))
    one = CheckpointManager(tmp_path / "one")
    one.save({"prec": torch.tensor([0, 0, 0, 512], dtype=torch.int32),
              "state": state}, SAVE_AT)
    got = port_runs["ckdir"] / "ckpt" / f"step-{SAVE_AT:010d}"
    want = tmp_path / "one" / f"step-{SAVE_AT:010d}"
    assert sorted(p.name for p in got.parent.iterdir()) == [got.name]
    manifest = json.loads((got / "manifest.json").read_text())
    assert manifest == json.loads((want / "manifest.json").read_text())
    with np.load(got / "arrays.npz") as a, np.load(want / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    ref = json.loads(bytes(reference["manifest"]).decode())
    assert manifest["keys"] == ref["keys"]
    assert manifest["shapes"] == ref["shapes"]
    dtypes = dict(zip(ref["keys"], ref["dtypes"]))
    dtypes["['state'].adj"] = "int32"
    assert manifest["dtypes"] == [dtypes[k] for k in ref["keys"]]


def test_sharded_restore_refuses_a_precision_mismatch(port_runs):
    for run in port_runs["runs"]:
        assert "precision mismatch" in run["precision_error"]


def test_shortlist_recall_over_8_ranks_matches_reference(reference,
                                                         port_runs):
    for run in port_runs["runs"]:
        for i in range(3):
            assert run["recall"][i] == list(reference[f"recall.{i}"])
        assert run["recall"][0][0] == 1.0


def test_guarded_rolls_back_over_8_ranks(reference, port_runs):
    """C: the events, the items and the rolled-back catalog (global) are
    ``repro``'s; the restored pair is the snapshot's on every rank; the
    recall probe reads 1.0 on the healthy batches."""
    want = json.loads(bytes(reference["guard.events"]).decode())
    assert any(ev[0] == "rollback" for ev in want)
    for run in port_runs["runs"]:
        assert run["guard_events"] == want
        assert run["rolled_back_to_snapshot"]
        assert run["guard_recall"] == 1.0
        np.testing.assert_array_equal(run["guard_slots"],
                                      reference["guard.slots"])
        for i in range(4):
            np.testing.assert_array_equal(run["guard_items"][i],
                                          reference[f"guard.items.{i}"])
        cat = run["guard_catalog"]
        for f in ("emb", "live", "born", "scale", "active", "epoch"):
            np.testing.assert_array_equal(
                np.asarray(getattr(cat, f)),
                reference[f"guard.catalog.{f}"], err_msg=f)


def test_experiment_with_sharded_arms_saves_and_restores(reference,
                                                         port_runs):
    """D: the unbroken and the restored experiment route and choose as
    ``repro``'s, round for round."""
    for run in port_runs["runs"]:
        for tag in ("unbroken", "restored"):
            rounds = (range(EXP_ROUNDS) if tag == "unbroken"
                      else range(EXP_SAVE_AT, EXP_ROUNDS))
            got = run["exp"][tag]
            for j, i in enumerate(rounds):
                for k in ("choices", "ids"):
                    np.testing.assert_array_equal(
                        got[k][j], reference[f"exp.{tag}.{k}.{i}"],
                        err_msg=f"{tag} {k} {i}")
