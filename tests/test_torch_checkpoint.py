"""The port's checkpointing (``repro_torch.train.checkpoint``) and the
serving session's ``save``/``restore``, mirroring ``repro``'s tests on
the CPU: the round trip and keep-K (``tests/test_substrate.py``), a dead
writer's leftovers and corrupted checkpoints skipped
(``tests/test_faults.py``), a restored session resuming bit-identically
and an empty directory restoring nothing (``tests/test_serve.py``), a
precision mismatch refused (``tests/test_precision.py``), bf16 tensors
bit-exact through numpy's uint16, and ``examples/serve_bandit_torch.py``
at a reduced step count."""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import serve  # noqa: E402
from repro_torch.core.types import BanditHyper  # noqa: E402
from repro_torch.serve import policies  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N, D, K, B = 24, 6, 8, 12
HYPER = BanditHyper(alpha=0.3, sigma=4, max_rounds=1, gamma=1.5,
                    n_candidates=K)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "Minv": torch.randn(8, 4, 4, generator=g),
        "b": torch.randn(8, 4, generator=g),
        "occ": torch.arange(8, dtype=torch.int32),
        "bits": torch.randint(-2**31, 2**31 - 1, (3, 5), generator=g,
                              dtype=torch.int32),
        "codes": torch.randint(-127, 128, (6, 4), generator=g,
                               dtype=torch.int32).to(torch.int8),
        "half": torch.randn(5, 3, generator=g).bfloat16(),
        "nested": (torch.ones(2, dtype=torch.bool), [7, 2.5]),
    }


def _assert_same(a, b):
    flat_a, flat_b = checkpoint._flatten(a), checkpoint._flatten(b)
    assert flat_a.keys() == flat_b.keys()
    for k, x in flat_a.items():
        y = flat_b[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert type(x) is type(y) and x == y, k


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = _state()
    mgr.save(state, 100)
    restored, step = mgr.restore_latest(_state(1))
    assert step == 100
    _assert_same(state, restored)
    manifest = json.loads((tmp_path / "step-0000000100" / "manifest.json")
                          .read_text())
    assert manifest["magic"] == "repro-ckpt-v1"
    assert "bfloat16" in manifest["dtypes"] and "int8" in manifest["dtypes"]


def test_bf16_round_trips_bit_exactly(tmp_path):
    """Every bf16 bit pattern but NaNs' payloads comes back as it went:
    numpy stores the uint16 bits, the manifest the logical dtype."""
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16)
    t = bits.view(torch.bfloat16)
    t = t[~torch.isnan(t)]
    mgr = CheckpointManager(tmp_path)
    mgr.save({"t": t}, 1)
    back = mgr.restore(1, {"t": torch.zeros(1, dtype=torch.bfloat16)})["t"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))
    with np.load(tmp_path / "step-0000000001" / "arrays.npz") as z:
        assert z["0"].dtype == np.uint16
    # restored onto the like tree's dtype: an f32 leaf gets the values
    wide = mgr.restore(1, {"t": torch.zeros(1)})["t"]
    assert wide.dtype == torch.float32 and torch.equal(wide, t.float())


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(_state(s), s)
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4
    _assert_same(mgr.restore(3, _state()), _state(3))


def test_checkpoint_crash_leaves_no_corruption(tmp_path, monkeypatch):
    """A dead writer's tmp dir is not a checkpoint, and a writer that dies
    before its rename leaves the last checkpoint as it was."""
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(_state(), 5)
    (tmp_path / "tmp-6").mkdir()                       # a dead writer
    (tmp_path / "tmp-6" / "arrays.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 5
    restored, step = mgr.restore_latest(_state(1))
    assert step == 5
    _assert_same(restored, _state())

    def crash(*a, **k):
        raise OSError("the writer died")

    monkeypatch.setattr(checkpoint.os, "replace", crash)
    with pytest.raises(OSError, match="died"):
        mgr.save(_state(7), 7)
    monkeypatch.undo()
    assert mgr.steps() == [5]
    _assert_same(mgr.restore_latest(_state(1))[0], _state())


def test_restore_latest_skips_truncated_and_bad_magic(tmp_path):
    ck = CheckpointManager(tmp_path / "ck", keep=5)
    state = {"a": torch.arange(4.0), "b": torch.ones(2, 3)}
    for s in (1, 2, 3):
        ck.save({k: v + s for k, v in state.items()}, s)
    d3 = ck._step_dir(3)
    (d3 / "arrays.npz").write_bytes((d3 / "arrays.npz").read_bytes()[:16])
    d2 = ck._step_dir(2)
    m = json.loads((d2 / "manifest.json").read_text())
    m["magic"] = "not-a-checkpoint"
    (d2 / "manifest.json").write_text(json.dumps(m))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        restored, step = ck.restore_latest(state)
    assert step == 1 and len(w) == 2
    assert torch.equal(restored["a"], torch.arange(4.0) + 1)
    # a missing key fails the load too
    with pytest.raises(KeyError, match="missing"):
        ck.restore(1, {**state, "c": torch.zeros(1)})
    d1 = ck._step_dir(1)
    (d1 / "manifest.json").write_text("{not json")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="no loadable checkpoint"):
            ck.restore_latest(state)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------


def _traffic(i):
    g = torch.Generator().manual_seed(100 + i)
    u = torch.randperm(N, generator=g)[:B].to(torch.int32)
    ctx = torch.randn(B, K, D, generator=g)
    return u, ctx / torch.linalg.norm(ctx, dim=-1, keepdim=True)


def _theta():
    g = torch.Generator().manual_seed(7)
    th = torch.randn(N, D, generator=g)
    return th / torch.linalg.norm(th, dim=-1, keepdim=True)


THETA = _theta()


def reward_fn(i, uids, ctx, choice):
    from repro_torch.core import env
    u = torch.rand(uids.shape[0], generator=torch.Generator().manual_seed(i))
    return env.step_rewards(u, THETA[uids.long()], ctx, choice)


def _session(precision=None, policy="distclub"):
    return serve.OnlineBandit.create(N, D, HYPER, policy=policy,
                                     refresh_every=N, precision=precision,
                                     device="cpu")


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_checkpoint_restore_resumes_bit_identical(tmp_path, precision):
    """Kill and restore through CheckpointManager: the restarted replica's
    choices and state are bit-identical to the uninterrupted run's."""
    ck = CheckpointManager(tmp_path / "svc", keep=2)
    sess = _session(precision)
    for i in range(3):
        sess, _, _ = serve.step(sess, i, *_traffic(i), reward_fn)
    sess.save(ck, 3)
    cont, want = sess, []
    for i in range(3, 6):
        cont, ch, _ = serve.step(cont, i, *_traffic(i), reward_fn)
        want.append(ch)
    restored, step = _session(precision).restore(ck)
    assert step == 3
    for i, w in zip(range(3, 6), want):
        restored, ch, _ = serve.step(restored, i, *_traffic(i), reward_fn)
        assert torch.equal(ch, w)
    for a, b in zip(restored.state, cont.state):
        # a counter comes back in the fresh session's integer dtype
        assert a.dtype == b.dtype or not a.is_floating_point()
        assert a.shape == b.shape and torch.equal(a, b.to(a.dtype))


def test_restore_on_empty_directory(tmp_path):
    ck = CheckpointManager(tmp_path / "empty")
    sess = _session(policy="linucb")
    same, step = sess.restore(ck)
    assert step is None and same is sess


def test_checkpoint_precision_mismatch_raises(tmp_path):
    """A bf16 session's checkpoint restores under bf16, reduced dtypes
    intact, and is refused under f32 and int8."""
    s16 = _session("bf16")
    s16, _, _ = serve.step(s16, 0, *_traffic(0), reward_fn)
    ck = CheckpointManager(tmp_path / "prec", keep=2)
    s16.save(ck, 1)
    back, step = _session("bf16").restore(ck, step=1)
    assert step == 1 and back.state.Minv.dtype == torch.bfloat16
    assert torch.equal(back.state.Minv, s16.state.Minv)
    for other in ("f32", "int8"):
        with pytest.raises(ValueError, match="precision mismatch"):
            _session(other).restore(ck, step=1)


def _save_on_ranks(rank, col, dev, directory):
    sess = serve.OnlineBandit.sharded(col, N, D, HYPER, policy="linucb",
                                      refresh_every=N, device=dev)
    for i in range(3):
        sess, _, _ = serve.step(sess, i, *_traffic(i), reward_fn)
    sess.save(CheckpointManager(directory), 3)
    return sess.global_state()


def test_sharded_session_is_not_checkpointed(tmp_path):
    """A sharded session is not checkpointed rank by rank: two gloo ranks
    leave one checkpoint, the files of a one-process save of the gathered
    state, which a one-process session restores."""
    from repro_torch.launch import mesh
    runs = mesh.spawn(_save_on_ranks, 2, "gloo", "cpu",
                      args=(tmp_path / "s",), timeout=60)
    ck = CheckpointManager(tmp_path / "s")
    assert ck.steps() == [3]
    whole = type(runs[0])(*(torch.from_numpy(np.asarray(v))
                            for v in runs[0]))
    one = CheckpointManager(tmp_path / "one")
    sess = _session(policy="linucb")
    sess = type(sess)(policy=sess.policy, state=whole)
    sess.save(one, 3)
    got, want = ck._step_dir(3), one._step_dir(3)
    assert ((got / "manifest.json").read_text()
            == (want / "manifest.json").read_text())
    with np.load(got / "arrays.npz") as a, np.load(want / "arrays.npz") as b:
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])
    restored, step = _session(policy="linucb").restore(ck)
    assert step == 3
    for x, y in zip(restored.state, whole):
        assert torch.equal(x, y)


def test_dccb_session_round_trips(tmp_path):
    """A state that nests a record (dccb's) round-trips as it is."""
    sess = _session(policy="dccb")
    sess, _, _ = serve.step(sess, 0, *_traffic(0), reward_fn)
    ck = CheckpointManager(tmp_path / "dccb")
    sess.save(ck, 1)
    back, _ = _session(policy="dccb").restore(ck)
    assert isinstance(back.state, policies.DCCBServeState)
    for a, b in zip(checkpoint._flatten(back.state).values(),
                    checkpoint._flatten(sess.state).values()):
        assert (torch.equal(a, b.to(a.dtype)) if isinstance(a, torch.Tensor)
                else a == b)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_serve_bandit_example_resumes(tmp_path, precision):
    """``examples/serve_bandit_torch.py --device cpu`` at a reduced step
    count: it crashes at step 12 after checkpoints at 5 and 10, restores,
    replays, and its bit-for-bit assert holds."""
    env_vars = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                    OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_bandit_torch.py"),
         "--device", "cpu", "--precision", precision, "--crash-at", "12",
         "--every", "5", "--after", "4", "--ckpt-dir", str(tmp_path / "ck")],
        env=env_vars, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "restarted from checkpoint @ step 10" in out.stdout
    assert "bit-for-bit: OK" in out.stdout
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step-0000000005", "step-0000000010"]
