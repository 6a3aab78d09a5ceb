"""The port's DCCB baseline (``repro_torch.core.dccb``) against
``repro.core.dccb`` on the CPU: the lagged scores, the masked buffered
push and one gossip round from the same numpy state, and a whole run on a
tape of the reference's draws.

Tie window: for its first L rounds (and after every reset) DCCB scores
with ``w = 0`` and ``Minv = I``, so unit-norm contexts tie to the last
ulp and two packages may pick differently.  The run feeds both packages
contexts scaled per candidate slot, ``(1 + k / (2 K)) ctx``, through a
reference ``EnvOps`` that wraps ``synthetic_ops``, and runs the
reference's choose as its Pallas kernel in interpret mode (whose ties go
to the first index, as the port's), never its jnp oracle."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import backend as jbackend  # noqa: E402
from repro.core import dccb as jdccb  # noqa: E402
from repro.core import env as jenv  # noqa: E402
from repro.core import env_ops as jenv_ops  # noqa: E402
from repro.core.types import BanditHyper as JHyper  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dccb, env_ops  # noqa: E402
from repro_torch.core.types import BanditHyper  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

EXACT = ("occ", "adj", "slot")


def _assert_dccb_close(port, ref):
    """Integers and the graph exact; f32 state within 1e-5."""
    got = convert.dccb_state_to_numpy(port)
    for f in got._fields:
        want = np.asarray(getattr(ref, f))
        if f in EXACT:
            np.testing.assert_array_equal(getattr(got, f), want, err_msg=f)
        else:
            np.testing.assert_allclose(getattr(got, f), want, rtol=0,
                                       atol=1e-5, err_msg=f)


def _random_state(n, d, L, seed, slot=1):
    """A reference-shaped DCCB state with numpy leaves: SPD lagged Grams,
    PSD buffer entries, and an adjacency with an isolated row and a block
    of identical rows (the only rows that can average)."""
    rng = np.random.default_rng(seed)
    A = 0.3 * rng.normal(size=(n, d, d))
    Mw = np.eye(d) + A @ A.transpose(0, 2, 1)
    X = 0.3 * rng.normal(size=(n, L, d))
    Mbuf = X[..., :, None] * X[..., None, :]
    adj = rng.random((n, n)) < 0.6
    adj[:6] = False
    adj[:6, :6] = True                   # rows 0-5 identical
    adj[7] = False                       # isolated: gossips with itself
    f32 = np.float32
    return jdccb.DCCBState(
        Mw=Mw.astype(f32), bw=rng.normal(size=(n, d)).astype(f32),
        Mbuf=Mbuf.astype(f32), bbuf=(0.3 * X).astype(f32),
        occ=rng.integers(0, 40, n).astype(np.int32), adj=adj,
        slot=np.int32(slot), comm_bytes=np.float32(123.0))


def _to_jax(s):
    return jax.tree.map(jnp.asarray, s)


def test_lagged_score_matches_reference():
    s = _random_state(17, 6, 3, seed=0)
    jw, jMinv = jdccb.lagged_score(jnp.asarray(s.Mw), jnp.asarray(s.bw))
    w, Minv = dccb.lagged_score(torch.from_numpy(s.Mw),
                                torch.from_numpy(s.bw))
    np.testing.assert_allclose(Minv.numpy(), np.asarray(jMinv), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-5)


@pytest.mark.parametrize("slot", [0, 2])
def test_masked_buffered_push_matches_reference(slot):
    n, d, L = 17, 6, 3
    s = _random_state(n, d, L, seed=1, slot=slot)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, d)).astype(np.float32)
    r = (rng.random(n) < 0.5).astype(np.float32)
    mask = rng.random(n) < 0.6
    want = jdccb.buffered_push(_to_jax(s), jnp.asarray(x), jnp.asarray(r),
                               jnp.asarray(mask), L)
    port = convert.dccb_state_from_numpy(s, device="cpu")
    got = dccb.buffered_push(port, torch.from_numpy(x), torch.from_numpy(r),
                             torch.from_numpy(mask), L)
    assert got.slot == (slot + 1) % L
    assert got.Mbuf is port.Mbuf                # in place
    _assert_dccb_close(got, want)
    # masked-off users are untouched, bit for bit
    off = ~mask
    np.testing.assert_array_equal(got.Mbuf.numpy()[off], s.Mbuf[off])
    np.testing.assert_array_equal(got.Mw.numpy()[off], s.Mw[off])


def _reference_peers(key, adj):
    """``gossip_round``'s draw: ``jax.random.categorical`` over the
    neighbours (dccb.py:157-162); the port applies the no-neighbour
    fallback itself."""
    logits = jnp.where(jnp.asarray(adj), 0.0, -jnp.inf)
    return np.asarray(jax.random.categorical(key, logits, axis=-1))


@pytest.mark.parametrize("gamma,branch", [(0.15, "reset"),
                                          (5.0, "average")])
def test_gossip_round_with_reference_peers(gamma, branch):
    n, d, L = 23, 5, 3
    s = _random_state(n, d, L, seed=3)
    hyper = dict(gamma=gamma, buffer_size=L)
    key = jax.random.PRNGKey(4)
    want = jdccb.gossip_round(_to_jax(s), key, JHyper(**hyper), L, d)
    peer = torch.from_numpy(_reference_peers(key, s.adj).copy())
    got = dccb.gossip_round(convert.dccb_state_from_numpy(s, device="cpu"),
                            peer, BanditHyper(**hyper), L, d)
    _assert_dccb_close(got, want)
    # the branch the draw exercised: edges cut and users reset, or (no
    # cut at a wide threshold) identical rows averaged
    eye = np.eye(d, dtype=np.float32)
    reset = np.all(got.Mw.numpy() == eye, axis=(1, 2))
    moved = np.any(got.Mw.numpy() != s.Mw, axis=(1, 2))
    cut = np.any(got.adj.numpy() != s.adj)
    if branch == "reset":
        assert reset.any() and cut
    else:
        assert (moved & ~reset).any() and not cut


def _scaled_ops(base, K):
    """The reference's synthetic env with contexts scaled per slot."""
    scale = 1.0 + jnp.arange(K, dtype=jnp.float32) / (2 * K)

    def contexts_fn(key, occ, row0=0):
        return base.contexts_fn(key, occ, row0) * scale[None, :, None]

    return base._replace(contexts_fn=contexts_fn)


def _tape(jops, n, L, n_epochs, key):
    """Replay ``dccb._run``'s key schedule: the epoch split
    (dccb.py:223), ``k_int, k_gos`` (dccb.py:215), the round split and
    ``k_ctx, k_rew`` (stages.py:112, 95).  Returns the contexts and
    uniforms of every round and the gossip keys."""

    @jax.jit
    def draws(k):
        k_ctx, k_rew = jax.random.split(k)
        ctx = jops.contexts_fn(k_ctx, jnp.zeros((n,), jnp.int32))
        keys = jenv_ops._user_keys(k_rew, n, 0)
        return ctx, jax.vmap(lambda kk: jax.random.uniform(kk, ()))(keys)

    ctx, uni, k_gos = [], [], []
    for ke in jax.random.split(key, n_epochs):
        k_int, kg = jax.random.split(ke)
        k_gos.append(kg)
        for k in jax.random.split(k_int, L):
            c, u = draws(k)
            ctx.append(np.asarray(c))
            uni.append(np.asarray(u))
    return np.stack(ctx), np.stack(uni), k_gos


@pytest.mark.parametrize("n,d,K,L,gamma", [(37, 5, 10, 4, 0.5),
                                           (24, 8, 6, 3, 0.9)])
def test_run_matches_reference_on_tape(n, d, K, L, gamma):
    n_epochs = 3
    jhyper = JHyper(alpha=0.3, gamma=gamma, n_candidates=K, buffer_size=L)
    e, _ = jenv.make_synthetic_env(jax.random.PRNGKey(0), n, d, 3, K,
                                   within_cluster_noise=0.05)
    jops = _scaled_ops(jenv_ops.synthetic_ops(e), K)
    key = jax.random.PRNGKey(5)
    be = jbackend.BackendConfig.create("pallas").interact(n, d, K,
                                                          interpret=True)
    js, jm, jc = jdccb.run(jops, key, jhyper, n_epochs, d, L, backend=be)

    ctx, uni, k_gos = _tape(jops, n, L, n_epochs, key)
    tape = env_ops.tape_ops(torch.from_numpy(np.array(e.theta)),
                            torch.from_numpy(ctx), torch.from_numpy(uni))
    # the reference's peers, drawn on the port's graph at each gossip
    tape = tape._replace(peers_fn=lambda seed, step, adj: torch.from_numpy(
        _reference_peers(k_gos[step], adj.numpy()).copy()))
    _build.reset_launches()
    s, m, c = dccb.run(tape, 0, BanditHyper(*jhyper), n_epochs, d, L,
                       device="cpu")
    assert not any(_build.LAUNCHES.values())
    assert m.reward.shape == (n_epochs * L,)
    np.testing.assert_array_equal(m.reward.numpy(), np.asarray(jm.reward))
    np.testing.assert_array_equal(m.interactions.numpy(),
                                  np.asarray(jm.interactions))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert float(s.comm_bytes) == float(js.comm_bytes) > 0
    _assert_dccb_close(s, js)
    assert not np.asarray(js.adj).all(where=~np.eye(n, dtype=bool))
