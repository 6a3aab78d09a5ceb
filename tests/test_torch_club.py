"""The port's CLUB baseline (``repro_torch.core.club``) against
``repro.core.club`` on the CPU: the same draws (a tape replaying the
reference's JAX key schedule: user, contexts, Bernoulli uniforms) through
both packages, from the same start or from a state handed across with
``repro_torch.convert``."""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import backend as jbackend  # noqa: E402
from repro.core import club as jclub  # noqa: E402
from repro.core import env as jenv  # noqa: E402
from repro.core import env_ops as jenv_ops  # noqa: E402
from repro.core.types import BanditHyper as JHyper  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import club, env_ops  # noqa: E402
from repro_torch.core.types import BanditHyper  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

T = 300
DELTA = 50                      # 6 network updates in T
HYPER = dict(alpha=0.3, gamma=0.4, delta_net=DELTA)


def _tape(n, K, d, T, key):
    """Replay ``club._run``'s key schedule: the run's split into T keys
    (club.py:120), then ``k_user, k_ctx, k_rew`` per step (club.py:74-75):
    the user, every user's contexts (``_unit_contexts``) and every user's
    Bernoulli uniform (``_bernoulli_metrics``)."""

    @jax.jit
    def draws(k):
        k_user, k_ctx, k_rew = jax.random.split(k, 3)
        user = jax.random.randint(k_user, (), 0, n)
        ctx = jenv_ops._unit_contexts(k_ctx, n, K, d, 0)
        keys = jenv_ops._user_keys(k_rew, n, 0)
        u = jax.vmap(lambda kk: jax.random.uniform(kk, ()))(keys)
        return user, ctx, u

    out = [draws(k) for k in jax.random.split(key, T)]
    return [np.stack([np.asarray(o[i]) for o in out]) for i in range(3)]


def _setup(n, d, K, keys):
    """The reference env and graph engine, and the port's tape of the
    draws of ``keys`` (one run's key each, T steps per key, in order)."""
    jhyper = JHyper(n_candidates=K, **HYPER)
    e, _ = jenv.make_synthetic_env(jax.random.PRNGKey(0), n, d, 3, K,
                                   within_cluster_noise=0.05)
    parts = [_tape(n, K, d, t, k) for k, t in keys]
    users, ctx, uni = (np.concatenate(p) for p in zip(*parts))
    tape = env_ops.tape_ops(torch.from_numpy(np.array(e.theta)),
                            torch.from_numpy(ctx), torch.from_numpy(uni),
                            users=users.tolist())
    graph = jbackend.BackendConfig.create("reference").graph(n)
    return jhyper, jenv_ops.synthetic_ops(e), tape, graph


def _assert_states_match(port, ref):
    p = convert.club_state_to_numpy(port)
    np.testing.assert_array_equal(p.graph.labels, np.asarray(ref.graph.labels))
    np.testing.assert_array_equal(p.graph.adj, np.asarray(ref.graph.adj))
    np.testing.assert_array_equal(p.lin.occ, np.asarray(ref.lin.occ))
    np.testing.assert_array_equal(p.clusters.size,
                                  np.asarray(ref.clusters.size))
    # Sherman-Morrison state and the sums it is kept beside: the
    # reference's own kernel-vs-oracle tolerance
    for got, want in ((p.lin.M, ref.lin.M), (p.lin.Minv, ref.lin.Minv),
                      (p.lin.b, ref.lin.b), (p.clusters.Mc, ref.clusters.Mc),
                      (p.clusters.Mcinv, ref.clusters.Mcinv),
                      (p.clusters.bc, ref.clusters.bc)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def _assert_metrics_match(m, jm):
    # same choices => same Bernoulli draws: rewards are exact integers;
    # a different choice would move the step's regret by far more than
    # the rounding of an expected reward
    np.testing.assert_array_equal(m.reward.numpy(), np.asarray(jm.reward))
    for got, want in ((m.regret, jm.regret), (m.rand_reward, jm.rand_reward)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    np.testing.assert_array_equal(m.interactions.numpy(),
                                  np.ones(m.reward.shape[0], np.int32))


@pytest.mark.parametrize("n,d,K", [(37, 5, 10), (64, 8, 20)])
def test_run_matches_reference_on_tape(n, d, K):
    key = jax.random.PRNGKey(1)
    jhyper, jops, tape, graph = _setup(n, d, K, [(key, T)])
    js, jm = jclub.run(jops, key, jhyper, T, d, graph=graph)
    _build.reset_launches()
    s, m = club.run(tape, 0, BanditHyper(*jhyper), T, d, device="cpu")
    assert not any(_build.LAUNCHES.values())
    assert m.reward.shape == (T,)
    _assert_metrics_match(m, jm)
    _assert_states_match(s, js)
    n_clu = int(np.sum(np.asarray(js.graph.labels) == np.arange(n)))
    assert 1 < n_clu < n                    # the network updates did prune
    assert float(m.reward.sum()) > float(m.rand_reward.sum())


def test_state_carried_across_matches_reference():
    """T1 interactions in the reference, the state handed to the port,
    T2 more in both (the reference continues from that state by starting
    its scan there); the port's uninterrupted run over the same tape ends
    in the same state."""
    n, d, K = 37, 5, 10
    T1, T2 = 2 * DELTA, 130
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    jhyper, jops, tape, graph = _setup(n, d, K, [(k1, T1), (k2, T2)])
    hyper = BanditHyper(*jhyper)
    j1, _ = jclub.run(jops, k1, jhyper, T1, d, graph=graph)
    with mock.patch.object(jclub, "init_state", lambda n_, d_: j1):
        j2, jm2 = jclub._run(jops, k2, jhyper, T2, d, graph)

    handed = convert.club_state_from_numpy(jax.tree.map(np.asarray, j1),
                                           device="cpu")
    _assert_states_match(handed, j1)
    s2, m2 = club.run(tape, 0, hyper, T2, d, device="cpu", state=handed,
                      t0=T1)
    _assert_metrics_match(m2, jm2)
    _assert_states_match(s2, j2)
    _assert_states_match(handed, j1)          # the given state is untouched

    s, m = club.run(tape, 0, hyper, T1 + T2, d, device="cpu")
    _assert_states_match(s, j2)
    np.testing.assert_array_equal(m.reward[T1:].numpy(), m2.reward.numpy())
