"""The port's dataset layer (``repro_torch.data``) and quickstart
(``examples/quickstart_torch.py``) against ``repro`` on the CPU: the
paper's dataset specs and epoch counts, ``make_env``'s four kinds at the
specs' shapes, the replay log's click probabilities on the reference's
formula, and the quickstart's six lines on a tape of the reference
quickstart's draws."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import bench_paper  # noqa: E402
from repro.configs import distclub_paper as jpaper  # noqa: E402
from repro.core import backend as jbackend  # noqa: E402
from repro.core import distclub as jdistclub  # noqa: E402
from repro.core import env as jenv  # noqa: E402
from repro.core import env_ops as jenv_ops  # noqa: E402
from repro.core.types import BanditHyper as JHyper  # noqa: E402
from repro.data import datasets as jdatasets  # noqa: E402
from repro_torch.configs import distclub_paper  # noqa: E402
from repro_torch.core import env, env_ops  # noqa: E402
from repro_torch.core.types import BanditHyper  # noqa: E402
from repro_torch.data import datasets, replay  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
import quickstart_torch  # noqa: E402

KINDS = ("synthetic", "replay", "drift", "catalog")


def test_paper_datasets_match_reference():
    assert datasets.PAPER_DATASETS.keys() == jdatasets.PAPER_DATASETS.keys()
    for name, spec in datasets.PAPER_DATASETS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            jdatasets.PAPER_DATASETS[name])
    assert datasets._REPLAY_MAX_T == jdatasets._REPLAY_MAX_T
    assert datasets._CATALOG_ITEMS == jdatasets._CATALOG_ITEMS


@pytest.mark.parametrize("source", ["distclub_paper", "bench_paper"])
def test_epochs_for_matches_reference(source):
    for name, spec in datasets.PAPER_DATASETS.items():
        jspec = jdatasets.PAPER_DATASETS[name]
        jh = (jpaper.CONFIG if source == "distclub_paper"
              else bench_paper._hyper(jspec))
        h = (distclub_paper.CONFIG if source == "distclub_paper"
             else BanditHyper(*jh))
        assert h == BanditHyper(*jh)
        assert datasets.epochs_for(spec, h) == jdatasets.epochs_for(jspec, jh)


@pytest.mark.parametrize("name", ["synthetic-small", "movielens"])
@pytest.mark.parametrize("kind", KINDS)
def test_make_env_builds_each_kind_at_the_spec_shape(kind, name):
    spec = datasets.PAPER_DATASETS[name]
    ops, labels = datasets.make_env(spec, seed=1, kind=kind, device="cpu")
    n, d, K = spec.n_users, spec.d, spec.n_candidates
    assert (ops.n_users, ops.d, ops.n_candidates) == (n, d, K)
    assert labels.shape == (n,) and labels.dtype == torch.int32
    assert 0 <= int(labels.min()) and int(labels.max()) < spec.n_clusters
    occ = torch.zeros(n, dtype=torch.int32)
    ctx = ops.contexts_fn(1, 0, occ)
    assert ctx.shape == (n, K, d) and ctx.is_contiguous()
    torch.testing.assert_close(torch.linalg.norm(ctx, dim=-1),
                               torch.ones(n, K), rtol=0, atol=1e-5)
    choice = torch.zeros(n, dtype=torch.int32)
    realized, expected, best, rand = ops.rewards_fn(1, 0, occ, ctx, choice)
    assert realized.shape == expected.shape == (n,)
    assert bool((expected <= best).all() and (rand <= best).all())
    assert 0 < float(realized.mean()) < 1
    # the defaults: drift's period is a quarter of the per-user budget,
    # the catalog is static
    period = max(1, spec.n_interactions // n // 4)

    def expected_at(v):
        return ops.rewards_fn(1, 0, torch.full((n,), v, dtype=torch.int32),
                              ctx, choice)[1]

    if kind == "drift":
        assert torch.equal(expected_at(period - 1), expected_at(0))
        assert not torch.equal(expected_at(period), expected_at(0))
    if kind == "catalog":
        assert torch.equal(ops.contexts_fn(1, 0, occ + 10**4), ctx)


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown env kind"):
        datasets.make_env(datasets.PAPER_DATASETS["movielens"],
                          kind="logged", device="cpu")


def test_replay_log_follows_the_reference_formula(monkeypatch):
    """Ids in [1, n_items), and the click probabilities, computed a few
    users at a time, within 1e-6 of the reference's whole-table
    ``expected_reward`` on the same theta, items and ids."""
    monkeypatch.setattr(replay, "_CHUNK_SLOTS", 700)     # 3 users a chunk
    spec = datasets.PAPER_DATASETS["movielens"]
    log, _ = replay.make_replay_log(spec, n_items=64, max_t=9, seed=2,
                                    device="cpu")
    assert log.cand_ids.shape == (spec.n_users, 9, spec.n_candidates)
    assert log.cand_ids.dtype == torch.int32
    assert int(log.cand_ids.min()) == 1 and int(log.cand_ids.max()) == 63
    e, _ = env.make_synthetic_env(2, spec.n_users, spec.d, spec.n_clusters,
                                  spec.n_candidates, 0.05, device="cpu")
    want = jenv.expected_reward(
        jnp.asarray(e.theta.numpy())[:, None, None, :],
        jnp.asarray(log.item_feats.numpy())[log.cand_ids.long().numpy()])
    np.testing.assert_allclose(log.click_probs.numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


def _quickstart_tape(theta, n, K, d, R, n_epochs, key):
    """The reference quickstart's draws by ``distclub.run``'s key schedule
    (distclub.py:218, 229; stages.py:95, 112): unit contexts and the
    Bernoulli uniforms of every round."""

    @jax.jit
    def draws(k):
        k_ctx, k_rew = jax.random.split(k)
        keys = jenv_ops._user_keys(k_rew, n, 0)
        return (jenv_ops._unit_contexts(k_ctx, n, K, d, 0),
                jax.vmap(lambda kk: jax.random.uniform(kk, ()))(keys))

    ctx, uni = [], []
    for ke in jax.random.split(key, n_epochs):
        for ks in jax.random.split(ke):
            for k in jax.random.split(ks, R):
                c, u = draws(k)
                ctx.append(np.asarray(c))
                uni.append(np.asarray(u))
    return env_ops.tape_ops(torch.from_numpy(np.array(theta)),
                            torch.from_numpy(np.stack(ctx)),
                            torch.from_numpy(np.stack(uni)))


def test_quickstart_prints_the_reference_lines_on_its_draws(capsys):
    """``quickstart.py``'s world and run (examples/quickstart.py:14-26),
    its lines formatted as it formats them, against the port's
    quickstart on a tape of the same draws."""
    qs = quickstart_torch
    jhyper = JHyper(*qs.HYPER)
    assert jhyper == JHyper(alpha=0.03, beta=2.0, gamma=2.4, sigma=8,
                            max_rounds=16, n_candidates=20)
    e, _ = jenv.make_synthetic_env(jax.random.PRNGKey(0), n_users=128, d=16,
                                   n_clusters=8, n_candidates=20)
    cfg = jbackend.BackendConfig.create("reference")
    state, metrics, clusters = jdistclub.run(
        jenv_ops.synthetic_ops(e), jax.random.PRNGKey(1), jhyper, n_epochs=8,
        d=16, backend=cfg.interact(128, 16, 20), graph=cfg.graph(128))
    reward = float(metrics.reward.sum())
    rand = float(metrics.rand_reward.sum())
    want = [
        f"interactions processed : {int(metrics.interactions.sum())}",
        f"cumulative reward      : {reward:.0f}",
        f"random-policy reward   : {rand:.0f}",
        f"reward / random        : {reward / rand:.3f}",
        f"clusters discovered    : {clusters.tolist()}",
        f"comm bytes (stage-2)   : {float(state.comm_bytes):.0f}",
    ]
    tape = _quickstart_tape(e.theta, 128, 20, 16, 16, 8, jax.random.PRNGKey(1))
    capsys.readouterr()
    s, m, c = qs.main("cpu", ops=tape)
    assert capsys.readouterr().out.splitlines() == want
    np.testing.assert_array_equal(m.reward.numpy(), np.asarray(metrics.reward))
    np.testing.assert_array_equal(c.numpy(), np.asarray(clusters))
    assert reward > rand
