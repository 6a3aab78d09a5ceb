"""The port's MoE FFN (``repro_torch.models.moe``) against ``repro``'s on
the CPU: the same numpy weights and inputs through both ``moe_fwd``s, at
tests/test_substrate.py's ``_moe_cfg`` (4 experts of d_ff 32, d_model
32), with no drops (capacity factor 4), with drops (0.05) and top-1 with
a shared expert; the gradients of ``sum(out^2) + 0.01 aux`` against
``jax.grad``; the host capacity reckoning against the buffer ``repro``
traces.

Near-ties: ``torch.topk`` on the CPU and ``jax.lax.top_k`` may break a
tie of two probabilities differently, and a 1-ulp difference in the
router's logits may reorder two that nearly tie.  Each test asserts
that its input's top-(k+1) router probabilities (computed in f64) are
at least 1e-5 apart, so no near-tie decides a routing.

Top-1 gates are p / p: their gradient is 0 in exact arithmetic, and each
package's backward of the division leaves its own round-off, ~1e-7 of
the loss's gradient a gate, in the router's gradient; at unit-scale
inputs that is the size of the aux term's gradient, which is all the
router's gradient is.  The top-1 setting draws its inputs at scale 0.1,
where the aux term's gradient is ~10^3 times that round-off.

Tolerances: out and aux within 1e-5 (abs and rel); gradients within
1e-4 x each leaf's largest |g|."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

KEY = jax.random.PRNGKey(0)
SETTINGS = {"high_capacity": {},
            "drops": {"capacity_factor": 0.05},
            "top1_shared": {"top_k": 1, "n_shared": 1}}
SCALE = {"top1_shared": 0.1}      # the inputs' scale (module docstring)


def _cfgs(**kw):
    """tests/test_substrate.py's ``_moe_cfg``, as ``repro``'s config and
    the port's."""
    base = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
                d_ff=64, vocab=128, n_experts=4, top_k=2, n_shared=0,
                d_ff_expert=32, capacity_factor=4.0)
    base.update(kw)
    return (jtr.LMConfig(**base, dtype=jnp.float32),
            tr.LMConfig(**base, dtype=torch.float32))


def _tensors(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                        tree)


def _assert_no_near_ties(params, x, k):
    """The top-(k+1) router probabilities of every token of ``x`` at least
    1e-5 apart (f64)."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ np.asarray(
        params["router"], np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = -np.sort(-probs, axis=-1)[:, :k + 1]
    assert np.diff(-top, axis=-1).min() > 1e-5


def _setup(setting, shape=(2, 8, 32), seed=2):
    jcfg, cfg = _cfgs(**SETTINGS[setting])
    params = jmoe.init_moe(KEY, jcfg, jnp.float32)
    x = (SCALE.get(setting, 1.0) * np.random.default_rng(seed).normal(
        size=shape)).astype(np.float32)
    _assert_no_near_ties(params, x, jcfg.top_k)
    return jcfg, cfg, params, x


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_moe_fwd_matches_reference(setting):
    jcfg, cfg, params, x = _setup(setting)
    want, waux = jmoe.moe_fwd(params, jcfg, jnp.asarray(x))
    _build.reset_launches()
    got, aux = moe.moe_fwd(_tensors(params), cfg, torch.from_numpy(x))
    assert not any(_build.LAUNCHES.values())
    assert got.shape == x.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5,
                               atol=1e-5)
    if setting == "drops":
        # capacity 1 a expert: most (token, choice) pairs dropped
        assert moe.capacity(16, 2, 4, 0.05) == 1
        rows = got.reshape(-1, 32)
        assert int((rows == 0).all(dim=-1).sum()) >= 16 - 4


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_moe_grads_match_reference(setting):
    jcfg, cfg, params, x = _setup(setting, seed=4)

    def jloss(p):
        out, aux = jmoe.moe_fwd(p, jcfg, jnp.asarray(x))
        return jnp.sum(out ** 2) + 0.01 * aux

    want = jax.grad(jloss)(params)
    tp = _tensors(params)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    out, aux = moe.moe_fwd(tp, cfg, torch.from_numpy(x))
    got = torch.autograd.grad(torch.sum(out ** 2) + 0.01 * aux, leaves)
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def _traced_capacity(T, k, E, cf):
    """The C of the [E, C, d] expert buffer ``repro``'s ``moe_fwd`` traces
    for T tokens (read off its jaxpr, at d = 3)."""
    jcfg = jtr.LMConfig(d_model=3, n_experts=E, top_k=k, d_ff_expert=2,
                        capacity_factor=cf, dtype=jnp.float32)
    params = jax.eval_shape(lambda: jmoe.init_moe(KEY, jcfg, jnp.float32))
    x = jax.ShapeDtypeStruct((1, T, 3), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda p, x: jmoe.moe_fwd(p, jcfg, x))(params, x)
    shapes = {tuple(v.aval.shape) for eqn in jaxpr.eqns for v in eqn.outvars
              if len(v.aval.shape) == 3}
    caps = {s[1] for s in shapes if s[0] == E and s[2] == 3}
    assert len(caps) == 1, shapes
    return caps.pop()


@pytest.mark.parametrize("T", [8, 16384])
@pytest.mark.parametrize("k,E", [(1, 64), (6, 64), (1, 128), (6, 128)])
def test_capacity_is_the_reference_reckoning(T, k, E):
    """Decode at batch 8 (T = 8) and a prefill of 8 x 2048 tokens, at the
    configs' capacity factor 1.25 and at 0.05."""
    for cf in (1.25, 0.05):
        assert moe.capacity(T, k, E, cf) == _traced_capacity(T, k, E, cf)
    # decode at batch 8 keeps one slot an expert for both MoE configs
    assert moe.capacity(8, 6, 64, 1.25) == moe.capacity(8, 1, 128, 1.25) == 1


def test_init_moe_shapes_and_dtypes():
    _, cfg = _cfgs(n_shared=2)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, cfg.dtype)
    jp = jax.eval_shape(lambda: jmoe.init_moe(KEY, _cfgs(n_shared=2)[0],
                                              jnp.bfloat16))
    assert p["router"].dtype == torch.float32
    assert p["experts"]["gate"].dtype == torch.bfloat16
    got = jax.tree.map(lambda t: tuple(t.shape), p)
    want = jax.tree.map(lambda s: tuple(s.shape), jp)
    assert got == want
    # each expert drawn on its own: no two experts share a draw
    gate = p["experts"]["gate"].float()
    assert not torch.equal(gate[0], gate[1])
    assert abs(float(gate.std()) - (2 / (32 + 32)) ** 0.5) < 0.02
