"""The port's LM training path against ``repro``'s on the CPU:
``lm_loss`` and its gradients, the flash and cross kernels' autograd
Functions, and AdamW steps of the LM on ``repro``'s token tape.  The
same numpy parameters (carried by ``repro_torch.convert``) and inputs go
through both packages.  The recsys losses are in
``test_torch_train_recsys.py``, checkpoints, resume and the CLI in
``test_torch_train_cli.py``.

Tolerances: losses within 1e-5 relative; gradients within rtol 1e-4
and atol 1e-5 x the leaf's largest |g| (f32 sums in other orders, over
two layers and a softmax); the kernels' backward within rtol 1e-5, atol
1e-6 (a few f32 products).  Steps of whole models: losses within 1e-5
relative, parameters as each test states."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.kernels.cross import ref as jcross  # noqa: E402
from repro.train import optimizer as joptim  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cross import ops as cross_ops  # noqa: E402
from repro_torch.kernels.flash import ops as flash_ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _numpy_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), params)


def _loss_close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _grads_close(got, want, rtol=1e-4, atol_scale=1e-5):
    """Leaf by leaf (both trees' keys sorted, as a pytree flattens)."""
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=atol_scale * np.abs(w).max())


# --- the LM: lm_loss and its gradients ----------------------------------------


def _reduced_lm(arch, bf16=False, **over):
    """tests/test_arch_smoke.py's reduced dense LM (2 layers, d_model 64,
    4 heads of 16, d_ff 128, vocab 512, chunk 32), f32 unless ``bf16``,
    as ``repro``'s config and the port's."""
    over = dict(n_layers=2, d_model=64, n_heads=4, d_head=16, d_ff=128,
                vocab=512, attn_chunk=32, microbatches=1, **over)
    jcfg = jconfigs.get(arch).cfg
    jcfg = dataclasses.replace(
        jcfg, n_kv_heads=min(4, jcfg.n_kv_heads),
        dtype=jnp.bfloat16 if bf16 else jnp.float32, **over)
    cfg = dataclasses.replace(
        configs.get(arch).cfg, n_kv_heads=jcfg.n_kv_heads,
        dtype=torch.bfloat16 if bf16 else torch.float32, **over)
    return jcfg, cfg


def _lm_pair(arch, seed=0, **over):
    jcfg, cfg = _reduced_lm(arch, **over)
    params = jtr.init_lm(jax.random.PRNGKey(seed), jcfg)
    model = convert.lm_from_numpy(_numpy_tree(params), cfg, device="cpu")
    return jcfg, params, model.requires_grad_(True)


@pytest.mark.parametrize("arch,remat", [("qwen3-4b", True),
                                        ("qwen3-4b", False),
                                        ("llama3-8b", True)])
def test_lm_loss_and_grads_match_reference(arch, remat):
    jcfg, params, model = _lm_pair(arch, remat=remat)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 33))
    inp, lab = tokens[:, :-1], tokens[:, 1:]
    want, jgrads = jax.value_and_grad(jtr.lm_loss)(
        params, jcfg, jnp.asarray(inp), jnp.asarray(lab))
    _build.reset_launches()
    got, grads = train.value_and_grad(tr.lm_loss, model.tree(), model,
                                      torch.from_numpy(inp),
                                      torch.from_numpy(lab))
    assert not any(_build.LAUNCHES.values())
    _loss_close(got, want)
    _grads_close(grads, jgrads)


def test_every_leaf_gets_a_gradient_after_a_frozen_pass():
    """A frozen model's ``layer_params()`` (kept views) and a forward,
    then ``requires_grad_(True)``: backward reaches every stacked leaf,
    block by block."""
    _, _, model = _lm_pair("qwen3-4b")
    model.requires_grad_(False)
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, 512, (2, 17)))
    kept = model.layer_params()
    tr.lm_fwd(model, tokens[:, :-1])
    assert model.layer_params() is kept
    model.requires_grad_(True)
    tr.lm_loss(model, tokens[:, :-1], tokens[:, 1:]).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        g = p.grad.reshape(p.shape[0], -1) if name.startswith("blocks") \
            else p.grad.reshape(1, -1)
        assert bool(torch.isfinite(g).all()), name
        assert bool((g != 0).any(dim=1).all()), name
    with torch.no_grad():
        assert model.layer_params() is kept


# --- the kernels' autograd Functions -------------------------------------------


@pytest.mark.parametrize("case", [
    dict(causal=True, Hq=4, Hkv=4, Sq=16, Skv=16),
    dict(causal=False, Hq=4, Hkv=4, Sq=16, Skv=16),
    dict(causal=True, Hq=8, Hkv=2, Sq=16, Skv=16),
    dict(causal=True, Hq=8, Hkv=2, Sq=4, Skv=16, q_offset=5, kv_len=9),
    dict(causal=True, Hq=4, Hkv=1, Sq=6, Skv=8, q_offset=-2),
], ids=["causal", "full", "gqa4", "offset_kv_len", "rows_without_keys"])
def test_flash_backward_matches_reference(case):
    """The flash Function's gradients against ``jax.grad`` of ``repro``'s
    ``chunked_attention``, through a fixed cotangent; in the last case
    the first two query rows see no key and come out 0."""
    case = dict(case)
    Hq, Hkv, Sq, Skv = (case.pop(k) for k in ("Hq", "Hkv", "Sq", "Skv"))
    kw = dict(case, chunk=4)
    rng = np.random.default_rng(3)
    q, w = (rng.normal(size=(2, Hq, Sq, 16)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(size=(2, Hkv, Skv, 16)).astype(np.float32)
            for _ in range(2))

    def jloss(q, k, v):
        return jnp.sum(jattention.chunked_attention(q, k, v, **kw) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = flash_ops.attention(tq, tk, tv, **kw)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
    got = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-5,
                                   atol=1e-6)
    if kw.get("q_offset", 0) < 0:
        assert not out[:, :, :2].any() and not got[0][:, :, :2].any()
    # without gradients the call is the plain dispatch: nothing saved
    assert flash_ops.attention(tq.detach(), tk.detach(), tv.detach(),
                               **kw).grad_fn is None


def test_cross_backward_matches_reference():
    rng = np.random.default_rng(4)
    B, d = 37, 29
    x0, xl, w = (rng.normal(size=(B, d)).astype(np.float32)
                 for _ in range(3))
    W = (0.2 * rng.normal(size=(d, d))).astype(np.float32)
    b = rng.normal(size=(d,)).astype(np.float32)

    def jloss(*args):
        return jnp.sum(jcross.cross_layer_ref(*args) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x0, xl, W, b)))
    args = [_t(a).requires_grad_() for a in (x0, xl, W, b)]
    out = cross_ops.cross_layer(*args)
    assert type(out.grad_fn).__name__ == "_CrossBackward"
    got = torch.autograd.grad((out * _t(w)).sum(), args)
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-5,
                                   atol=1e-6)
    # one tensor as both x0 and xl (the first layer): the two add
    x = _t(x0).requires_grad_()
    gx = torch.autograd.grad(
        (cross_ops.cross_layer(x, x, *args[2:]) * _t(w)).sum(), x)[0]
    wx = jax.grad(lambda x: jloss(x, x, W, b))(jnp.asarray(x0))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-5,
                               atol=1e-6)


# --- whole training steps -----------------------------------------------------------


def test_adamw_steps_of_the_lm_match_reference():
    """Five AdamW steps (lr 3e-4, ``launch.train``'s) of the reduced
    qwen3-4b on ``repro``'s token tape: losses within 1e-5 relative;
    parameters within 1e-6 + 1e-6 relative, except where a gradient's
    sign is within its rounding (Adam's first steps move each weight by
    about lr x sign(g)): at most 2 lr apart, on a few elements."""
    jcfg, params, model = _lm_pair("qwen3-4b")
    key = jax.random.PRNGKey(0)
    data_logits = -1.5 * jnp.log(jnp.arange(1, jcfg.vocab + 1,
                                            dtype=jnp.float32))

    @jax.jit
    def jstep(params, opt, tokens):
        loss, grads = jax.value_and_grad(jtr.lm_loss)(
            params, jcfg, tokens[:, :-1], tokens[:, 1:])
        params, opt = joptim.adamw_update(grads, opt, params, lr=3e-4)
        return params, opt, loss

    jopt = joptim.adamw_init(params)
    tree = model.tree()
    opt = optimizer.adamw_init(tree)
    for i in range(5):
        tokens = jax.random.categorical(jax.random.fold_in(key, i),
                                        data_logits, shape=(2, 17))
        params, jopt, want = jstep(params, jopt, tokens)
        tree, opt, got = train.lm_step(model, tree, opt,
                                       torch.tensor(np.asarray(tokens)))
        _loss_close(got, want)
    for g, w in zip(tree_leaves(tree), jax.tree.leaves(params)):
        d = np.abs(g.detach().numpy() - np.asarray(w))
        off = d > 1e-6 + 1e-6 * np.abs(np.asarray(w))
        assert d.max() <= 2 * 3e-4 and off.mean() <= 1e-3, (d.max(),
                                                            off.sum())
