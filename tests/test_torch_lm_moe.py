"""The port's MoE LMs (deepseek-moe-16b, llama4-maverick) against
``repro``'s on the CPU, at tests/test_arch_smoke.py's reduced widths
(d_model 64, 4 heads of 16, 8 experts of d_ff 64, top-2 or top-1, vocab
512, chunk 32; deepseek 2 layers, llama4 2 blocks of a dense and a MoE
layer), f32: the same numpy parameters (carried by
``repro_torch.convert``) and tokens through ``lm_fwd``, ``lm_prefill``,
decode steps, ``lm_loss`` and its gradients, three AdamW steps, and the
serving CLI's decode loop; the configs field for field.

Near-ties: the tests spy on the routers (``torch.topk``, nothing else
on the LM path calls it) and assert that each routed token's top-(k+1)
probabilities are at least 1e-5 apart, so no near-tie decides a routing
(tests/test_torch_moe.py); the token draws are ones that clear it (at
draw 3 one of llama4's 64 prefill tokens has a gap of 2.8e-6).  The
serving CLI's world is its own, fixed: there the gaps are recorded, and
its 3200 decoded tokens must equal ``repro``'s all the same.

Tolerances: logits, aux losses and caches within 2e-4 (the dense LM's,
tests/test_torch_lm.py); losses within 1e-5 relative; gradients rtol
1e-4 and atol 1e-5 x the leaf's largest |g| (tests/test_torch_train.py);
parameters after three steps within 1e-4."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.train import optimizer as joptim  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

MOE_ARCHS = ["deepseek-moe-16b", "llama4-maverick-400b-a17b"]


def _reduced(arch):
    """tests/test_arch_smoke.py's ``_reduced_lm``, as ``repro``'s config
    and the port's."""
    jc = jconfigs.get(arch).cfg
    over = dict(n_layers=2 * jc.block_layers, d_model=64, n_heads=4,
                n_kv_heads=min(4, jc.n_kv_heads), d_head=16, d_ff=128,
                vocab=512, n_experts=min(8, jc.n_experts), d_ff_expert=64,
                top_k=min(2, jc.top_k), attn_chunk=32, microbatches=1)
    return (dataclasses.replace(jc, dtype=jnp.float32, **over),
            dataclasses.replace(configs.get(arch).cfg, dtype=torch.float32,
                                **over))


def _numpy_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), params)


def _pair(arch, seed=0):
    jcfg, cfg = _reduced(arch)
    params = jtr.init_lm(jax.random.PRNGKey(seed), jcfg)
    model = convert.lm_from_numpy(_numpy_tree(params), cfg, device="cpu")
    return jcfg, params, cfg, model


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@contextlib.contextmanager
def _no_near_ties(check=True):
    """Every router call's top-(k+1) probabilities at least 1e-5 apart
    (with ``check``; else the smallest gaps are only recorded)."""
    real = torch.topk
    calls = []

    def spy(probs, k, *a, **kw):
        top = real(probs.detach(), min(k + 1, probs.shape[-1]), dim=-1).values
        gap = float((top[:, :-1] - top[:, 1:]).min())
        assert gap > 1e-5 or not check, f"a router near-tie: gap {gap}"
        calls.append(gap)
        return real(probs, k, *a, **kw)

    torch.topk = spy
    try:
        yield calls
    finally:
        torch.topk = real
    assert calls, "no router ran"


def _close(got, want, tol=2e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_fwd_matches_reference(arch):
    jcfg, params, cfg, model = _pair(arch)
    tokens = _tokens((2, 64), cfg.vocab, 1)
    want, waux = jtr.lm_fwd(params, jcfg, jnp.asarray(tokens))
    _build.reset_launches()
    with _no_near_ties():
        got, aux = tr.lm_fwd(model, torch.from_numpy(tokens))
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    assert float(aux) > 0 and aux.dtype == torch.float32
    _close(got.numpy(), want)
    _close(float(aux), float(waux))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_prefill_and_decode_match_reference(arch):
    """A 16-token prompt, its cache copied into 32 slots, then 4 decode
    steps teacher-forced on the next tokens: logits and the cache after
    each step against ``repro``'s."""
    jcfg, params, cfg, model = _pair(arch)
    S, extra = 16, 4
    tokens = _tokens((2, S + extra), cfg.vocab, 5)
    want, (k0, v0) = jtr.lm_prefill(params, jcfg, jnp.asarray(tokens[:, :S]))
    with _no_near_ties():
        got, (tk, tv) = tr.lm_prefill(model, torch.from_numpy(tokens[:, :S]))
    _close(got.numpy(), want)
    for a, b in ((tk, k0), (tv, v0)):
        _close(a.numpy(), b)
    pad = ((0, 0),) * 4 + ((0, 16), (0, 0))
    jcache = (jnp.pad(k0, pad), jnp.pad(v0, pad))
    cache = tr.init_cache(cfg, 2, 32, device="cpu")
    cache[0][..., :S, :] = tk
    cache[1][..., :S, :] = tv
    for pos in range(S, S + extra):
        want, jcache = jtr.lm_decode_step(
            params, jcfg, jnp.asarray(tokens[:, pos]), jcache, jnp.int32(pos))
        with _no_near_ties():
            got, _ = tr.lm_decode_step(model, torch.from_numpy(
                tokens[:, pos]), cache, pos)
        _close(got.numpy(), want)
        for a, b in zip(cache, jcache):
            _close(a.numpy(), b)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_loss_and_grads_match_reference(arch):
    jcfg, params, cfg, model = _pair(arch)
    model.requires_grad_(True)
    tokens = _tokens((2, 33), cfg.vocab, 4)
    inp, lab = tokens[:, :-1], tokens[:, 1:]
    want, jgrads = jax.value_and_grad(jtr.lm_loss)(
        params, jcfg, jnp.asarray(inp), jnp.asarray(lab))
    with _no_near_ties():
        got, grads = train.value_and_grad(tr.lm_loss, model.tree(), model,
                                          torch.from_numpy(inp),
                                          torch.from_numpy(lab))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    got, want = tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape and np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_steps_match_reference(arch):
    """Three AdamW steps (lr 3e-4) of ``train.lm_step`` on a token tape
    against ``repro``'s ``value_and_grad(lm_loss)`` then
    ``adamw_update``: losses and every parameter after each step."""
    jcfg, params, cfg, model = _pair(arch)
    model.requires_grad_(True)
    tree = model.tree()
    opt = optimizer.adamw_init(tree)
    jopt = joptim.adamw_init(params)
    step = jax.jit(lambda p, o, t: _jstep(p, o, t, jcfg))
    for i in range(3):
        tokens = _tokens((2, 17), cfg.vocab, 10 + i)
        params, jopt, jloss = step(params, jopt, jnp.asarray(tokens))
        with _no_near_ties():
            tree, opt, loss = train.lm_step(model, tree, opt,
                                            torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for g, w in zip(tree_leaves(tree), jax.tree.leaves(params)):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-4)


def _jstep(params, opt, tokens, jcfg):
    loss, grads = jax.value_and_grad(jtr.lm_loss)(
        params, jcfg, tokens[:, :-1], tokens[:, 1:])
    params, opt = joptim.adamw_update(grads, opt, params, lr=3e-4)
    return params, opt, loss


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_lm_decodes_the_reference_tokens_on_the_cpu(arch, capsys):
    """The CLI at its defaults (64 prompts, 50 steps, its reduced config:
    8 experts of d_ff 128) against ``repro``'s decode loop fed the same
    weights and prompt."""
    args = serve_cli.parse_args(["--arch", arch])
    spec = configs.get(arch)
    _build.reset_launches()
    with _no_near_ties(check=False):
        got = serve_cli.serve_lm(spec, args, device="cpu")
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    assert got.shape == (args.batch, args.steps)
    assert "tok/s (reduced config)" in capsys.readouterr().out

    cfg = serve_cli.reduced_lm(spec)
    assert cfg.is_moe and cfg.n_experts == 8
    model, prompt = serve_cli.lm_world(cfg, args.batch)
    tree = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(p.detach().numpy())
    jcfg = dataclasses.replace(jconfigs.get(arch).cfg,
                               **{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)
                                  if f.name != "dtype"},
                               dtype=jnp.float32)
    P = serve_cli.LM_PROMPT
    _, (kc, vc) = jtr.lm_prefill(tree, jcfg, jnp.asarray(prompt.numpy()))
    pad = ((0, 0),) * 4 + ((0, serve_cli.LM_CACHE - P), (0, 0))
    cache = (jnp.pad(kc, pad), jnp.pad(vc, pad))
    decode = jax.jit(lambda p, t, c, pos: jtr.lm_decode_step(p, jcfg, t, c,
                                                             pos))
    tok = jnp.asarray(prompt.numpy()[:, -1])
    want = []
    for pos in range(P, P + args.steps):
        logits, cache = decode(tree, tok, cache, jnp.int32(pos))
        tok = jnp.argmax(logits, -1)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


def test_moe_configs_are_the_reference_configs():
    for arch in MOE_ARCHS:
        spec, jspec = configs.get(arch), jconfigs.get(arch)
        assert spec.family == jspec.family == "lm"
        assert spec.source == jspec.source
        for f in dataclasses.fields(spec.cfg):
            if f.name != "dtype":
                assert getattr(spec.cfg, f.name) == getattr(jspec.cfg,
                                                            f.name), f.name
        assert spec.cfg.dtype == torch.bfloat16 and spec.cfg.is_moe
        assert spec.cfg.param_count() == jspec.cfg.param_count()
        assert spec.cfg.active_param_count() == \
            jspec.cfg.active_param_count()
        for shape in jspec.shapes:
            want = jspec.input_specs(shape)
            got = spec.input_specs(shape)
            assert spec.shapes[shape].kind == jspec.shapes[shape].kind
            assert {k: v[0] for k, v in got.items()} == {
                k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_carry_reference_paths(arch):
    """The port's tree has ``repro``'s paths and shapes, the router f32,
    and a MoE model counts ``param_count`` parameters plus the norms'
    scales."""
    jcfg, params, cfg, model = _pair(arch)
    want = {jax.tree_util.keystr(k): tuple(np.shape(v)) for k, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    got = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
           jax.tree_util.tree_flatten_with_path(model.tree())[0]}
    assert got == want
    moe_layer = f"l{cfg.block_layers - 1}"
    names = dict(model.named_parameters())
    assert names[f"blocks.{moe_layer}.moe.router"].dtype == torch.float32
    assert names[f"blocks.{moe_layer}.moe.experts.gate"].shape == (
        cfg.n_blocks, cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
    norms = cfg.d_model * (2 * cfg.n_layers + 1)
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + norms
