"""The port's dense LM serving path against the reference on the CPU: the
same numpy parameters (carried by ``repro_torch.convert``) and inputs go
through ``repro``'s layers, attention block and transformer and through
the port's.

Tolerances: the layers are elementwise or short f32 sums, 1e-6; the
attention block 1e-5; the whole LM at the reduced shapes of
tests/test_arch_smoke.py, whose own prefill-against-forward check
allows 2e-4, 2e-4; bf16 5e-2, the reference's bf16 attention
tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _numpy_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), params)


def _torch_tree(params):
    return jax.tree.map(_t, _numpy_tree(params))


# --- layers ----------------------------------------------------------------


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    scale = rng.normal(size=(48,)).astype(np.float32)
    want = np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    got = layers.rms_norm(_t(x), _t(scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # a bf16 input comes back f32 in both (the cast comes before the scale)
    jb = jlayers.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale))
    tb = layers.rms_norm(_t(x).to(torch.bfloat16), _t(scale))
    assert jb.dtype == jnp.float32 and tb.dtype == torch.float32
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("base", [10000.0, 1e6])
def test_apply_rope_matches_reference(base):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 40, 32)).astype(np.float32)
    pos = np.arange(40) + 17
    np.testing.assert_allclose(
        layers.rope_freqs(32, base).numpy(),
        np.asarray(jlayers.rope_freqs(32, base)), rtol=1e-6, atol=0)
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         base))
    got = layers.apply_rope(_t(x), torch.from_numpy(pos), base)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_swiglu_matches_reference():
    params = jlayers.init_swiglu(jax.random.PRNGKey(2), 24, 40)
    x = np.random.default_rng(2).normal(size=(4, 7, 24)).astype(np.float32)
    want = np.asarray(jlayers.swiglu(params, jnp.asarray(x)))
    got = layers.swiglu(_torch_tree(params), _t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# --- the attention block -------------------------------------------------------


def _attn_cfg(qk_norm):
    return dataclasses.replace(
        jtr.LMConfig(), d_model=64, n_heads=8, n_kv_heads=2, d_head=16,
        qk_norm=qk_norm, rope_base=10000.0)


@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
@pytest.mark.parametrize("cached", [False, True], ids=["no_cache", "cache"])
def test_attention_fwd_matches_reference(qk_norm, cached):
    """Without a cache: 12 tokens at positions 0..11.  With one: 5 tokens
    written at slot 9 of a 24-slot cache whose first 9 slots hold earlier
    keys; the port writes the cache in place and returns it."""
    cfg = _attn_cfg(qk_norm)
    params = jattention.init_attention(jax.random.PRNGKey(3), cfg,
                                       jnp.float32)
    rng = np.random.default_rng(3)
    B, S = 2, (5 if cached else 12)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    kw = dict(causal=True, attn_chunk=4)
    if cached:
        pos0 = 9
        kc = np.zeros((B, cfg.n_kv_heads, 24, cfg.d_head), np.float32)
        vc = np.zeros_like(kc)
        kc[:, :, :pos0] = rng.normal(size=kc[:, :, :pos0].shape)
        vc[:, :, :pos0] = rng.normal(size=vc[:, :, :pos0].shape)
        positions = np.arange(S) + pos0
        want, (wk, wv) = jattention.attention_fwd(
            params, cfg, jnp.asarray(x), positions=jnp.asarray(positions),
            cache=(jnp.asarray(kc), jnp.asarray(vc)), cache_pos=pos0, **kw)
        cache = (_t(kc), _t(vc))
        got, new = attention.attention_fwd(
            _torch_tree(params), cfg, _t(x),
            positions=torch.from_numpy(positions), cache=cache,
            cache_pos=pos0, **kw)
        assert new[0] is cache[0] and new[1] is cache[1]
        np.testing.assert_allclose(new[0].numpy(), np.asarray(wk),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(new[1].numpy(), np.asarray(wv),
                                   rtol=1e-5, atol=1e-5)
    else:
        positions = np.arange(S)
        want, _ = jattention.attention_fwd(
            params, cfg, jnp.asarray(x), positions=jnp.asarray(positions),
            **kw)
        got, new = attention.attention_fwd(
            _torch_tree(params), cfg, _t(x),
            positions=torch.from_numpy(positions), **kw)
        assert new is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_attention_fwd_write_past_the_end_matches_reference():
    """3 tokens written at slot Smax - 1 of a 16-slot cache: the write
    start clamps to Smax - 3, as ``repro``'s ``dynamic_update_slice``
    clamps it, and the block attends with ``q_offset = Smax - 1``."""
    cfg = _attn_cfg(True)
    params = jattention.init_attention(jax.random.PRNGKey(4), cfg,
                                       jnp.float32)
    rng = np.random.default_rng(4)
    B, S, Smax = 2, 3, 16
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    kc = rng.normal(size=(B, cfg.n_kv_heads, Smax, cfg.d_head)).astype(
        np.float32)
    vc = rng.normal(size=kc.shape).astype(np.float32)
    positions = np.arange(S) + Smax - 1
    kw = dict(causal=True, attn_chunk=4, cache_pos=Smax - 1)
    want, (wk, wv) = jattention.attention_fwd(
        params, cfg, jnp.asarray(x), positions=jnp.asarray(positions),
        cache=(jnp.asarray(kc), jnp.asarray(vc)), **kw)
    cache = (_t(kc), _t(vc))
    got, _ = attention.attention_fwd(
        _torch_tree(params), cfg, _t(x),
        positions=torch.from_numpy(positions), cache=cache, **kw)
    for a, b in zip(cache, (wk, wv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# --- the whole LM ----------------------------------------------------------------


def _reduced(arch, dtype="f32"):
    """tests/test_arch_smoke.py's ``_reduced_lm`` shapes (dense archs:
    2 layers, d_model 64, 4 heads of 16, d_ff 128, vocab 512, chunk 32),
    as the reference's config and as the port's."""
    over = dict(n_layers=2, d_model=64, n_heads=4, d_head=16, d_ff=128,
                vocab=512, attn_chunk=32, microbatches=1)
    jcfg = jconfigs.get(arch).cfg
    jcfg = dataclasses.replace(
        jcfg, n_kv_heads=min(4, jcfg.n_kv_heads),
        dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16, **over)
    cfg = dataclasses.replace(
        configs.get(arch).cfg, n_kv_heads=jcfg.n_kv_heads,
        dtype=torch.float32 if dtype == "f32" else torch.bfloat16, **over)
    return jcfg, cfg


def _pair(arch, dtype="f32", seed=0):
    jcfg, cfg = _reduced(arch, dtype)
    params = jtr.init_lm(jax.random.PRNGKey(seed), jcfg)
    model = convert.lm_from_numpy(_numpy_tree(params), cfg, device="cpu")
    return jcfg, params, cfg, model


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


LM_ARCHS = ["qwen3-4b", "llama3-8b"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_fwd_matches_reference(arch):
    jcfg, params, cfg, model = _pair(arch)
    tokens = _tokens((2, 64), cfg.vocab, 1)
    want, _ = jtr.lm_fwd(params, jcfg, jnp.asarray(tokens))
    _build.reset_launches()
    got, aux = tr.lm_fwd(model, torch.from_numpy(tokens))
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_matches_reference(arch):
    jcfg, params, cfg, model = _pair(arch)
    tokens = _tokens((2, 32), cfg.vocab, 2)
    want, (wk, wv) = jtr.lm_prefill(params, jcfg, jnp.asarray(tokens))
    got, (kc, vc) = tr.lm_prefill(model, torch.from_numpy(tokens))
    assert kc.shape == (cfg.n_blocks, cfg.block_layers, 2, cfg.n_kv_heads,
                        32, cfg.d_head)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    for a, b in ((kc, wk), (vc, wv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_decode_steps_match_reference(arch):
    """A 16-token prompt, its cache copied into 32 slots, then 4 decode
    steps teacher-forced on the next prompt tokens; logits and the cache
    after each step against the reference's."""
    jcfg, params, cfg, model = _pair(arch)
    S, extra = 16, 4
    tokens = _tokens((2, S + extra), cfg.vocab, 3)
    _, (k0, v0) = jtr.lm_prefill(params, jcfg, jnp.asarray(tokens[:, :S]))
    pad = ((0, 0),) * 4 + ((0, 16), (0, 0))
    jcache = (jnp.pad(k0, pad), jnp.pad(v0, pad))
    _, (tk, tv) = tr.lm_prefill(model, torch.from_numpy(tokens[:, :S]))
    cache = tr.init_cache(cfg, 2, 32, device="cpu")
    cache[0][..., :S, :] = tk
    cache[1][..., :S, :] = tv
    for pos in range(S, S + extra):
        want, jcache = jtr.lm_decode_step(
            params, jcfg, jnp.asarray(tokens[:, pos]), jcache, jnp.int32(pos))
        got, out = tr.lm_decode_step(model, torch.from_numpy(tokens[:, pos]),
                                     cache, pos)
        assert out[0] is cache[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)
        for a, b in zip(cache, jcache):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                       atol=2e-4)


@pytest.mark.parametrize("past", [0, 2], ids=["at_max_len", "max_len_plus_2"])
def test_lm_decode_step_past_the_cache_end_matches_reference(past):
    """An 8-token prompt fills an 8-slot cache; a decode step at pos =
    max_len + ``past`` overwrites the last slot, as ``repro``'s clamped
    ``dynamic_update_slice`` does, and attends to all 8 slots."""
    jcfg, params, cfg, model = _pair("qwen3-4b")
    S = 8
    tokens = _tokens((2, S + 1), cfg.vocab, 5)
    _, jcache = jtr.lm_prefill(params, jcfg, jnp.asarray(tokens[:, :S]))
    _, cache = tr.lm_prefill(model, torch.from_numpy(tokens[:, :S]))
    pos = S + past
    want, jcache = jtr.lm_decode_step(
        params, jcfg, jnp.asarray(tokens[:, S]), jcache, jnp.int32(pos))
    got, _ = tr.lm_decode_step(model, torch.from_numpy(tokens[:, S]), cache,
                               pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    for a, b in zip(cache, jcache):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4)


def test_lm_bf16_reduced_matches_reference():
    """bf16 weights (representable exactly on both sides) and activations:
    the forward's logits and one decode step's within 5e-2."""
    jcfg, params, cfg, model = _pair("qwen3-4b", "bf16")
    assert model.embed.dtype == torch.bfloat16
    tokens = _tokens((2, 24), cfg.vocab, 4)
    want, _ = jtr.lm_fwd(params, jcfg, jnp.asarray(tokens))
    got, _ = tr.lm_fwd(model, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)
    _, jcache = jtr.lm_prefill(params, jcfg, jnp.asarray(tokens[:, :23]))
    _, cache = tr.lm_prefill(model, torch.from_numpy(tokens[:, :23]))
    pad = ((0, 0),) * 4 + ((0, 1), (0, 0))
    want, _ = jtr.lm_decode_step(
        params, jcfg, jnp.asarray(tokens[:, 23]),
        tuple(jnp.pad(c, pad) for c in jcache), jnp.int32(23))
    full = tr.init_cache(cfg, 2, 24, device="cpu")
    for dst, src in zip(full, cache):
        dst[..., :23, :] = src
    got, _ = tr.lm_decode_step(model, torch.from_numpy(tokens[:, 23]), full,
                               23)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)


def test_lm_params_carry_reference_paths():
    _, params, cfg, model = _pair("qwen3-4b")
    names = dict(model.named_parameters())
    assert names["blocks.l0.attn.wq"].shape == (
        2, cfg.d_model, cfg.n_heads * cfg.d_head)
    assert "blocks.l0.attn.q_norm.scale" in names
    assert names["lm_head"].shape == (cfg.d_model, cfg.vocab)
    # param_count leaves out the norms' scales, as the reference's does
    norms = cfg.d_model * (2 * cfg.n_layers + 1) \
        + 2 * cfg.d_head * cfg.n_layers
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + norms
    views = model.layer_params()
    assert views[1][0]["attn"]["wq"].data_ptr() == \
        names["blocks.l0.attn.wq"][1].data_ptr()


def test_serve_lm_decodes_the_reference_tokens_on_the_cpu(capsys):
    """The CLI at its defaults (64 prompts, 50 steps) against
    ``repro``'s decode loop fed the same weights and prompt."""
    args = serve_cli.parse_args(["--arch", "qwen3-4b"])
    spec = configs.get(args.arch)
    _build.reset_launches()
    got = serve_cli.serve_lm(spec, args, device="cpu")
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    assert got.shape == (args.batch, args.steps)
    assert "tok/s (reduced config)" in capsys.readouterr().out

    cfg = serve_cli.reduced_lm(spec)
    model, prompt = serve_cli.lm_world(cfg, args.batch)
    tree = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(p.detach().numpy())
    jcfg = dataclasses.replace(jconfigs.get(args.arch).cfg,
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


def test_moe_configs_are_refused():
    """Named for the slices before ``models/moe.py``, when MoE configs
    raised; since it, nothing refuses them: a one-block MoE LM (a dense
    layer, then a MoE layer) builds and runs forward with an aux loss,
    and the serving CLI's reduced deepseek-moe-16b decodes on the CPU
    (the MoE archs against ``repro``: tests/test_torch_lm_moe.py)."""
    cfg = tr.LMConfig(name="moe", n_layers=2, d_model=32, n_heads=2,
                      n_kv_heads=2, d_head=16, d_ff=64, vocab=64,
                      n_experts=4, d_ff_expert=32, moe_every=2,
                      dtype=torch.float32)
    model = tr.LM(cfg, device="cpu")
    names = dict(model.named_parameters())
    assert names["blocks.l1.moe.experts.gate"].shape == (1, 4, 32, 32)
    assert "blocks.l0.ffn.gate" in names and "blocks.l1.ffn.gate" not in names
    assert set(tr.init_lm(torch.Generator(), cfg)["blocks"]["l1"]) == {
        "ln1", "attn", "ln2", "moe"}
    logits, aux = tr.lm_fwd(model, torch.zeros(2, 8, dtype=torch.long))
    assert logits.shape == (2, 8, 64) and float(aux) > 0
    args = serve_cli.parse_args(["--arch", "deepseek-moe-16b", "--steps",
                                 "4", "--batch", "2"])
    toks = serve_cli.serve_lm(configs.get(args.arch), args, device="cpu")
    assert toks.shape == (2, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_cli.main(["--arch", "deepseek-moe-16b"])


def test_lm_configs_are_the_reference_configs():
    for arch in ("qwen3-4b", "llama3-8b", "yi-34b"):
        spec, jspec = configs.get(arch), jconfigs.get(arch)
        assert spec.family == jspec.family == "lm"
        assert spec.source == jspec.source
        for f in dataclasses.fields(spec.cfg):
            if f.name != "dtype":
                assert getattr(spec.cfg, f.name) == getattr(jspec.cfg,
                                                            f.name), f.name
        assert spec.cfg.dtype == torch.bfloat16
        assert spec.cfg.param_count() == jspec.cfg.param_count()
        for shape in jspec.shapes:
            want = jspec.input_specs(shape)
            got = spec.input_specs(shape)
            assert spec.shapes[shape].kind == jspec.shapes[shape].kind
            assert {k: v[0] for k, v in got.items()} == {
                k: tuple(v.shape) for k, v in want.items()}
