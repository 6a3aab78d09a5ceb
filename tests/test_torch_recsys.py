"""The port's recsys serving path against the reference on the CPU: the
same numpy parameters (carried by ``repro_torch.convert``) and inputs go
through ``repro``'s model functions and the port's.

Tolerances: every product here is an f32 sum of at most a few hundred
terms taken in another order by each BLAS, so scores and logits of O(1)
agree to ~1e-5 absolute; where a quantity grows (DCN's cross stack
multiplies by x0 three times) the bound is relative to its scale."""
import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattention  # noqa: E402
from repro.models.recsys import dcn_v2 as jdcn  # noqa: E402
from repro.models.recsys import mind as jmind  # noqa: E402
from repro.models.recsys import seqrec as jseqrec  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models.recsys import dcn_v2, mind, seqrec  # noqa: E402


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def _close(got, want, scale_tol=1e-5):
    """|got - want| <= tol (1 + |want|): ~1e-5 absolute on O(1) values,
    relative where they are larger."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want),
                                 scale_tol * (1 + np.abs(want)))


# --- DCN-v2 ---------------------------------------------------------------

# the small config of the reference's own smoke test
# (tests/test_arch_smoke.py::test_dcn_smoke): d_interact = 13 + 26 * 8
SMALL_DCN = dict(vocab_per_field=256, embed_dim=8, mlp_dims=(64, 32))


@pytest.mark.parametrize("use_pallas", [None, True],
                         ids=["jnp", "pallas_interpret"])
def test_dcn_fwd_matches_reference(use_pallas):
    jcfg = jdcn.DCNConfig(**SMALL_DCN)
    cfg = dcn_v2.DCNConfig(**SMALL_DCN)
    assert cfg.d_interact == jcfg.d_interact == 221
    params = _numpy_tree(jdcn.init_dcn(jax.random.PRNGKey(3), jcfg))
    model = convert.dcn_from_numpy(params, cfg, device="cpu")
    rng = np.random.default_rng(5)
    B = 24
    dense = rng.normal(size=(B, 13)).astype(np.float32)
    sparse = rng.integers(0, 256, (B, 26)).astype(np.int32)
    want = np.asarray(jdcn.dcn_fwd(params, jcfg, jnp.asarray(dense),
                                   jnp.asarray(sparse),
                                   use_pallas=use_pallas))
    _build.reset_launches()
    got = dcn_v2.dcn_fwd(model, torch.from_numpy(dense),
                         torch.from_numpy(sparse))
    assert _build.LAUNCHES["cross"] == 0
    assert got.shape == (B,)
    _close(got.numpy(), want)

    labels = (rng.random(B) < 0.3).astype(np.float32)
    want_loss = float(jdcn.dcn_loss(params, jcfg, jnp.asarray(dense),
                                    jnp.asarray(sparse), jnp.asarray(labels)))
    got_loss = float(dcn_v2.dcn_loss(model, torch.from_numpy(dense),
                                     torch.from_numpy(sparse),
                                     torch.from_numpy(labels)))
    assert abs(got_loss - want_loss) <= 1e-5 * (1 + abs(want_loss))


def test_dcn_feature_order_is_dense_then_field_major():
    cfg = dcn_v2.DCNConfig(n_dense=2, n_sparse=3, vocab_per_field=4,
                           embed_dim=2, n_cross_layers=1, mlp_dims=(4,))
    model = dcn_v2.DCNv2(cfg, device="cpu")
    with torch.no_grad():
        model.tables.copy_(torch.arange(3 * 4 * 2, dtype=torch.float32)
                           .reshape(3, 4, 2))
    x0 = dcn_v2.interaction_input(model, torch.tensor([[0.5, -0.5]]),
                                  torch.tensor([[1, 0, 3]], dtype=torch.int32))
    # field f, id i -> row f*8 + 2i: [2, 3], [8, 9], [22, 23]
    np.testing.assert_array_equal(
        x0.numpy(), [[0.5, -0.5, 2, 3, 8, 9, 22, 23]])


def test_dcn_init_matches_reference_tree_and_scales():
    jcfg = jdcn.DCNConfig(**SMALL_DCN)
    cfg = dcn_v2.DCNConfig(**SMALL_DCN)
    jparams = _numpy_tree(jdcn.init_dcn(jax.random.PRNGKey(0), jcfg))
    model = dcn_v2.DCNv2(cfg, seed=0, device="cpu")
    own = {k: tuple(v.shape) for k, v in model.named_parameters()}
    flat = {k: v.shape for k, v in convert._flatten(jparams)}
    assert own == flat
    d = cfg.d_interact
    # same distributions, not the same bits
    assert abs(float(model.tables.std()) - 8 ** -0.5) < 0.01
    assert abs(float(model.cross[0].W.std()) - (1 / d) ** 0.5) < 0.005
    assert float(model.cross[0].b.abs().max()) == 0.0
    assert not any(p.requires_grad for p in model.parameters())


def test_convert_refuses_a_mismatched_tree():
    jcfg = jdcn.DCNConfig(**SMALL_DCN)
    params = _numpy_tree(jdcn.init_dcn(jax.random.PRNGKey(0), jcfg))
    other = dcn_v2.DCNConfig(**dict(SMALL_DCN, embed_dim=4))
    with pytest.raises(ValueError, match="shape"):
        convert.dcn_from_numpy(params, other, device="cpu")
    del params["final"]
    with pytest.raises(ValueError, match="paths differ"):
        convert.dcn_from_numpy(params, dcn_v2.DCNConfig(**SMALL_DCN),
                               device="cpu")


# --- layers and attention --------------------------------------------------


def test_layer_norm_uses_the_reference_eps():
    from repro.models import layers as jlayers
    rng = np.random.default_rng(0)
    x = (1e-3 * rng.normal(size=(4, 16))).astype(np.float32)   # var ~ eps
    s = rng.normal(size=16).astype(np.float32)
    b = rng.normal(size=16).astype(np.float32)
    want = np.asarray(jlayers.layer_norm(*(jnp.asarray(a) for a in (x, s, b))))
    got = layers.layer_norm(*(torch.from_numpy(a) for a in (x, s, b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,Dh,causal,off,kv_len,chunk", [
    (1, 2, 2, 16, 16, 8, True, 0, None, 1024),    # MHA causal, one chunk
    (2, 4, 2, 24, 24, 8, True, 0, None, 8),       # GQA causal, 3 chunks
    (1, 4, 1, 16, 32, 16, False, 0, None, 8),     # MQA bidirectional
    (2, 2, 2, 8, 32, 8, True, 24, None, 16),      # decode tail: q_offset
    (1, 2, 1, 4, 32, 8, True, 20, 22, 8),         # cache valid to 22
    (1, 2, 2, 6, 16, 8, False, 0, 5, 4),          # bidir, padded keys
])
def test_chunked_attention_matches_reference(B, Hq, Hkv, Sq, Skv, Dh,
                                             causal, off, kv_len, chunk):
    rng = np.random.default_rng(Sq + Skv + Hq)
    q = rng.normal(size=(B, Hq, Sq, Dh)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Skv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Skv, Dh)).astype(np.float32)
    kw = dict(causal=causal, q_offset=off, kv_len=kv_len, chunk=chunk)
    want = np.asarray(jattention.chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v)), **kw))
    got = attention.chunked_attention(*(torch.from_numpy(a) for a in
                                        (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_chunked_attention_fully_masked_rows_are_zero():
    q = torch.randn(1, 1, 4, 8)
    k = torch.randn(1, 1, 8, 8)
    out = attention.chunked_attention(q, k, k, causal=True, q_offset=-2,
                                      chunk=4)
    # rows at positions -2, -1 see no key: the guard leaves them at 0
    assert torch.equal(out[0, 0, :2], torch.zeros(2, 8))
    assert bool(torch.isfinite(out).all())


# --- SASRec / BERT4Rec ------------------------------------------------------


def _seqrec_pair(causal):
    kw = dict(n_items=512, embed_dim=32, n_blocks=2, n_heads=2, seq_len=16,
              causal=causal)
    jcfg, cfg = jseqrec.SeqRecConfig(**kw), seqrec.SeqRecConfig(**kw)
    params = _numpy_tree(jseqrec.init_seqrec(jax.random.PRNGKey(1), jcfg))
    return jcfg, cfg, params, convert.seqrec_from_numpy(params, cfg,
                                                        device="cpu")


@pytest.mark.parametrize("causal", [True, False], ids=["sasrec", "bert4rec"])
def test_seqrec_scoring_matches_reference(causal):
    jcfg, cfg, params, model = _seqrec_pair(causal)
    rng = np.random.default_rng(11)
    hist = rng.integers(1, 512, (6, 16)).astype(np.int32)
    cand = rng.integers(0, 512, (6, 40)).astype(np.int32)
    slab = rng.integers(0, 512, (300,)).astype(np.int32)
    jh, jc, js = (jnp.asarray(a) for a in (hist, cand, slab))
    th, tc, ts = (torch.from_numpy(a) for a in (hist, cand, slab))
    _close(seqrec.user_states(model, th).numpy(),
           jseqrec.user_states(params, jcfg, jh))
    _close(seqrec.score_candidates(model, th, tc).numpy(),
           jseqrec.score_candidates(params, jcfg, jh, jc))
    got = seqrec.retrieval_scores(model, th[:1], ts)
    assert got.shape == (300,) and got.dtype == torch.float32
    _close(got.numpy(), jseqrec.retrieval_scores(params, jcfg, jh[:1], js))


def test_sasrec_is_causal():
    _, _, _, model = _seqrec_pair(True)
    ids = torch.randint(1, 512, (2, 16), generator=torch.Generator()
                        .manual_seed(0))
    h = seqrec.user_states(model, ids)
    ids2 = ids.clone()
    ids2[:, -1] = (ids[:, -1] + 1) % 512
    h2 = seqrec.user_states(model, ids2)
    torch.testing.assert_close(h[:, :-1], h2[:, :-1], rtol=0, atol=1e-5)
    assert float((h[:, -1] - h2[:, -1]).abs().max()) > 0


# --- MIND -----------------------------------------------------------------


def test_mind_scoring_matches_reference():
    kw = dict(n_items=512, embed_dim=32, n_interests=4, seq_len=16)
    jcfg, cfg = jmind.MINDConfig(**kw), mind.MINDConfig(**kw)
    params = _numpy_tree(jmind.init_mind(jax.random.PRNGKey(2), jcfg))
    model = convert.mind_from_numpy(params, cfg, device="cpu")
    rng = np.random.default_rng(13)
    hist = rng.integers(1, 512, (5, 16)).astype(np.int32)
    hist[:, 12:] = 0                                  # pads at the tail
    cand = rng.integers(0, 512, (5, 30)).astype(np.int32)
    slab = rng.integers(0, 512, (200,)).astype(np.int32)
    jh, jc, js = (jnp.asarray(a) for a in (hist, cand, slab))
    th, tc, ts = (torch.from_numpy(a) for a in (hist, cand, slab))
    caps = mind.interest_capsules(model, th)
    _close(caps.numpy(), jmind.interest_capsules(params, jcfg, jh))
    assert float(torch.linalg.norm(caps, dim=-1).max()) < 1.0
    _close(mind.mind_serve(model, th, tc).numpy(),
           jmind.mind_serve(params, jcfg, jh, jc))
    _close(mind.mind_retrieval(model, th[:1], ts).numpy(),
           jmind.mind_retrieval(params, jcfg, jh[:1], js))
    ce = model.item_embed[tc.long()]
    _close(mind.label_aware_scores(caps, ce, cfg.pow_p).numpy(),
           jmind.label_aware_scores(jnp.asarray(caps.numpy()),
                                    jnp.asarray(ce.numpy()), jcfg.pow_p))


# --- configs and the serving CLI -------------------------------------------


def test_registry_holds_the_four_recsys_archs_at_published_widths():
    recsys = sorted(a for a, spec in configs.REGISTRY.items()
                    if spec.family == "recsys")
    assert recsys == ["bert4rec", "dcn-v2", "mind", "sasrec"]
    assert len([c for c in configs.all_cells() if c[0] in recsys]) == 16
    # the rest of the registry is the LMs (tests/test_torch_lm.py,
    # test_torch_lm_moe.py), the GAT (tests/test_torch_gnn.py) and the
    # paper's own bandit cell (tests/test_torch_gspmd_cells.py)
    assert sorted(set(configs.REGISTRY) - set(recsys)) == [
        "deepseek-moe-16b", "distclub-paper", "gat-cora", "llama3-8b",
        "llama4-maverick-400b-a17b", "qwen3-4b", "yi-34b"]
    dcn = configs.get("dcn-v2")
    assert dcn.cfg.d_interact == 429 and dcn.cfg.n_cross_layers == 3
    assert dcn.cfg.mlp_dims == (1024, 1024, 512)
    specs = dcn.input_specs("serve_p99")
    assert specs["dense_feats"] == ((512, 13), torch.float32)
    assert specs["sparse_ids"] == ((512, 26), torch.int32)
    assert configs.get("bert4rec").cfg.causal is False
    assert configs.get("bert4rec").input_specs("serve_p99")["hist"][0] == (
        512, 200)
    retr = configs.get("mind").input_specs("retrieval_cand")
    assert retr["cand"] == ((1 << 20,), torch.int32)
    for arch, shape in configs.all_cells():
        assert configs.get(arch).input_specs(shape)


def test_serve_recsys_learns_on_the_cpu(capsys):
    """At the CLI's defaults: the run the card repeats in chip_smoke.py
    (the world is drawn on the host, so both serve the same requests)."""
    args = serve_cli.parse_args([])
    ratio = serve_cli.serve_recsys(configs.get(args.arch), args,
                                   device="cpu")
    assert ratio > 1.0
    assert "reward/random" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    (["--arch", "qwen3-8b"], "not ported"),
])
def test_serve_cli_refuses_what_is_not_ported(argv, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        serve_cli.main(argv)


def test_serve_recsys_serves_every_request_with_the_dccb_policy_on_the_cpu(
        capsys):
    """17 batches of 64: past the 1024-interaction refresh, so one gossip
    round runs.  Every request is served and the printed ratio is the one
    returned.  No lift over random is asserted: DCCB's lagged, gossip-
    averaged statistics do not beat random at this size (neither does the
    JAX package's dccb serving policy in tests/test_serve.py)."""
    args = serve_cli.parse_args(["--policy", "dccb", "--steps", "17"])
    ratio = serve_cli.serve_recsys(configs.get(args.arch), args,
                                   device="cpu")
    out = capsys.readouterr().out
    assert np.isfinite(ratio) and ratio > 0
    assert out.startswith(f"[dccb] {17 * 64} requests in ")
    assert out.rstrip().endswith(f"reward/random = {ratio:.3f}")


def test_serve_cli_parses_like_the_reference():
    args = serve_cli.parse_args([])
    assert (args.arch, args.steps, args.batch, args.users, args.policy) == (
        "sasrec", 50, 64, 256, "distclub")
    assert isinstance(args, argparse.Namespace)
