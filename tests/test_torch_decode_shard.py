"""The port's sharded LM decode (``distributed.decode_shard``) on 8 gloo
CPU ranks, mesh (data 4 x model 2), against ``repro``'s
``build_decode_step`` on 8 XLA host devices, on the same parameters,
caches and tokens.

``repro``'s side runs once, in a subprocess (``_run_with_devices``, as
``tests/test_torch_sharded.py``), and hands back its parameters, the
caches its prefill built, its logits and the caches its step wrote.  The
port's ranks run in one group (``mesh.spawn``, a 60 s limit); they import
this module, so it imports neither JAX nor ``repro``.  Each case carries
``repro``'s parameters across by ``convert.lm_from_numpy``.

  standard     ``tests/test_distributed.py``'s config, f32, B 8: logits
               within 1e-4 of ``repro``'s, within its 2e-3 of the port's
               one-process ``lm_decode_step``; the written caches within
               1e-5, every other slot untouched;
  int8 KV      ``quantize`` bit-equal to ``repro``'s on the same values; the
               codes the step writes equal ``repro``'s (the slot's values
               kept off .5 boundaries, checked), its scales within 1e-6
               (K itself differs in its last bits), logits within 1e-4;
  tiny batch   B 1: the batch replicated, the sequence over all 8 ranks;
  MoE          E 8, top-2, 1 shared expert, dropless, standard layout;
               every routing's 2nd and 3rd probabilities at least 1e-5
               apart (checked on the port's one-process step), so no
               near tie decides a routing;
  f-sharded    the MoE config with ``param_count`` patched in both
               packages (in this file only): expert d_ff over "data",
               the batch replicated, the sequence over ("data", "model").
"""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_distributed import _run_with_devices  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.distributed import decode_shard, sharding  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

RANKS, MESH, AXES = 8, (4, 2), ("data", "model")
B, S, PAD = 8, 32, 32
DENSE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
             d_ff=128, vocab=256, qk_norm=True, attn_chunk=32)
MOE = dict(DENSE, n_experts=8, top_k=2, n_shared=1, d_ff_expert=32)
# case -> (config, batch, kv_quant, forced f-sharded layout)
CASES = {"standard": (DENSE, B, False, False),
         "int8": (DENSE, B, True, False),
         "tiny": (DENSE, 1, False, False),
         "moe": (MOE, B, False, False),
         "fshard": (MOE, B, False, True)}
SPAWN_S = 60
AXIS_SETS = (("data",), ("model",), ("data", "model"))
# the tokens' key: with it every K/V value the decode step writes lies at
# least 1e-3 from a rounding boundary of its int8 code (key 1's nearest is
# 1e-5 away, within reach of a last-bit difference of the two packages'
# K), so the codes can be held equal
TOKEN_KEY = 5

REFERENCE = """
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.models import transformer as tr
from repro.distributed import decode_shard

B, S, PAD = %(B)d, %(S)d, %(PAD)d
CASES = %(CASES)r
CFGS = {"dense": %(DENSE)r, "moe": %(MOE)r}
out = {}
mesh = jax.make_mesh(%(MESH)r, %(AXES)r)

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(p.key) for p in path)
        out[f"{prefix}.param.{name}"] = np.asarray(leaf)

@jax.jit
def quant(a):
    sc = jnp.maximum(jnp.max(jnp.abs(a), -1) / 127.0, 1e-8)
    return (jnp.clip(jnp.round(a / sc[..., None]), -127, 127
                     ).astype(jnp.int8), sc.astype(jnp.float32))

for kind in ("dense", "moe"):
    cfg = tr.LMConfig(**CFGS[kind], dtype=jnp.float32)
    params = tr.init_lm(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(%(TOKEN_KEY)d), (B, S + 1), 0,
                              cfg.vocab)
    _, cache = tr.lm_prefill(params, cfg, toks[:, :S])
    kc = jnp.pad(cache[0], ((0, 0),) * 4 + ((0, PAD), (0, 0)))
    vc = jnp.pad(cache[1], ((0, 0),) * 4 + ((0, PAD), (0, 0)))
    flat(params, kind)
    out[f"{kind}.tokens"] = np.asarray(toks)
    out[f"{kind}.k"] = np.asarray(kc)
    out[f"{kind}.v"] = np.asarray(vc)
    for case, (kw, batch, kv_quant, fshard) in CASES.items():
        if kw != CFGS[kind]:
            continue
        real = tr.LMConfig.param_count
        if fshard:
            tr.LMConfig.param_count = lambda self: 10 ** 13
        step, p_sh, c_sh = decode_shard.build_decode_step(
            mesh, cfg, batch, S + PAD, kv_quant=kv_quant)
        tr.LMConfig.param_count = real
        caches = (kc[:, :, :batch], vc[:, :, :batch])
        if kv_quant:
            kq, ks = quant(kc[:, :, :batch])
            vq, vs = quant(vc[:, :, :batch])
            caches = (kq, vq, ks, vs)
        for i, a in enumerate(caches):
            out[f"{case}.before{i}"] = np.asarray(a)
        caches = tuple(jax.device_put(a, s) for a, s in zip(caches, c_sh))
        got, new = step(jax.device_put(params, p_sh), toks[:batch, S],
                        caches, jnp.int32(S))
        out[f"{case}.logits"] = np.asarray(got)
        for i, a in enumerate(new):
            out[f"{case}.cache{i}"] = np.asarray(a)
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
for axes in %(AXIS_SETS)r:
    idx = shard_map(lambda: jax.lax.axis_index(axes)[None], mesh=mesh,
                    in_specs=(), out_specs=P(%(AXES)r), check_rep=False)()
    out["axis_index." + ".".join(axes)] = np.asarray(idx)
x = jax.random.normal(jax.random.PRNGKey(2), (4096, 16)) * 3.0
out["quant.x"] = np.asarray(x)
out["quant.codes"], out["quant.scales"] = map(np.asarray, quant(x))
np.savez(OUT_PATH, **out)
print("REFERENCE-OK")
""" % dict(B=B, S=S, PAD=PAD, CASES=CASES, DENSE=DENSE, MOE=MOE, MESH=MESH,
           AXES=AXES, TOKEN_KEY=TOKEN_KEY, AXIS_SETS=AXIS_SETS)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("decode_shard") / "reference.npz"
    out = _run_with_devices(REFERENCE.replace("OUT_PATH", repr(str(path))))
    assert "REFERENCE-OK" in out
    with np.load(path) as z:
        return dict(z)


def _kind(case):
    return "moe" if CASES[case][0] is MOE else "dense"


def _params(ref, kind) -> dict:
    """``repro``'s parameter tree from the reference's flat entries."""
    tree = {}
    prefix = f"{kind}.param."
    for name, a in ref.items():
        if name.startswith(prefix):
            *path, leaf = name[len(prefix):].split(".")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = a
    return tree


def _cfg(case):
    return tr.LMConfig(**CASES[case][0], dtype=torch.float32)


def _inputs(ref, case):
    """(full caches as ``repro``'s step took them, tokens at ``S``)."""
    n = 4 if CASES[case][2] else 2
    caches = tuple(torch.from_numpy(ref[f"{case}.before{i}"])
                   for i in range(n))
    return caches, torch.from_numpy(
        ref[f"{_kind(case)}.tokens"][:CASES[case][1], S])


def _step(case, m):
    """``build_decode_step`` for ``case`` on ``m``, the f-sharded layout
    forced where the case says so."""
    cfg = _cfg(case)
    _, batch, kv_quant, fshard = CASES[case]
    with mock.patch.object(tr.LMConfig, "param_count",
                           (lambda self: 10 ** 13) if fshard
                           else tr.LMConfig.param_count):
        return decode_shard.build_decode_step(m, cfg, batch, S + PAD,
                                              kv_quant=kv_quant,
                                              device="cpu")


def _rank(rank, col, dev, inputs):
    m = mesh.make_mesh(MESH, AXES)
    _build.reset_launches()
    out = {"mesh": {}}
    for axes in AXIS_SETS:
        c = m.col(axes)
        x = torch.tensor([[rank, -rank]], dtype=torch.int32)
        h = torch.tensor([1.0, 2 ** -9, 2 ** -9], dtype=torch.bfloat16) \
            * (1 + rank)
        out["mesh"][axes] = dict(
            index=m.axis_index(axes), col_index=c.axis_index(),
            stacked=c.all_gather(x[0], tiled=False),
            tiled1=c.all_gather(x, axis=1),
            summed=c.psum(h).float())   # numpy holds no bf16
    for case, (tree, caches, token) in inputs.items():
        ds = _step(case, m)
        model = convert.lm_from_numpy(tree, _cfg(case), device=dev)
        params = ds.shard_params(model.tree())
        local = ds.shard_caches(tuple(torch.from_numpy(c) for c in caches))
        logits, local = ds.step(params, ds.shard_token(
            torch.from_numpy(token)), local, S)
        out[case] = dict(logits=logits, caches=local,
                         layout=(ds.fshard, ds.seq_axes, tuple(ds.token_spec)))
    out["launches"] = dict(_build.LAUNCHES)
    return out


@pytest.fixture(scope="module")
def ranks(reference):
    inputs = {}
    for case in CASES:
        caches, token = _inputs(reference, case)
        inputs[case] = (_params(reference, _kind(case)),
                        tuple(c.numpy() for c in caches), token.numpy())
    return mesh.spawn(_rank, RANKS, "gloo", "cpu", args=(inputs,),
                      timeout=SPAWN_S)


def _gathered(ranks, case):
    """(full logits, full caches) put together from the 8 ranks."""
    spec_mesh = mesh.mesh_spec(MESH, AXES)
    ds = _step(case, spec_mesh)
    logits = sharding.assemble([r[case]["logits"] for r in ranks],
                               ds.logits_spec, spec_mesh)
    caches = tuple(sharding.assemble([r[case]["caches"][i] for r in ranks],
                                     s, spec_mesh)
                   for i, s in enumerate(ds.cache_specs))
    return logits, caches


def test_named_axes_match_jax_and_gather_in_their_order(ranks, reference):
    """Each rank's ``axis_index`` over an axis and over a tuple of axes
    is JAX's on the same mesh (row-major, the first axis major); each
    axis group gathers in that order, tiled on dim 1 or stacked; a bf16
    psum is the f32 sum rounded once."""
    for axes in AXIS_SETS:
        want = reference["axis_index." + ".".join(axes)]
        got = [r["mesh"][axes]["index"] for r in ranks]
        assert got == list(want), axes
        for r, out in enumerate(ranks):
            o = out["mesh"][axes]
            assert o["col_index"] == o["index"]
            members = [q for q in range(RANKS) if all(
                mesh.mesh_spec(MESH, AXES, q).coords[i]
                == mesh.mesh_spec(MESH, AXES, r).coords[i]
                for i, a in enumerate(AXES) if a not in axes)]
            order = sorted(members, key=lambda q: want[q])
            assert o["stacked"].tolist() == [[q, -q] for q in order]
            assert o["tiled1"].tolist() == [sum(([q, -q] for q in order),
                                                [])]
            f32 = sum(torch.tensor([1.0, 2 ** -9, 2 ** -9]).to(
                torch.bfloat16).float() * (1 + q) for q in members)
            assert torch.equal(torch.as_tensor(o["summed"]),
                               f32.to(torch.bfloat16).float())


def test_layouts_are_repros(ranks):
    want = {"standard": (False, ("model",), (("data",),)),
            "int8": (False, ("model",), (("data",),)),
            "tiny": (False, AXES, (None,)),
            "moe": (False, ("model",), (("data",),)),
            "fshard": (True, AXES, (None,))}
    for case, layout in want.items():
        assert ranks[0][case]["layout"] == layout, case
    assert not any(any(r["launches"].values()) for r in ranks)


@pytest.mark.parametrize("case", list(CASES))
def test_logits_and_caches_match_repro_on_8_ranks(case, ranks, reference):
    logits, caches = _gathered(ranks, case)
    want = reference[f"{case}.logits"]
    assert logits.shape == want.shape
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=1e-4)
    before, _ = _inputs(reference, case)
    for i, (got, ref_c) in enumerate(zip(caches, before)):
        new = reference[f"{case}.cache{i}"]
        # only slot S was written, by its owner; the rest is untouched
        keep = np.ones(new.shape[4], bool)
        keep[S] = False
        assert torch.equal(got[:, :, :, :, keep], ref_c[:, :, :, :, keep])
        if got.dtype == torch.int8:              # int8 codes
            assert np.array_equal(got.numpy(), new), (case, i)
        elif i >= 2:
            # the scales are max|K| / 127 of a K that differs from
            # repro's in its last bits (the packages' f32 sums), so they
            # agree to 1e-6 (~8 ulps), where ``quantize`` itself is exact
            np.testing.assert_allclose(got[:, :, :, :, S].numpy(),
                                       new[:, :, :, :, S], rtol=1e-6,
                                       atol=0)
        else:
            np.testing.assert_allclose(got[:, :, :, :, S].numpy(),
                                       new[:, :, :, :, S], rtol=0,
                                       atol=1e-5)


def test_quantize_is_repros_bit_for_bit(reference):
    """``quantize`` against ``repro``'s jitted quantization (the step's)
    on the same f32 values: codes and scales equal."""
    codes, scales = decode_shard.quantize(
        torch.from_numpy(reference["quant.x"]))
    assert np.array_equal(codes.numpy(), reference["quant.codes"])
    assert np.array_equal(scales.numpy(), reference["quant.scales"])


def test_int8_slot_is_off_rounding_boundaries(ranks, reference):
    """The written K/V over their scales lie at least 5e-4 from any .5
    (``TOKEN_KEY``), so the exact code check above does not hang on a
    last-bit difference of K."""
    _, caches = _gathered(ranks, "standard")
    for c in caches:
        a = c[:, :, :, :, S].double()
        sc = torch.clamp(a.abs().amax(-1) / 127.0, min=1e-8)
        frac = (a / sc[..., None]).abs() % 1.0
        assert float((frac - 0.5).abs().min()) > 5e-4


def test_standard_layout_matches_one_process_decode(ranks, reference):
    """Within ``repro``'s 2e-3 of the port's one-process
    ``lm_decode_step`` on the same cache."""
    logits, _ = _gathered(ranks, "standard")
    (kc, vc), token = _inputs(reference, "standard")
    model = convert.lm_from_numpy(_params(reference, "dense"),
                                  _cfg("standard"), device="cpu")
    ref, _ = tr.lm_decode_step(model, token, (kc.clone(), vc.clone()), S)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("case", ["moe", "tiny"])
def test_one_rank_mesh_matches_8_ranks(case, ranks, reference):
    """The same step on a one-rank mesh (every collective the identity)
    against the 8 ranks; for the MoE, every routing clear of near ties."""
    logits, _ = _gathered(ranks, case)
    one = mesh.make_mesh((1, 1), AXES)
    ds = _step(case, one)
    caches, token = _inputs(reference, case)
    model = convert.lm_from_numpy(_params(reference, _kind(case)),
                                  _cfg(case), device="cpu")
    gaps = []
    route = decode_shard._route

    def spy(z, router, k):
        probs = torch.softmax(z.float() @ router, dim=-1)
        top = torch.topk(probs, k + 1, dim=-1).values
        gaps.append(float((top[:, k - 1] - top[:, k]).min()))
        return route(z, router, k)

    with mock.patch.object(decode_shard, "_route", spy):
        got, _ = ds.step(ds.shard_params(model.tree()), token,
                         ds.shard_caches(caches), S)
    np.testing.assert_allclose(got.numpy(), logits.numpy(), rtol=0,
                               atol=1e-4)
    if case == "moe":
        assert len(gaps) == _cfg(case).n_layers
        assert min(gaps) > 1e-5, gaps

