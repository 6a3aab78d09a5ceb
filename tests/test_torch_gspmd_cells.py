"""The global-program cells of ``launch.steps`` (DTensor arguments, each
rank's body on its local shards) against ``repro``'s GSPMD cells.

``repro``'s side runs once a file, in a subprocess with 4 XLA host
devices (``test_distributed._run_with_devices``): its ``build_lm_cell``
here (the head layouts in ``tests/test_torch_gspmd_layouts.py``), its
``build_recsys_cell`` in ``tests/test_torch_gspmd_recsys.py`` (both share
this file's harness), on tiny f32 configs, jitted with their
``in_shardings`` on a (2, 2) mesh over ("data", "model") under
``hint_mesh``, from parameters drawn by its own ``init_*`` and inputs
drawn with numpy; it hands back the parameters, the inputs and every
output.  The port builds the same cells from the same ``ArchSpec``s
(test-made, at these sizes) and runs them on one gloo CPU rank (mesh
(1, 1)) and on 4 (data 2 x model 2), with ``repro``'s parameters carried
across by ``convert``, through ``CellBundle.from_full``; the ranks
import this module, so it imports neither JAX nor ``repro`` at top
level.

  LM        a dense and a MoE config (E 4, top-2, a shared expert: the
            capacity dispatch, queue positions over the whole
            microbatch) and three whose heads do not split over "model"
            (1 kv head; 6 q and 3 kv heads; 3 q heads and 1 kv head,
            1.5 q heads a rank), ``train_4k`` (2
            microbatches, remat, AdamW; the MoE config also in 8
            microbatches of one row, which one of the two data ranks
            holds) and
            ``prefill_32k``: the loss, every updated parameter, the
            logits and the caches; the dense config's ``train_4k`` again
            with ``param_count`` patched past 100e9 in both packages
            (in this file only), where the cell trains with Adafactor
            and bf16 momentum and accumulator;
  recsys    (``tests/test_torch_gspmd_recsys.py``) DCN-v2 ``train_batch``
            (Adagrad) and ``serve_p99``; SASRec
            and MIND ``train_batch`` (the negatives ``repro`` draws from
            its key, fed to the port's step), ``serve_p99`` and
            ``retrieval_cand`` (the candidate slab over every axis).
            SASRec's targets hold pads, so its weighted loss divides by
            weights summed over ranks;
  bandit    the ``distclub-paper`` cell through ``build_cell`` (at 256
            users) equals ``distclub_shard``'s epoch run directly on the
            same ranks, every field bit for bit.

Every value within 1e-5 (relative and absolute), but for AdamW's
elements whose gradient is within ~100x its eps of 0 (``_check``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_distributed import _run_with_devices  # noqa: E402

from repro_torch.launch import mesh  # noqa: E402

AXES = ("data", "model")
B, S = 8, 16
DENSE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
             d_ff=64, vocab=64, qk_norm=True, attn_chunk=8, microbatches=2)
MOE = dict(DENSE, n_experts=4, top_k=2, n_shared=1, d_ff_expert=32,
           moe_every=2)
# heads that do not split evenly over "model" (2): the kv heads gathered
# (``attention.heads_layout`` "kv_gathered"; 6 q heads over 3 kv heads,
# each rank's 3 q heads reading parts of 2), then q heads that straddle
# the ranks' columns ("wq_gathered": 1.5 heads a rank, 3 q heads to a kv
# head)
KVG = dict(DENSE, n_kv_heads=1)
REP = dict(DENSE, n_heads=6, n_kv_heads=3)
CROSS = dict(DENSE, n_heads=3, n_kv_heads=1)
# one row a microbatch over 2 data ranks: one rank holds none
UNEVEN = dict(MOE, microbatches=8)
# the LM configs by file: this one's, and tests/test_torch_gspmd_layouts.py's
LM_PARTS = {"lm": (("dense", DENSE), ("moe", MOE)),
            "layouts": (("kvg", KVG), ("rep", REP), ("cross", CROSS),
                        ("uneven", UNEVEN))}
DCN = dict(n_sparse=3, vocab_per_field=64, embed_dim=4, mlp_dims=(16, 16, 8))
SEQ = dict(n_items=128, embed_dim=8, n_blocks=2, n_heads=2, seq_len=6,
           n_negatives=7)
MIND = dict(n_items=128, embed_dim=8, seq_len=6, n_negatives=7)
RB, C, N_CAND = 8, 5, 32
TOL = 1e-5
SPAWN_S = 120

REFERENCE_HEAD = """
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.base import SDS, ArchSpec, ShapeCell
from repro.distributed import sharding
from repro.launch import steps
from repro.models import transformer
from repro.models.recsys import dcn_v2, mind, seqrec
from repro.train import optimizer

B, S, RB, C, N_CAND = %(B)d, %(S)d, %(RB)d, %(C)d, %(N_CAND)d
# Auto axes: ``repro``'s cells constrain shardings inside the program
mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(2, 2),
                         ("data", "model"))
rng = np.random.RandomState(0)
out = {}

def name(path):
    return ".".join(str(getattr(p, "key", getattr(p, "idx",
                                                  getattr(p, "name", p))))
                    for p in path)

def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "." + name(path)] = np.asarray(leaf)

def run(bundle, args):
    kw = {}
    if bundle.out_shardings is not None:
        kw["out_shardings"] = bundle.out_shardings
    f = jax.jit(bundle.step_fn, in_shardings=bundle.in_shardings, **kw)
    with sharding.hint_mesh(mesh):
        return f(*jax.device_put(args, bundle.in_shardings))

"""

REFERENCE = {"lm": """
for case, kw in %(LM_CASES)r:
    cfg = transformer.LMConfig(**kw, dtype=jnp.float32)
    spec = ArchSpec("tiny", "lm", cfg, {
        "train_4k": ShapeCell("train", lambda c: {
            "tokens": SDS((B, S), jnp.int32),
            "labels": SDS((B, S), jnp.int32)}),
        "prefill_32k": ShapeCell("serve", lambda c: {
            "tokens": SDS((B, S), jnp.int32)})})
    params = transformer.init_lm(jax.random.PRNGKey(0), cfg)
    tokens = rng.randint(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    save(case + ".params", params)
    out[case + ".tokens"] = tokens
    b = steps.build_lm_cell(spec, "train_4k", mesh)
    p2, _, loss = run(b, (params, optimizer.adamw_init(params),
                          tokens[:, :S], tokens[:, 1:]))
    save(case + ".train.params", p2)
    out[case + ".train.loss"] = np.asarray(loss)
    b = steps.build_lm_cell(spec, "prefill_32k", mesh)
    logits, (kc, vc) = run(b, (params, tokens[:, :S]))
    out[case + ".prefill.logits"] = np.asarray(logits)
    out[case + ".prefill.k"] = np.asarray(kc)
    out[case + ".prefill.v"] = np.asarray(vc)
    if case == "dense":
        # past 100e9 parameters the cell trains with Adafactor (bf16
        # momentum and accumulator)
        from unittest import mock
        with mock.patch.object(transformer.LMConfig, "param_count",
                               lambda self: 2e11):
            b = steps.build_lm_cell(spec, "train_4k", mesh)
            opt = optimizer.adafactor_init(params,
                                           momentum_dtype=jnp.bfloat16)
            p2, _, loss = run(b, (params, opt, tokens[:, :S],
                                  tokens[:, 1:]))
        save("adafactor.train.params", p2)
        out["adafactor.train.loss"] = np.asarray(loss)
""", "recsys": """
def fwd(rows, lab):
    def make(c):
        d = {"dense_feats": SDS((rows, c.n_dense), jnp.float32),
             "sparse_ids": SDS((rows, c.n_sparse), jnp.int32)}
        if lab:
            d["labels"] = SDS((rows,), jnp.float32)
        return d
    return make

cfg = dcn_v2.DCNConfig(**%(DCN)r)
spec = ArchSpec("dcn-v2", "recsys", cfg, {
    "train_batch": ShapeCell("train", fwd(RB, True)),
    "serve_p99": ShapeCell("serve", fwd(RB, False))})
params = dcn_v2.init_dcn(jax.random.PRNGKey(1), cfg)
save("dcn.params", params)
dense = rng.randn(RB, cfg.n_dense).astype(np.float32)
ids = rng.randint(0, cfg.vocab_per_field, (RB, cfg.n_sparse)).astype(np.int32)
labels = (rng.rand(RB) < 0.3).astype(np.float32)
out.update({"dcn.dense": dense, "dcn.ids": ids, "dcn.labels": labels})
p2, _, loss = run(steps.build_recsys_cell(spec, "train_batch", mesh),
                  (params, optimizer.adagrad_init(params), dense, ids,
                   labels))
save("dcn.train.params", p2)
out["dcn.train.loss"] = np.asarray(loss)
out["dcn.serve"] = np.asarray(run(
    steps.build_recsys_cell(spec, "serve_p99", mesh), (params, dense, ids)))

for case, cfg, init in (
        ("sasrec", seqrec.SeqRecConfig(**%(SEQ)r), seqrec.init_seqrec),
        ("mind", mind.MINDConfig(**%(MIND)r), mind.init_mind)):
    L = cfg.seq_len
    per_pos = case != "mind"
    spec = ArchSpec(case, "recsys", cfg, {
        "train_batch": ShapeCell("train", lambda c: {
            "hist": SDS((RB, L), jnp.int32), "key": SDS((2,), jnp.uint32),
            "targets": SDS((RB, L) if per_pos else (RB,), jnp.int32)}),
        "serve_p99": ShapeCell("serve", lambda c: {
            "hist": SDS((RB, L), jnp.int32),
            "cand": SDS((RB, C), jnp.int32)}),
        "retrieval_cand": ShapeCell("serve", lambda c: {
            "hist": SDS((1, L), jnp.int32),
            "cand": SDS((N_CAND,), jnp.int32)})})
    params = init(jax.random.PRNGKey(2), cfg)
    save(case + ".params", params)
    hist = rng.randint(0, cfg.n_items, (RB, L)).astype(np.int32)
    hist[:2, :3] = 0                       # pads: weights differ by rank
    tgt = hist if per_pos else rng.randint(
        1, cfg.n_items, (RB,)).astype(np.int32)
    cand = rng.randint(0, cfg.n_items, (RB, C)).astype(np.int32)
    slab = rng.randint(0, cfg.n_items, (N_CAND,)).astype(np.int32)
    key = jax.random.PRNGKey(5)
    out.update({case + ".hist": hist, case + ".targets": tgt,
                case + ".cand": cand, case + ".slab": slab,
                case + ".negatives": np.asarray(jax.random.randint(
                    key, (cfg.n_negatives,), 0, cfg.n_items))})
    p2, _, loss = run(steps.build_recsys_cell(spec, "train_batch", mesh),
                      (params, optimizer.adagrad_init(params), hist, tgt,
                       key))
    save(case + ".train.params", p2)
    out[case + ".train.loss"] = np.asarray(loss)
    out[case + ".serve"] = np.asarray(run(
        steps.build_recsys_cell(spec, "serve_p99", mesh),
        (params, hist, cand)))
    out[case + ".retrieval"] = np.asarray(run(
        steps.build_recsys_cell(spec, "retrieval_cand", mesh),
        (params, hist[:1], slab)))
"""}

REFERENCE_TAIL = """
np.savez(%(PATH)r, **out)
print("saved")
"""


def _sub(ref, prefix) -> dict:
    """The entries of ``ref`` under ``prefix.``, keys without it."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in ref.items() if k.startswith(prefix + ".")}


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _full(tree) -> dict:
    return {k: v.full_tensor().detach() for k, v in _flat(tree).items()}


def _lm_spec(kw):
    from repro_torch.configs.base import ArchSpec, ShapeCell
    from repro_torch.models import transformer as tr

    cfg = tr.LMConfig(**kw, dtype=torch.float32)
    i32 = torch.int32
    return cfg, ArchSpec("tiny", "lm", cfg, {
        "train_4k": ShapeCell("train", lambda c: {
            "tokens": ((B, S), i32), "labels": ((B, S), i32)}),
        "prefill_32k": ShapeCell("serve", lambda c: {
            "tokens": ((B, S), i32)})})


def _recsys_spec(arch, cfg):
    from repro_torch.configs.base import ArchSpec, ShapeCell

    i32, f32 = torch.int32, torch.float32
    if arch == "dcn-v2":
        def fwd(lab):
            def make(c):
                d = {"dense_feats": ((RB, c.n_dense), f32),
                     "sparse_ids": ((RB, c.n_sparse), i32)}
                if lab:
                    d["labels"] = ((RB,), f32)
                return d
            return make
        return ArchSpec(arch, "recsys", cfg, {
            "train_batch": ShapeCell("train", fwd(True)),
            "serve_p99": ShapeCell("serve", fwd(False))})
    L = cfg.seq_len
    tgt = (RB, L) if arch != "mind" else (RB,)
    return ArchSpec(arch, "recsys", cfg, {
        "train_batch": ShapeCell("train", lambda c: {
            "hist": ((RB, L), i32), "seed": ((), torch.int64),
            "targets": (tgt, i32)}),
        "serve_p99": ShapeCell("serve", lambda c: {
            "hist": ((RB, L), i32), "cand": ((RB, C), i32)}),
        "retrieval_cand": ShapeCell("serve", lambda c: {
            "hist": ((1, L), i32), "cand": ((N_CAND,), i32)})})


def _rank_lm(m, ref, out, part):
    from unittest import mock

    from repro_torch import convert
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.train import optimizer

    for case, kw in LM_PARTS[part]:
        cfg, spec = _lm_spec(kw)
        flat = _sub(ref, case + ".params")
        tokens = torch.from_numpy(ref[case + ".tokens"])
        params = convert.lm_from_numpy(flat, cfg, device="cpu").tree()
        cell = steps.build_lm_cell(spec, "train_4k", m)
        p2, _, loss = cell.step_fn(*cell.from_full((
            params, optimizer.adamw_init(params), tokens[:, :S],
            tokens[:, 1:])))
        out[case + ".train.loss"] = loss.full_tensor()
        for k, v in _full(p2).items():
            out[f"{case}.train.params.{k}"] = v
        params = convert.lm_from_numpy(flat, cfg, device="cpu").tree()
        cell = steps.build_lm_cell(spec, "prefill_32k", m)
        logits, (kc, vc) = cell.step_fn(*cell.from_full((params,
                                                         tokens[:, :S])))
        out[case + ".prefill.logits"] = logits.full_tensor()
        out[case + ".prefill.k"] = kc.full_tensor()
        out[case + ".prefill.v"] = vc.full_tensor()
        if case == "dense":
            with mock.patch.object(tr.LMConfig, "param_count",
                                   lambda self: 2e11):
                cell = steps.build_lm_cell(spec, "train_4k", m)
                params = convert.lm_from_numpy(flat, cfg, device="cpu").tree()
                p2, _, loss = cell.step_fn(*cell.from_full((
                    params, optimizer.adafactor_init(params), tokens[:, :S],
                    tokens[:, 1:])))
            out["adafactor.train.loss"] = loss.full_tensor()
            for k, v in _full(p2).items():
                out[f"adafactor.train.params.{k}"] = v


def _rank_recsys(m, ref, out):
    from unittest import mock

    from repro_torch import convert
    from repro_torch.launch import steps
    from repro_torch.models.recsys import dcn_v2, mind, seqrec
    from repro_torch.train import optimizer

    t = {k: torch.from_numpy(v) for k, v in ref.items()
         if not k.split(".")[1] in ("params", "train")}
    cfg = dcn_v2.DCNConfig(**DCN)
    spec = _recsys_spec("dcn-v2", cfg)
    flat = _sub(ref, "dcn.params")
    params = convert.dcn_from_numpy(flat, cfg, device="cpu").tree()
    cell = steps.build_recsys_cell(spec, "train_batch", m)
    p2, _, loss = cell.step_fn(*cell.from_full((
        params, optimizer.adagrad_init(params), t["dcn.dense"], t["dcn.ids"],
        t["dcn.labels"])))
    out["dcn.train.loss"] = loss.full_tensor()
    out.update({f"dcn.train.params.{k}": v for k, v in _full(p2).items()})
    params = convert.dcn_from_numpy(flat, cfg, device="cpu").tree()
    cell = steps.build_recsys_cell(spec, "serve_p99", m)
    out["dcn.serve"] = cell.step_fn(*cell.from_full((
        params, t["dcn.dense"], t["dcn.ids"]))).full_tensor()

    for case, arch, cfg, load in (
            ("sasrec", "sasrec", seqrec.SeqRecConfig(**SEQ),
             convert.seqrec_from_numpy),
            ("mind", "mind", mind.MINDConfig(**MIND), convert.mind_from_numpy)):
        spec = _recsys_spec(arch, cfg)
        flat = _sub(ref, case + ".params")
        params = load(flat, cfg, device="cpu").tree()
        neg = t[case + ".negatives"]
        cell = steps.build_recsys_cell(spec, "train_batch", m)
        with mock.patch.object(steps, "_negatives",
                               lambda seed, cfg, dev: neg.to(dev)):
            p2, _, loss = cell.step_fn(*cell.from_full((
                params, optimizer.adagrad_init(params), t[case + ".hist"],
                t[case + ".targets"], torch.tensor(5))))
        out[case + ".train.loss"] = loss.full_tensor()
        out.update({f"{case}.train.params.{k}": v
                    for k, v in _full(p2).items()})
        params = load(flat, cfg, device="cpu").tree()
        cell = steps.build_recsys_cell(spec, "serve_p99", m)
        out[case + ".serve"] = cell.step_fn(*cell.from_full((
            params, t[case + ".hist"], t[case + ".cand"]))).full_tensor()
        cell = steps.build_recsys_cell(spec, "retrieval_cand", m)
        out[case + ".retrieval"] = cell.step_fn(*cell.from_full((
            params, t[case + ".hist"][:1], t[case + ".slab"]))).full_tensor()


def _rank_bandit(m, out):
    from unittest import mock

    from repro_torch import configs
    from repro_torch.configs import distclub_paper as dp
    from repro_torch.distributed import distclub_shard
    from repro_torch.launch import steps

    n = 256
    with mock.patch.object(dp, "N_USERS", n):
        cell = steps.build_cell("distclub-paper", "online_20k", m,
                                device="cpu")
        init, epoch = distclub_shard.make_runtime(
            m.col(AXES), n, dp.D_FEAT, configs.get("distclub-paper").cfg,
            device="cpu")
        want = epoch(init(), 7, 0)
        got = cell.step_fn(*cell.to_args((init(), torch.tensor([7, 0]))))
    out["bandit.equal"] = all(
        torch.equal(a.to_local(), b) for a, b in zip(got[0], want[0])) \
        and all(torch.equal(a, b) for a, b in zip(got[1], want[1])) \
        and int(got[2]) == int(want[2])


def _rank(rank, col, device, ref, shape, part):
    m = mesh.make_mesh(shape, AXES, "cpu")
    out = {}
    if part == "recsys":
        _rank_recsys(m, ref, out)
    else:
        _rank_lm(m, ref, out, part)
    if part == "lm":
        _rank_bandit(m, out)
    return out


def run_reference(part, tmp_path_factory) -> dict:
    """``repro``'s side of ``part`` ("lm", "layouts" or "recsys"), in a
    subprocess with 4 XLA host devices."""
    path = str(tmp_path_factory.mktemp("gspmd") / "ref.npz")
    code = REFERENCE_HEAD + REFERENCE[
        "recsys" if part == "recsys" else "lm"] + REFERENCE_TAIL
    _run_with_devices(code % dict(
        B=B, S=S, RB=RB, C=C, N_CAND=N_CAND, LM_CASES=LM_PARTS.get(part),
        DCN=DCN, SEQ=SEQ, MIND=MIND, PATH=path), n=4)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def run_ports(reference, part) -> dict:
    """world -> every rank's outputs (1 rank, mesh (1, 1); 4 ranks, mesh
    (2, 2))."""
    from concurrent.futures import ThreadPoolExecutor

    worlds = ((1, (1, 1)), (4, (2, 2)))
    with ThreadPoolExecutor(len(worlds)) as pool:     # the two side by side
        runs = {w: pool.submit(mesh.spawn, _rank, w, "gloo", device="cpu",
                               args=(reference, shape, part),
                               timeout=SPAWN_S) for w, shape in worlds}
        return {w: run.result() for w, run in runs.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("lm", tmp_path_factory)


@pytest.fixture(scope="module")
def ports(reference):
    return run_ports(reference, "lm")


ADAMW = dict(lr=3e-4, weight_decay=0.01)    # the LM train cells' AdamW
ADAMW_CASES = ("dense", "moe", "kvg", "rep", "cross", "uneven")
KNEE = 0.99


def _check(ref, got, key):
    got, want = np.asarray(got), ref[key]
    case, _, leaf = key.partition(".train.params.")
    if leaf and case in ADAMW_CASES:
        # AdamW's first step moves an element by lr (g / (|g| + eps) + wd
        # p): where |g| is near eps (1e-8, a gradient that cancels to
        # ~1e-8 of its ~3e-3 terms) the step turns on the gradient's last
        # bits, which the two packages sum in other orders.  Those
        # elements, 0.01 < |g / (|g| + eps)| < KNEE by repro's step, are
        # left out of the 1e-5 check, and must be under 1% of the leaf (an
        # expert few tokens reach has more of them); which they are is
        # read from repro's step alone, so a wrong port still fails on
        # the rest.  A gradient of exactly 0 (a row no token reached)
        # stays in.
        p0 = ref[f"{case}.params.{leaf}"]
        step = np.abs(-(want - p0) / ADAMW["lr"]
                      - ADAMW["weight_decay"] * p0)
        knee = (step > 0.01) & (step < KNEE)
        assert knee.mean() < 1e-2, (key, int(knee.sum()))
        got, want = got[~knee], want[~knee]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=key)


def check_case(reference, outs, prefixes) -> None:
    """Every rank's outputs under ``prefixes`` against ``repro``'s."""
    for rank, got in enumerate(outs):
        keys = [k for k in reference
                if any(k == p or k.startswith(p + ".") for p in prefixes)]
        assert keys and set(keys) <= set(got), (prefixes, rank)
        for k in keys:
            _check(reference, got[k], k)


CASES = {
    "lm_dense": ("dense.train", "dense.prefill"),
    "lm_moe": ("moe.train", "moe.prefill"),
    "lm_adafactor": ("adafactor.train",),
}


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_cell_matches_repros_jitted_cell(case, world, reference, ports):
    check_case(reference, ports[world], CASES[case])


@pytest.mark.parametrize("world", [1, 4])
def test_bandit_cell_is_distclub_shard(world, ports):
    assert all(out["bandit.equal"] for out in ports[world])
