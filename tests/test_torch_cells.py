"""The port's cell builder (``launch.steps.build_cell``) and roofline
model (``launch.roofline``) against ``repro``'s, without running a step.

``repro``'s side runs once, in a subprocess with 512 XLA host devices:
it builds every LM decode cell's shardings on both production meshes
(``build_decode_step``, nothing compiled) and reports each leaf's
``NamedSharding.shard_shape``, and it evaluates its analytic roofline
numerators at every registered cell.  This file imports neither JAX nor
``repro``.

  shapes    for every registered LM arch x {decode_32k, long_500k} x the
            meshes (16, 16) and (2, 16, 16), with and without the int8
            cache: every per-rank shape ``build_cell`` gives (parameters,
            caches, scales) equals ``repro``'s shard shape of the same
            leaf, at the first and the last rank; this covers llama4's
            f-sharded layout and long_500k's replicated batch at full
            size;
  roofline  the four ``_*_flops_bytes`` return ``repro``'s numerators
            exactly at every registered cell on both meshes, and
            ``Terms``' times are those numerators over the port's H100
            constants.
"""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_distributed import _run_with_devices  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh, roofline, steps  # noqa: E402

MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
SHAPES = ("decode_32k", "long_500k")
LM_ARCHS = sorted(a for a, s in configs.REGISTRY.items() if s.family == "lm")

REFERENCE = """
import json
import jax, jax.numpy as jnp
from repro import configs
from repro.distributed import decode_shard
from repro.launch import roofline
from repro.models import transformer

MESHES = %(MESHES)r
out = {"shapes": {}, "roofline": {}}
for arch in %(LM_ARCHS)r:
    spec = configs.get(arch)
    params = jax.eval_shape(
        lambda k: transformer.init_lm(k, spec.cfg),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    for shape in %(SHAPES)r:
        cfg = spec.cell_cfg(shape)
        inputs = spec.input_specs(shape)
        cache = inputs["k_cache"].shape
        for tag, (dims, axes) in MESHES.items():
            m = jax.make_mesh(dims, axes)
            for q in (False, True):
                _, p_sh, c_sh = decode_shard.build_decode_step(
                    m, cfg, inputs["token"].shape[0], cache[4], kv_quant=q)
                got = {}
                for (path, leaf), sh in zip(
                        jax.tree_util.tree_flatten_with_path(params)[0],
                        jax.tree.leaves(p_sh)):
                    name = ".".join(str(p.key) for p in path)
                    got[name] = list(sh.shard_shape(leaf.shape))
                for i, sh in enumerate(c_sh):
                    full = cache if i < 2 else cache[:-1]
                    got[f"cache{i}"] = list(sh.shard_shape(full))
                out["shapes"][f"{arch}|{shape}|{tag}|{q}"] = got
for arch, shape in configs.all_cells():
    spec = configs.get(arch)
    cfg = spec.cell_cfg(shape)
    for chips, multi in ((256, False), (512, True)):
        if spec.family == "lm":
            nums = roofline._lm_flops_bytes(cfg, shape, chips, multi)
        elif spec.family == "gnn":
            from repro.configs.gat_cora import CELL_DIMS
            nums = roofline._gnn_flops_bytes(cfg, shape, chips,
                                             CELL_DIMS[shape])
        elif spec.family == "recsys":
            nums = roofline._recsys_flops_bytes(spec, cfg, shape, chips)
        else:
            nums = roofline._bandit_flops_bytes(cfg, chips)
        out["roofline"][f"{arch}|{shape}|{chips}"] = [
            spec.family, list(nums)]
print("JSON" + json.dumps(out))
""" % dict(MESHES=MESHES, LM_ARCHS=LM_ARCHS, SHAPES=SHAPES)


@pytest.fixture(scope="module")
def reference():
    out = _run_with_devices(REFERENCE, n=512)
    line = [ln for ln in out.splitlines() if ln.startswith("JSON")][-1]
    return json.loads(line[4:])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
def test_build_cell_shapes_are_repros_shard_shapes(shape, tag, reference):
    dims, axes = MESHES[tag]
    n = 1
    for s in dims:
        n *= s
    for arch in LM_ARCHS:
        for q in (False, True):
            want = reference["shapes"][f"{arch}|{shape}|{tag}|{q}"]
            for rank in (0, n - 1):
                cell = steps.build_cell(arch, shape,
                                        mesh.mesh_spec(dims, axes, rank),
                                        kv_quant=q, device="cpu")
                assert cell.kind == "decode"
                params, _, caches, _ = cell.local_args
                got = {k: list(v[0]) for k, v in _flat(params).items()}
                got.update({f"cache{i}": list(c[0])
                            for i, c in enumerate(caches)})
                assert got == want, (arch, shape, tag, q, rank)
                dtypes = [c[1] for c in caches]
                assert dtypes == ([torch.int8] * 2 + [torch.float32] * 2
                                  if q else [configs.get(arch).cfg.dtype] * 2)


def test_build_cell_refuses_the_gspmd_cells():
    m = mesh.mesh_spec((16, 16), ("data", "model"))
    for arch, shape in (("qwen3-4b", "train_4k"), ("qwen3-4b", "prefill_32k"),
                        ("dcn-v2", "serve_p99"), ("gat-cora", "molecule")):
        with pytest.raises(NotImplementedError, match="9d-2"):
            steps.build_cell(arch, shape, m, device="cpu")


def test_roofline_numerators_are_repros(reference):
    from repro_torch.configs import distclub_paper
    from repro_torch.configs.gat_cora import CELL_DIMS
    cells = reference["roofline"]
    port_cells = {(a, s) for a, s in configs.all_cells()}
    assert {tuple(k.split("|")[:2]) for k in cells} == port_cells | {
        ("distclub-paper", "online_20k")}
    for key, (family, want) in cells.items():
        arch, shape, chips = key.split("|")
        chips = int(chips)
        if family == "bandit":
            got = roofline._bandit_flops_bytes(distclub_paper.CONFIG, chips)
        else:
            spec = configs.get(arch)
            cfg = spec.cell_cfg(shape)
            if family == "lm":
                got = roofline._lm_flops_bytes(cfg, shape, chips,
                                               chips == 512)
            elif family == "gnn":
                got = roofline._gnn_flops_bytes(cfg, shape, chips,
                                                CELL_DIMS[shape])
            else:
                got = roofline._recsys_flops_bytes(spec, cfg, shape, chips)
        assert list(got) == want, key
        rec = {"arch": arch, "shape": shape, "kind": family,
               "mesh": [chips // 256, 16, 16] if chips == 512 else [16, 16],
               "multi_pod": chips == 512,
               "memory": {"argument_bytes": 0, "temp_bytes": 0}}
        t = roofline.analyze(rec)
        model, ana, hbm, coll = want
        assert (t.model_flops, t.ana_flops, t.ana_hbm_bytes,
                t.ana_coll_bytes) == (model, ana, hbm, coll), key
        assert t.t_compute == ana / (chips * 989e12)
        assert t.t_memory == hbm / (chips * 3.35e12)
        assert t.t_collective == coll / 50e9


def test_roofline_reads_the_ports_own_results():
    assert roofline.RESULTS.name == "dryrun_torch"
    assert roofline.RESULTS.parent.name == "results"
    if not roofline.RESULTS.exists():
        assert roofline.load_all("pod1") == []
    assert "| arch |" in roofline.table([])


@pytest.mark.parametrize("moe", [False, True])
def test_param_shapes_are_the_models(moe):
    """``transformer.param_shapes`` (what ``build_cell`` cuts) against the
    shapes and dtypes of a model ``LM`` draws, dense and MoE (a block of a
    dense and a MoE layer)."""
    from repro_torch.models import transformer
    kw = dict(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32,
              moe_every=2) if moe else {}
    cfg = transformer.LMConfig(n_layers=4, d_model=32, n_heads=4,
                               n_kv_heads=2, d_head=8, d_ff=64, vocab=64,
                               qk_norm=True, **kw)
    model = transformer.LM(cfg, device="cpu")
    want = {n: [list(p.shape), p.dtype] for n, p in model.named_parameters()}
    got = {n: [list(s), dt] for n, (s, dt) in
           _flat(transformer.param_shapes(cfg)).items()}
    assert got == want
