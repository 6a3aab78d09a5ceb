"""The port's cell builder (``launch.steps.build_cell``) and roofline
model (``launch.roofline``) against ``repro``'s, without running a step.

``repro``'s side runs once, in a subprocess with 512 XLA host devices:
it builds every LM decode cell's shardings on both production meshes
(``build_decode_step``, nothing compiled) and every other cell's
``CellBundle`` (abstract arguments and ``in_shardings``), and reports
each leaf's ``NamedSharding.shard_shape``; it gives its spec trees
(``zero_specs`` of each LM, the six recsys trees) and evaluates its
analytic roofline numerators at every registered cell.  This file
imports neither JAX nor ``repro``.

  shapes    for every registered LM arch x {decode_32k, long_500k} x the
            meshes (16, 16) and (2, 16, 16), with and without the int8
            cache: every per-rank shape ``build_cell`` gives (parameters,
            caches, scales) equals ``repro``'s shard shape of the same
            leaf, at the first and the last rank; this covers llama4's
            f-sharded layout and long_500k's replicated batch at full
            size;
  cells     for every other cell of ``all_cells()`` on both meshes, every
            argument's per-rank shape at the first and the last rank
            equals ``repro``'s shard shape (leaf by pytree path; the
            sequence models' train ``seed``, where ``repro`` takes a
            PRNG key, is left out);
  specs     ``zero_specs`` of every LM's ``lm_specs``, ``dcn_specs``,
            ``seqrec_specs``, ``mind_specs``, ``table_specs``,
            ``layer_norm_specs`` and ``mlp_specs`` entry for entry;
            ``sharding.placements`` and ``shard`` cut the same piece on
            every rank of a (2, 2, 2) mesh (a fake group of 8);
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
out = {"shapes": {}, "roofline": {}, "cells": {}, "specs": {}}
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
from repro.launch import steps as rsteps
from repro.distributed import sharding as rsh
from repro.models import layers as rlayers
from repro.models.recsys import dcn_v2, embedding, mind, seqrec

def path_name(path):
    out = []
    for p in path:
        out.append(str(getattr(p, "key", getattr(p, "idx",
                                                 getattr(p, "name", p)))))
    return ".".join(out)

for tag, (dims, axes) in MESHES.items():
    m = jax.make_mesh(dims, axes)
    for arch, shape in configs.all_cells():
        spec = configs.get(arch)
        if spec.shapes[shape].kind == "decode":
            continue
        b = rsteps.build_cell(arch, shape, m)
        got = {}
        for i, (a, sh) in enumerate(zip(b.abstract_args, b.in_shardings)):
            leaves = jax.tree_util.tree_flatten_with_path(a)[0]
            shs = jax.tree.leaves(sh)
            for (path, leaf), s_ in zip(leaves, shs):
                got[f"{i}.{path_name(path)}"] = list(
                    s_.shard_shape(leaf.shape))
        out["cells"][f"{arch}|{shape}|{tag}"] = got

def spec_tree(t):
    return jax.tree.map(lambda s: [list(e) if isinstance(e, tuple) else e
                                   for e in s], t,
                        is_leaf=lambda x: isinstance(x, P))

from jax.sharding import PartitionSpec as P
for arch in %(LM_ARCHS)r:
    spec = configs.get(arch)
    params = jax.eval_shape(
        lambda k: transformer.init_lm(k, spec.cfg),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    out["specs"]["zero|" + arch] = spec_tree(rsh.zero_specs(
        transformer.lm_specs(spec.cfg), params, 16))
out["specs"]["dcn"] = spec_tree(dcn_v2.dcn_specs(configs.get("dcn-v2").cfg))
out["specs"]["seqrec"] = spec_tree(seqrec.seqrec_specs(
    configs.get("sasrec").cfg))
out["specs"]["mind"] = spec_tree(mind.mind_specs(configs.get("mind").cfg))
out["specs"]["table"] = spec_tree(embedding.table_specs())
out["specs"]["layer_norm"] = spec_tree(rlayers.layer_norm_specs())
out["specs"]["mlp"] = spec_tree(rlayers.mlp_specs(3))

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
    """The cells ``build_cell`` once refused now build, as global programs
    (their steps take DTensors); a decode cell's step takes local tensors,
    and ``to_args`` refuses to wrap them."""
    m = mesh.mesh_spec((16, 16), ("data", "model"))
    for arch, shape in (("qwen3-4b", "train_4k"), ("qwen3-4b", "prefill_32k"),
                        ("dcn-v2", "serve_p99"), ("gat-cora", "molecule")):
        cell = steps.build_cell(arch, shape, m, device="cpu")
        assert cell.global_args and cell.mesh is m
        assert len(cell.local_args) == len(cell.arg_specs)
    with pytest.raises(ValueError, match="local tensors"):
        steps.build_cell("qwen3-4b", "decode_32k", m, device="cpu").to_args(
            ())


def _paths(args) -> dict:
    """``{"<arg>.<pytree path>": local shape}`` of a bundle's
    ``local_args``, named as ``jax.tree_util`` names the paths."""
    out = {}

    def walk(x, name):
        if isinstance(x, tuple) and len(x) == 2 \
                and isinstance(x[1], torch.dtype):
            out[name] = list(x[0])
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{name}.{k}" if not name.endswith(".") else
                     name + str(k))
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for f in x._fields:
                walk(getattr(x, f), name + f if name.endswith(".") else
                     f"{name}.{f}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, name + str(i) if name.endswith(".") else
                     f"{name}.{i}")

    for i, a in enumerate(args):
        walk(a, f"{i}.")
    return out


GLOBAL_CELLS = [(a, s) for a, s in configs.all_cells()
                if configs.get(a).shapes[s].kind != "decode"]


@pytest.mark.parametrize("tag", list(MESHES))
def test_every_cell_shape_is_repros_shard_shape(tag, reference):
    dims, axes = MESHES[tag]
    n = 1
    for s in dims:
        n *= s
    assert {k for k in reference["cells"] if k.endswith("|" + tag)} == {
        f"{a}|{s}|{tag}" for a, s in GLOBAL_CELLS}
    for arch, shape in GLOBAL_CELLS:
        want = reference["cells"][f"{arch}|{shape}|{tag}"]
        seq_train = (configs.get(arch).family == "recsys" and arch != "dcn-v2"
                     and shape == "train_batch")
        if seq_train:       # repro's PRNG key against the port's seed
            want = {k: v for k, v in want.items() if not k.startswith("4.")}
        for rank in (0, n - 1):
            cell = steps.build_cell(arch, shape,
                                    mesh.mesh_spec(dims, axes, rank),
                                    device="cpu")
            got = _paths(cell.local_args)
            if seq_train:
                got = {k: v for k, v in got.items() if not k.startswith("4.")}
            assert got == want, (arch, shape, tag, rank)


def _spec_lists(tree):
    from repro_torch.distributed.sharding import P
    if isinstance(tree, P):
        return [list(e) if isinstance(e, tuple) else e for e in tree]
    if isinstance(tree, dict):
        return {k: _spec_lists(v) for k, v in tree.items()}
    return [_spec_lists(v) for v in tree]


def test_spec_trees_are_repros(reference):
    from repro_torch.distributed.sharding import zero_specs
    from repro_torch.models import layers, transformer
    from repro_torch.models.recsys import dcn_v2, embedding, mind, seqrec
    want = reference["specs"]
    for arch in LM_ARCHS:
        cfg = configs.get(arch).cfg
        got = zero_specs(transformer.lm_specs(cfg),
                         transformer.param_shapes(cfg), 16)
        assert _spec_lists(got) == want["zero|" + arch], arch
    assert _spec_lists(dcn_v2.dcn_specs(configs.get("dcn-v2").cfg)) \
        == want["dcn"]
    assert _spec_lists(seqrec.seqrec_specs(configs.get("sasrec").cfg)) \
        == want["seqrec"]
    assert _spec_lists(mind.mind_specs(configs.get("mind").cfg)) \
        == want["mind"]
    assert _spec_lists(embedding.table_specs()) == want["table"]
    assert _spec_lists(layers.layer_norm_specs()) == want["layer_norm"]
    assert _spec_lists(layers.mlp_specs(3)) == want["mlp"]


def test_placements_cut_what_shard_cuts():
    """On every rank of a (2, 2, 2) mesh (a fake group of 8 in this
    process), the DTensor placements of a spec select the piece
    ``sharding.shard`` cuts, tuple entries included, and
    ``init_device_mesh`` lays the ranks out as ``Mesh.coords`` does."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import P
    dims, axes = (2, 2, 2), ("pod", "data", "model")
    full = (8, 16, 16)
    x = torch.arange(8 * 16 * 16).reshape(full)
    specs = [P(), P("data"), P(("pod", "data"), None, "model"),
             P(None, ("pod", "data", "model")), P("model", ("pod", "data"))]
    for rank in range(8):
        dist.init_process_group("fake", rank=rank, world_size=8,
                                store=FakeStore())
        try:
            dm = init_device_mesh("cpu", dims, mesh_dim_names=axes)
            desc = mesh.mesh_spec(dims, axes, rank)
            assert tuple(dm.get_coordinate()) == desc.coords
            for spec in specs:
                shape, offset = compute_local_shape_and_global_offset(
                    full, dm, sharding.placements(spec, dm))
                want = x[tuple(slice(o, o + n)
                               for o, n in zip(offset, shape))]
                assert torch.equal(sharding.shard(x, spec, desc), want), (
                    rank, spec)
        finally:
            dist.destroy_process_group()


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
