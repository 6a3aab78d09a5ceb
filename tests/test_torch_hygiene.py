"""Package rules of the PyTorch port: no JAX and nothing of ``repro``
inside ``repro_torch``; entry points default to CUDA and never fall back
to the CPU quietly; plain versions on the CPU launch no kernel; the
synthetic environment's draws do not depend on how the users are sliced;
states convert across without loss."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import convert  # noqa: E402
from repro_torch.configs import distclub_paper  # noqa: E402
from repro_torch.core import distclub, env, env_ops  # noqa: E402
from repro_torch.core.types import BanditHyper  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
print(" ".join(names))
"""


def test_package_imports_neither_jax_nor_repro():
    env_vars = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env_vars,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.splitlines()
    count, bad = out[0].split(maxsplit=1)
    assert int(count) >= 30, out
    assert bad.strip() == "[]", bad
    names = set(out[1].split())
    for mod in ("models.recsys.dcn_v2", "models.recsys.seqrec",
                "models.recsys.mind", "models.attention", "launch.serve",
                "kernels.cross.ops", "kernels.embag.ops", "configs.dcn_v2",
                "core.club", "core.dccb", "kernels.ucb.ops",
                "kernels.flash.ops", "kernels.flash.ref",
                "models.transformer", "configs.qwen3_4b",
                "configs.llama3_8b", "configs.yi_34b", "data.datasets",
                "data.replay", "distributed.distclub_shard",
                "distributed.dccb_shard", "distributed.sharding",
                "launch.mesh", "runtime.collectives", "train.checkpoint",
                "serve.guardrails", "serve.faults", "serve.experiments",
                "launch.faultrun", "launch.abrun", "models.moe",
                "models.gnn", "configs.deepseek_moe_16b",
                "configs.llama4_maverick_400b_a17b", "configs.gat_cora",
                "launch.steps", "distributed.decode_shard",
                "launch.roofline", "distributed.spmd",
                "launch.dryrun", "launch.fitcheck",
                "configs.distclub_paper"):
        assert f"repro_torch.{mod}" in names, mod
    for kind in ("synthetic", "drift", "catalog", "replay",
                 "default_synthetic"):
        assert callable(getattr(env_ops, f"{kind}_ops")), kind


def _example_imports(example: str) -> str:
    root = SRC.parent
    env_vars = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(root / "examples")]))
    code = (f"import sys, {example}; print(sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    return subprocess.run([sys.executable, "-c", code], env=env_vars,
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout


def test_quickstart_imports_neither_jax_nor_repro():
    out = _example_imports("quickstart_torch")
    assert out.strip() == "[]", out


def test_serve_bandit_example_imports_neither_jax_nor_repro():
    out = _example_imports("serve_bandit_torch")
    assert out.strip() == "[]", out


def test_ab_experiment_example_imports_neither_jax_nor_repro():
    out = _example_imports("ab_experiment_torch")
    assert out.strip() == "[]", out


def test_ops_entry_points_need_a_device_without_cuda(monkeypatch):
    import importlib

    from repro_torch.launch import abrun, faultrun
    monkeypatch.syspath_prepend(str(SRC.parent / "examples"))
    example = importlib.import_module("ab_experiment_torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((faultrun.main, ["--rounds", "1"]),
                       (faultrun.main, ["--scenario", "churn", "--guard"]),
                       (abrun.main, ["--rounds", "1"]),
                       (abrun.main, ["--env", "catalog"]),
                       (example.main, [])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)


def test_traffic_stream_needs_a_device_without_cuda(monkeypatch):
    from repro_torch.serve import faults
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        faults.TrafficStream(0, 4, 8, K=2, d=2)
    stream = faults.TrafficStream(0, 4, 8, K=2, d=2, device="cpu")
    users, ctx, uniforms = stream.slate_batch(0)
    assert users.device.type == ctx.device.type == "cpu"
    assert uniforms.device.type == "cpu"


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hyper = BanditHyper(sigma=2, max_rounds=2, n_candidates=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distclub.init_state(8, 3, hyper)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.make_synthetic_env(0, 8, 3, 2, 3)
    e, _ = env.make_synthetic_env(0, 8, 3, 2, 3, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distclub.run(env_ops.synthetic_ops(e), 0, hyper, 1, 3)


def test_dataset_entry_points_need_a_device_without_cuda(monkeypatch):
    from repro_torch.data import datasets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = datasets.DatasetSpec("tiny", 64, 8, 3, 2, 4)
    for kind in ("synthetic", "replay", "drift", "catalog"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            datasets.make_env(spec, kind=kind)
        ops, _ = datasets.make_env(spec, kind=kind, device="cpu")
        assert ops.contexts_fn(0, 0, torch.zeros(8, dtype=torch.int32)
                               ).device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.make_drift_env(0, 8, 3, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env_ops.default_synthetic_ops(8, 3, 4)
    assert env.make_drift_env(0, 8, 3, 2, device="cpu")[0].noise.device.type \
        == "cpu"


def test_baseline_entry_points_need_a_device_without_cuda(monkeypatch):
    from repro_torch.core import club, dccb
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hyper = BanditHyper(delta_net=4, buffer_size=2, n_candidates=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        club.init_state(8, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dccb.init_state(8, 3, 2)
    e, _ = env.make_synthetic_env(0, 8, 3, 2, 3, device="cpu")
    ops = env_ops.synthetic_ops(e)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        club.run(ops, 0, hyper, 4, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dccb.run(ops, 0, hyper, 1, 3, 2)


def test_cpu_baseline_runs_launch_no_kernel_and_learn():
    from repro_torch.core import club, dccb
    n, d, K = 48, 6, 10
    hyper = BanditHyper(gamma=0.8, delta_net=32, buffer_size=4,
                        n_candidates=K)
    e, _ = env.make_synthetic_env(0, n, d, 4, K, 0.05, device="cpu")
    ops = env_ops.synthetic_ops(e)
    _build.reset_launches()
    s, m = club.run(ops, 0, hyper, 256, d, device="cpu")
    assert m.reward.shape == (256,) and int(m.interactions.sum()) == 256
    assert int(s.lin.occ.sum()) == 256
    assert float(m.reward.sum()) > float(m.rand_reward.sum())
    s, m, n_clu = dccb.run(ops, 0, hyper, 3, d, 4, device="cpu")
    assert m.reward.shape == (12,) and n_clu.shape == (3,)
    assert int(m.interactions.sum()) == 12 * n == int(s.occ.sum())
    assert float(s.comm_bytes) == 3 * n * 5 * (d * d + d) * 4
    # DCCB learns where gossip only averages: one planted cluster and a
    # gamma that cuts no edge (cuts reset both users), past the first L
    # rounds, whose w = 0, Minv = I scores tie
    e1, _ = env.make_synthetic_env(0, n, d, 1, K, 0.05, device="cpu")
    _, m, _ = dccb.run(env_ops.synthetic_ops(e1), 0,
                       hyper._replace(gamma=4.0), 8, d, 4, device="cpu")
    assert float(m.reward[4:].sum()) > 1.1 * float(m.rand_reward[4:].sum())
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES
    # the synthetic env's baseline draws: host users, neighbours only
    assert [ops.user_fn(0, t) for t in range(3)] == [
        env_ops.draw_user(0, t, n) for t in range(3)]
    peers = ops.peers_fn(0, 1, s.adj)
    assert bool(s.adj[torch.arange(n), peers].all())


def test_serving_entry_points_need_a_device_without_cuda(monkeypatch):
    from repro_torch import serve
    from repro_torch.core import catalog
    from repro_torch.serve import pending
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hyper = BanditHyper(n_candidates=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.OnlineBandit.create(8, 3, hyper)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.make_catalog_env(0, 8, 3, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        catalog.random_catalog(torch.Generator(), 16, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.init_stats(16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pending.init(4, 3)
    sess = serve.OnlineBandit.create(8, 3, hyper, device="cpu")
    assert sess.state.Minv.device.type == "cpu"


def test_sharded_entry_points_need_a_device_without_cuda(monkeypatch):
    from repro_torch import serve
    from repro_torch.distributed import dccb_shard, distclub_shard
    from repro_torch.runtime.collectives import DistCollectives
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hyper = BanditHyper(sigma=2, max_rounds=2, buffer_size=2, n_candidates=3)
    col = DistCollectives(group=None, rank=1, shards=2, host_staged=False)
    e, _ = env.make_synthetic_env(0, 8, 3, 2, 3, device="cpu")
    ops = env_ops.synthetic_ops(e)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distclub_shard.make_runtime(col, 8, 3, hyper, ops)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dccb_shard.make_runtime(col, 8, 3, 2, hyper, ops)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.OnlineBandit.sharded(col, 8, 3, hyper)
    init, _ = distclub_shard.make_runtime(col, 8, 3, hyper, ops,
                                          device="cpu")
    assert init().Minv.shape == (4, 3, 3)
    init, _ = dccb_shard.make_runtime(col, 8, 3, 2, hyper, ops, device="cpu")
    assert init().xbuf.shape == (4, 2, 3)
    sess = serve.OnlineBandit.sharded(col, 8, 3, hyper, device="cpu")
    assert sess.state.b.shape == (4, 3) and sess.col is col


def test_mesh_refuses_more_nccl_ranks_than_cards(monkeypatch):
    from repro_torch.launch import mesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.rank_devices(1, "nccl") == [torch.device("cuda", 0)]
    for world in (2, 4):
        with pytest.raises(ValueError, match="one rank per card"):
            mesh.spawn(print, world, "nccl")
    assert mesh.rank_devices(4, "gloo", "cuda:0") == [
        torch.device("cuda", 0)] * 4
    with pytest.raises(ValueError, match="explicit device"):
        mesh.rank_devices(2, "gloo")


def test_decode_entry_points_need_a_device_without_cuda(monkeypatch):
    from repro_torch.distributed import decode_shard
    from repro_torch.launch import mesh, steps
    from repro_torch.models import transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = transformer.LMConfig(n_layers=1, d_model=16, n_heads=2,
                               n_kv_heads=1, d_head=8, d_ff=32, vocab=32)
    one = mesh.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode_shard.build_decode_step(one, cfg, 2, 8)
    spec = mesh.mesh_spec((16, 16), ("data", "model"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.build_cell("qwen3-4b", "decode_32k", spec)
    ds = decode_shard.build_decode_step(one, cfg, 2, 8, device="cpu")
    model = transformer.LM(cfg, device="cpu")
    assert ds.shard_params(model.tree())["embed"].device.type == "cpu"
    # a description of a mesh binds no group: its step refuses to run
    ds = decode_shard.build_decode_step(
        mesh.mesh_spec((2, 2), ("data", "model")), cfg, 2, 8, device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        ds.step(None, torch.zeros(1, dtype=torch.int32), None, 0)


def test_recsys_entry_points_need_a_device_without_cuda(monkeypatch):
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.recsys import dcn_v2, mind, seqrec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = (dcn_v2.DCNv2, dcn_v2.DCNConfig(vocab_per_field=8, embed_dim=2,
                                            mlp_dims=(4,))), \
        (seqrec.SeqRec, seqrec.SeqRecConfig(n_items=8, embed_dim=4,
                                            seq_len=4)), \
        (mind.MIND, mind.MINDConfig(n_items=8, embed_dim=4))
    for cls, cfg in small:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(cfg)
        assert next(cls(cfg, device="cpu").parameters()).device.type == "cpu"
    args = serve_cli.parse_args(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.serve_recsys(None, args)


def test_lm_entry_points_need_a_device_without_cuda(monkeypatch):
    from repro_torch import configs
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = transformer.LMConfig(n_layers=1, d_model=16, n_heads=2,
                               n_kv_heads=1, d_head=8, d_ff=32, vocab=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.LM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_cache(cfg, 2, 8)
    model = transformer.LM(cfg, device="cpu")
    params = {name: p.detach().float().numpy()
              for name, p in model.named_parameters()}
    tree = {}
    for name, a in params.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = a
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lm_from_numpy(tree, cfg)
    assert convert.lm_from_numpy(tree, cfg, device="cpu").embed.device.type \
        == "cpu"
    args = serve_cli.parse_args(["--arch", "qwen3-4b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.serve_lm(configs.get("qwen3-4b"), args)


def test_cpu_recsys_calls_launch_no_kernel():
    from repro_torch.models.recsys import dcn_v2, embedding
    cfg = dcn_v2.DCNConfig(vocab_per_field=16, embed_dim=4, mlp_dims=(8,))
    model = dcn_v2.DCNv2(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    _build.reset_launches()
    logits = dcn_v2.dcn_fwd(model, torch.randn(5, 13, generator=g),
                            torch.randint(0, 16, (5, 26), generator=g,
                                          dtype=torch.int32))
    bags = embedding.bag_lookup(model.tables[0],
                                torch.randint(0, 16, (3, 4), generator=g,
                                              dtype=torch.int32))
    assert logits.shape == (5,) and bags.shape == (3, 4)
    assert _build.LAUNCHES["cross"] == 0
    assert _build.LAUNCHES["embedding_bag"] == 0


def test_cpu_run_launches_no_kernel_and_learns():
    n, d, K = 48, 6, 10
    hyper = BanditHyper(sigma=6, max_rounds=12, gamma=0.8, n_candidates=K)
    e, _ = env.make_synthetic_env(0, n, d, 4, K, 0.05, device="cpu")
    _build.reset_launches()
    state, m, n_clusters = distclub.run(env_ops.synthetic_ops(e), 0, hyper,
                                        2, d, device="cpu")
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES
    assert m.reward.shape == (2 * 2 * hyper.max_rounds,)
    assert n_clusters.shape == (2,)
    assert int(m.interactions.sum()) > 0
    assert float(m.reward.sum()) > float(m.rand_reward.sum())
    for t in (state.lin.M, state.lin.Minv, state.lin.b):
        assert bool(torch.isfinite(t).all())


def test_synthetic_draws_are_keyed_by_global_user_id():
    n, d, K = 40, 7, 5
    e, _ = env.make_synthetic_env(3, n, d, 4, K, device="cpu")
    ops = env_ops.synthetic_ops(e)
    occ = torch.zeros(n, dtype=torch.int32)
    full = ops.contexts_fn(5, 11, occ)
    part = ops.contexts_fn(5, 11, occ[16:], row0=16)
    assert full.shape == (n, K, d)
    assert torch.equal(full[16:], part)
    torch.testing.assert_close(torch.linalg.norm(full, dim=-1),
                               torch.ones(n, K), rtol=0, atol=1e-6)
    choice = torch.zeros(n, dtype=torch.int32)
    r_full = ops.rewards_fn(5, 11, occ, full, choice)
    r_part = ops.rewards_fn(5, 11, occ[16:], part, choice[16:], row0=16)
    for a, b in zip(r_full, r_part):
        assert torch.equal(a[16:], b)
    # another round or another seed draws afresh
    assert not torch.equal(full, ops.contexts_fn(5, 12, occ))
    assert not torch.equal(full, ops.contexts_fn(6, 11, occ))


def test_state_round_trips_through_numpy():
    hyper = distclub_paper.CONFIG._replace(max_rounds=2, sigma=1)
    n, d = 40, 4
    e, _ = env.make_synthetic_env(1, n, d, 3, hyper.n_candidates,
                                  device="cpu")
    state, _, _ = distclub.run(env_ops.synthetic_ops(e), 0, hyper, 1, d,
                               device="cpu")
    arrays = convert.state_to_numpy(state)
    assert arrays.graph.adj.dtype == np.uint32
    back = convert.state_from_numpy(arrays, device="cpu")
    for rec_a, rec_b in zip(state, back):
        for a, b in zip(*(r if isinstance(r, tuple) else (r,)
                          for r in (rec_a, rec_b))):
            assert a.shape == b.shape and torch.equal(a, b)


def test_gnn_and_moe_entry_points_need_a_device_without_cuda(monkeypatch):
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train
    from repro_torch.models import gnn, transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gnn.GNNConfig(d_feat=6, n_classes=3, n_heads=2, d_hidden=4)
    params = [{k: t.numpy() for k, t in layer.items()}
              for layer in gnn.init_gat(torch.Generator(), cfg)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.gat_from_numpy(params, cfg)
    assert convert.gat_from_numpy(params, cfg, device="cpu")[0][
        "W"].device.type == "cpu"
    moe_cfg = dataclasses.replace(
        configs.get("deepseek-moe-16b").cfg, n_layers=1, d_model=16,
        n_heads=2, n_kv_heads=2, d_head=8, vocab=32, n_experts=4,
        d_ff_expert=8, top_k=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.LM(moe_cfg)
    args = serve_cli.parse_args(["--arch", "llama4-maverick-400b-a17b",
                                 "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.serve_lm(configs.get(args.arch), args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "deepseek-moe-16b", "--reduce", "--steps",
                    "1"])
