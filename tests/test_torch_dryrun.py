"""The port's dry run (``launch.dryrun``) and fit check
(``launch.fitcheck``) on the CPU, without a card.

``run_cell`` joins a fake group of 512 ranks in this process and runs one
rank's step on fake tensors; ``repro``'s side runs once, in a subprocess
with 512 XLA host devices, and reports the bytes of its device-0 shard of
each argument (``NamedSharding.shard_shape`` x itemsize).

  records     DCN-v2 ``serve_p99``, Qwen3-4B ``decode_32k`` and a small LM
              ``train_4k`` (a test-made ``ArchSpec``, every dim divisible
              by the mesh) on (2, 16, 16): ``repro``'s record fields, a
              trace on fake tensors, ``argument_bytes`` equal to the sum
              of ``repro``'s shard bytes exactly (the global-program
              cells), collective bytes recorded for the tensor-parallel
              cells, FLOPs at least a lower bound counted from the
              config, the donated state aliased; ``roofline.analyze``
              reads them;
  fitcheck    resident = arguments + max(0, outputs - aliased) against
              the budget, on records made up here: the table, the count
              and the exit code, over and under;
  counter     ``Counter`` sees a DTensor op's local pieces, not the fake
              global tensors DTensor derives its shapes on, and lets an
              op's tensors go when the caller drops them (no reference
              cycle that waits for the collector).
"""
import gc
import json
from unittest import mock

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_distributed import _run_with_devices  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ArchSpec, ShapeCell  # noqa: E402
from repro_torch.launch import dryrun, fitcheck, roofline  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

TINY = dict(n_layers=2, d_model=64, n_heads=16, n_kv_heads=16, d_head=16,
            d_ff=128, vocab=256, microbatches=2, attn_chunk=16)
TB, TS = 64, 16

REFERENCE = """
import json
import jax, jax.numpy as jnp
from repro import configs
from repro.configs.base import SDS, ArchSpec, ShapeCell
from repro.launch import steps
from repro.models import transformer

mesh = jax.make_mesh((2, 16, 16), ("pod", "data", "model"))
spec = ArchSpec("tiny-lm", "lm", transformer.LMConfig(**%(TINY)r), {
    "train_4k": ShapeCell("train", lambda c: {
        "tokens": SDS((%(TB)d, %(TS)d), jnp.int32),
        "labels": SDS((%(TB)d, %(TS)d), jnp.int32)})})
out = {}
for key, bundle in (
        ("dcn-v2|serve_p99", steps.build_cell("dcn-v2", "serve_p99", mesh)),
        ("tiny-lm|train_4k", steps.build_lm_cell(spec, "train_4k", mesh))):
    total = 0
    for a, sh in zip(bundle.abstract_args, bundle.in_shardings):
        for leaf, s in zip(jax.tree.leaves(a), jax.tree.leaves(sh)):
            n = 1
            for d in s.shard_shape(leaf.shape):
                n *= d
            total += n * leaf.dtype.itemsize
    out[key] = total
print("JSON" + json.dumps(out))
""" % dict(TINY=TINY, TB=TB, TS=TS)


def _tiny_spec():
    cfg = tr.LMConfig(**TINY)
    return ArchSpec("tiny-lm", "lm", cfg, {
        "train_4k": ShapeCell("train", lambda c: {
            "tokens": ((TB, TS), torch.int32),
            "labels": ((TB, TS), torch.int32)})})


@pytest.fixture(scope="module")
def reference():
    out = _run_with_devices(REFERENCE, n=512)
    line = [ln for ln in out.splitlines() if ln.startswith("JSON")][-1]
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def records():
    with mock.patch.dict(configs.REGISTRY, {"tiny-lm": _tiny_spec()}):
        return {(a, s): dryrun.run_cell(a, s, multi_pod=True)
                for a, s in (("dcn-v2", "serve_p99"),
                             ("qwen3-4b", "decode_32k"),
                             ("tiny-lm", "train_4k"))}


FIELDS = {"arch", "shape", "mesh", "axes", "multi_pod", "kind", "traced",
          "trace_s", "flops_per_device", "bytes_per_device",
          "collective_bytes_per_device", "memory"}


@pytest.mark.parametrize("cell", ["dcn-v2|serve_p99", "qwen3-4b|decode_32k",
                                  "tiny-lm|train_4k"])
def test_record_fields(cell, records):
    rec = records[tuple(cell.split("|"))]
    assert set(rec) == FIELDS
    assert rec["mesh"] == [2, 16, 16]
    assert rec["axes"] == ["pod", "data", "model"] and rec["multi_pod"]
    assert rec["traced"] == "fake"
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["temp_bytes"] >= 0
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    json.dumps(rec)


@pytest.mark.parametrize("cell", ["dcn-v2|serve_p99", "tiny-lm|train_4k"])
def test_argument_bytes_are_repros_shard_bytes(cell, records, reference):
    rec = records[tuple(cell.split("|"))]
    assert rec["memory"]["argument_bytes"] == reference[cell]


def test_tensor_parallel_cells_record_collectives(records):
    for key in (("qwen3-4b", "decode_32k"), ("tiny-lm", "train_4k")):
        coll = records[key]["collective_bytes_per_device"]
        assert coll.get("all-reduce", 0) > 0, key
        assert coll["total"] == sum(v for k, v in coll.items()
                                    if k != "total"), key


def test_local_flops_and_donation(records):
    """This rank's own work: the small LM's matmul FLOPs are at least
    its forward and backward over its local rows (6 x its slice of the
    parameters x its tokens), and far under the global count; the
    train step's parameters and moments alias the donated ones."""
    rec = records[("tiny-lm", "train_4k")]
    cfg = _tiny_spec().cfg
    body = cfg.param_count() - 2 * cfg.vocab * cfg.d_model
    local_tokens = TB * TS // 32
    assert rec["flops_per_device"] >= 6 * body / 16 * local_tokens
    assert rec["flops_per_device"] < 6 * cfg.param_count() * TB * TS / 4
    mem = rec["memory"]
    assert 0 < mem["alias_bytes"] <= mem["output_bytes"]
    assert mem["alias_bytes"] <= mem["argument_bytes"]
    assert records[("dcn-v2", "serve_p99")]["memory"]["alias_bytes"] == 0


def test_roofline_reads_the_records(records):
    t = roofline.analyze(records[("dcn-v2", "serve_p99")])
    assert t.chips == 512 and t.hlo_flops > 0
    assert t.mem_args_gib == \
        records[("dcn-v2", "serve_p99")]["memory"]["argument_bytes"] / 2**30


def _record(path, arch, shape, args, out, alias, temp):
    path.joinpath(f"{arch}__{shape}__pod1.json").write_text(json.dumps({
        "arch": arch, "shape": shape, "memory": {
            "argument_bytes": args, "output_bytes": out,
            "alias_bytes": alias, "temp_bytes": temp}}))


@pytest.mark.parametrize("over", [False, True])
def test_fitcheck_arithmetic_and_exit(over, tmp_path, capsys):
    gib = 2 ** 30
    _record(tmp_path, "a", "train", 50 * gib, 40 * gib, 40 * gib, 7 * gib)
    # 60 GiB of arguments + (30 - 5) GiB of new outputs = 85 GiB resident
    _record(tmp_path, "b", "serve", 60 * gib, 30 * gib, 5 * gib, 1 * gib)
    budget = 80 if over else 90
    rc = fitcheck.main(["--budget-gib", str(budget)], results=tmp_path)
    text = capsys.readouterr().out
    assert rc == (1 if over else 0)
    rows = {ln.split()[0]: ln.split() for ln in text.splitlines()
            if ln.startswith(("a ", "b "))}
    assert rows["a"][2] == "50.00" and rows["a"][-1] == "OK"
    assert rows["b"][2] == "85.00"
    assert rows["b"][-1] == ("OVER" if over else "OK")
    # the peak: resident plus temporaries, 57 and 86 GiB
    assert rows["a"][4:6] == ["57.00", "OK"]
    assert rows["b"][4:6] == ["86.00", "OVER" if over else "OK"]
    assert f"{1 if over else 2}/2 cells fit" in text
    assert f"{1 if over else 2}/2 with their peak temporaries" in text
    assert [r[:3] for r in fitcheck.rows("pod1", budget * gib, tmp_path)] \
        == [("a", "train", 50 * gib), ("b", "serve", 85 * gib)]


def test_counter_sees_local_pieces_only():
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed.sharding import P
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import _dt

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=3, world_size=16, store=FakeStore())
    try:
        m = mesh_lib.make_mesh((4, 4), ("data", "model"), "cpu")
        spec, full = P(None, "model", "data", None), (2, 8, 32, 64)
        with FakeTensorMode(allow_non_fake_inputs=True):
            a, g = (_dt(torch.zeros(2, 2, 8, 64), spec, full, m)
                    for _ in range(2))
            counter = dryrun.Counter()
            with counter:
                a.add_(g)
                b = a * 2
        # a's piece (written in place) and b's; a global tensor is 16x one
        piece = 2 * 2 * 8 * 64 * 4
        assert counter.peak == 2 * piece, counter.peak
        assert b.to_local().shape == (2, 2, 8, 64)
    finally:
        dist.destroy_process_group()


def test_counter_releases_without_the_collector():
    x = torch.ones(256, 256)
    counter = dryrun.Counter()
    gc.disable()
    try:
        with counter:
            for _ in range(3):
                y = torch.cat([x, x]) * 2
                del y
        assert counter.live == 0 and counter.peak == 2 * 2 * x.nbytes
    finally:
        gc.enable()
