"""Dry run of the production meshes on the CPU: build each cell on 256 or
512 ranks and run one rank's step without a card (``repro.launch.dryrun``,
which lowers and compiles each cell for 512 XLA host devices).

One process joins a fake process group (``torch.testing``'s ``FakeStore``
and the ``"fake"`` backend: collectives return at once and move
nothing) as one rank of ``launch.mesh.make_production_mesh``, builds the
cell with ``launch.steps.build_cell``, and runs its step on fake tensors
of the rank's local shapes (``FakeTensorMode``: shapes and dtypes, no
memory) under a dispatch mode that sees every op the rank's body runs,
below DTensor, on local tensors (not the fake global tensors on which
DTensor derives an op's output shapes):

  flops_per_device    matmul FLOPs (``torch.utils.flop_counter``'s
                      formulas) of this rank's local ops;
  bytes_per_device    bytes read and written by its ops that allocate or
                      write (each operand once, each output once; views
                      move nothing, and nothing is fused);
  collective_bytes_per_device
                      by kind, ``repro``'s model: each collective's output
                      bytes, 2x for an all-reduce;
  memory              ``argument_bytes`` (this rank's shards of the
                      arguments), ``output_bytes``, ``alias_bytes`` (the
                      outputs that take the place of donated arguments:
                      a train step's parameters and optimizer state, a
                      bandit epoch's state, as ``repro`` donates them) and
                      ``temp_bytes``, the peak of live tensors less the
                      arguments.

A step that reads a value on the host (the bandit epoch's seed and loop
counts, the sequence models' seed for their negatives) cannot run on fake
tensors; it runs instead on
real CPU tensors of the rank's local shapes, still under the fake group,
whose collectives then leave their outputs as they were allocated: its
numbers count the same ops, its values mean nothing, and the record says
``"traced": "cpu"`` (else ``"fake"``).  ``trace_s`` stands where
``repro`` records ``lower_s`` and ``compile_s``.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--filter lm]
Results: results/dryrun_torch/<arch>__<shape>__<pod1|pod2>[_kvq].json,
read by ``launch.roofline`` and ``launch.fitcheck``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" \
    / "dryrun_torch"

_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
          ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("send", "collective-permute"),
          ("recv", "collective-permute"), ("broadcast", "all-gather"))
_DONATED = {"train": (0, 1), "bandit_epoch": (0,)}


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in order.  No
    nested function: one that calls itself is a reference cycle, which
    would hold the op's tensors until the cyclic collector ran."""
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            todo.extend(reversed(list(x.values())))
        elif isinstance(x, (list, tuple)):
            todo.extend(reversed(x))
    return out


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _key(t) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t) -> int:
    return t.untyped_storage().nbytes()


def _unique_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        seen[_key(t)] = _nbytes(t)
    return sum(seen.values())


class Counter(TorchDispatchMode):
    """Counts this rank's local ops: matmul FLOPs, bytes, collective bytes
    by kind, and the live bytes of the tensors they make (peak)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll = {}
        self.live = 0
        self.peak = 0
        self._count = {}       # storage -> live tensors on it
        self._size = {}
        self._tracked = set()  # ids of tracked tensors
        self._shadow = 0       # > 0 inside DTensor's shape propagation
        self._restore = None

    def __enter__(self):
        # DTensor derives an op's output shapes by running it on fake
        # tensors of the global shapes: no memory, no work on a card
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as prop

        name = "_propagate_tensor_meta_non_cached"
        orig = prop.__dict__.get(name)
        if orig is not None:
            def shadow(*args, **kwargs):
                self._shadow += 1
                try:
                    return orig(*args, **kwargs)
                finally:
                    self._shadow -= 1

            setattr(prop, name, shadow)
            self._restore = (prop, name, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        if self._restore is not None:
            setattr(*self._restore)
            self._restore = None
        return super().__exit__(*exc)

    def track(self, t) -> None:
        if id(t) in self._tracked:
            return
        k = _key(t)
        if k not in self._count:
            self._count[k] = 0
            self._size[k] = _nbytes(t)
            self.live += self._size[k]
            self.peak = max(self.peak, self.live)
        self._count[k] += 1
        self._tracked.add(id(t))
        weakref.finalize(t, self._release, k, id(t))

    def _release(self, k, tid) -> None:
        self._tracked.discard(tid)
        self._count[k] -= 1
        if not self._count[k]:
            self.live -= self._size.pop(k)
            del self._count[k]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._shadow:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        name = func.name()
        ns = name.split("::")[0]
        if ns in ("_c10d_functional", "c10d"):
            self._collective(name, ins, outs)
        else:
            packet = func.overloadpacket
            if packet in self.flop_registry:
                self.flops += self.flop_registry[packet](
                    *args, **kwargs, out_val=out)
            in_keys = {_key(t) for t in ins}
            fresh = any(_key(t) not in in_keys for t in outs)
            if fresh or name.endswith("_") or ".out" in name:
                self.bytes += sum(t.nbytes for t in ins + outs)
        for t in outs:
            self.track(t)
        return out

    def _collective(self, name, ins, outs) -> None:
        if "wait" in name:
            return
        kind = next((k for s, k in _KINDS if s in name), None)
        if kind is None:
            return
        moved = outs if kind != "collective-permute" else ins
        n = sum(t.nbytes for t in moved)
        if kind == "all-reduce":
            n *= 2
        self.coll[kind] = self.coll.get(kind, 0) + n
        self.coll["total"] = self.coll.get("total", 0) + n


def _zeros(local_args):
    """Zero tensors of the local ``(shape, dtype)`` trees (fake ones under
    the caller's ``FakeTensorMode``)."""
    def walk(tree):
        if isinstance(tree, tuple) and len(tree) == 2 \
                and isinstance(tree[1], torch.dtype):
            return torch.zeros(tuple(tree[0]), dtype=tree[1])
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(walk(v) for v in tree))
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return tree

    return tuple(walk(a) for a in local_args)


def _bandit_state(bundle):
    """The rank's initial DistCLUB shard (an epoch on zeros would invert
    singular matrices)."""
    from ..configs import distclub_paper as dp
    from ..distributed import distclub_shard
    from .mesh import all_axes

    mesh = bundle.mesh
    state = distclub_shard.init_state(
        dp.N_USERS, dp.D_FEAT, dp.CONFIG, mesh.col(all_axes(mesh)),
        device="cpu")
    return state, torch.tensor([0, 0])


def _run(bundle, fake: bool) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    counter = Counter()
    with (FakeTensorMode(allow_non_fake_inputs=True) if fake
          else contextlib.nullcontext()):
        if bundle.kind == "bandit_epoch" and not fake:
            local = _bandit_state(bundle)
        elif bundle.global_args:
            local = _zeros(bundle.local_args)
        else:                       # decode: local tensors and a host pos
            local = _zeros(bundle.local_args)[:3] + (0,)
        args = bundle.to_args(local) if bundle.global_args else local
        arg_tensors = _tensors(local)
        for t in arg_tensors:
            counter.track(t)
        base = counter.live
        counter.peak = base
        with counter:
            out = bundle.step_fn(*args)
        outs = [_local(t) for t in _tensors(out)]
        donated = _DONATED.get(bundle.kind, ())
        alias = [_local(t) for i in donated for t in _tensors(out[i])]
        return {
            "flops_per_device": float(counter.flops),
            "bytes_per_device": float(counter.bytes),
            "collective_bytes_per_device": counter.coll,
            "memory": {
                "argument_bytes": _unique_bytes(arg_tensors),
                "output_bytes": _unique_bytes(outs),
                "temp_bytes": counter.peak - base,
                "alias_bytes": _unique_bytes(alias),
            },
        }


def run_cell(arch: str, shape: str, multi_pod: bool,
             kv_quant: bool = False, rank: int = 0) -> dict:
    """One rank's record of cell ``(arch, shape)`` on the (16, 16) or
    (2, 16, 16) mesh, in a fake group joined here and left after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from . import mesh as mesh_lib, steps

    world = 512 if multi_pod else 256
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=rank, world_size=world,
                            store=FakeStore())
    try:
        mesh = mesh_lib.make_production_mesh(multi_pod, device_type="cpu")
        t0 = time.time()
        bundle = steps.build_cell(arch, shape, mesh, kv_quant=kv_quant,
                                  device="cpu")
        try:
            rec, traced = _run(bundle, fake=True), "fake"
        except Exception as e:  # noqa: BLE001 — a host read: see the doc
            if not _host_read(e):
                raise
            rec, traced = _run(bundle, fake=False), "cpu"
        rec = {
            "arch": arch, "shape": shape, "mesh": list(mesh.sizes),
            "axes": list(mesh.axis_names), "multi_pod": multi_pod,
            "kind": bundle.kind, "traced": traced,
            "trace_s": round(time.time() - t0, 2), **rec,
        }
    finally:
        dist.destroy_process_group()
    return rec


def _host_read(e: Exception) -> bool:
    """Whether ``e`` is a fake tensor's refusal to give a value to the
    host (``.item()``, ``int()``, ``.tolist()``, a data-dependent
    shape)."""
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException)
    from torch.fx.experimental.symbolic_shapes import \
        GuardOnDataDependentSymNode

    return isinstance(e, (DataDependentOutputException,
                          DynamicOutputShapeException,
                          GuardOnDataDependentSymNode))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--filter", default="",
                    help="substring filter on arch id")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV-cache variant for LM decode cells")
    args = ap.parse_args(argv)

    from .. import configs

    torch.set_num_threads(1)
    if args.all:
        cells = [(a, s) for a, s in configs.all_cells() if args.filter in a]
    else:
        cells = [(args.arch, args.shape)]
    RESULTS.mkdir(parents=True, exist_ok=True)
    tag = "pod2" if args.multi_pod else "pod1"
    if args.kv_quant:
        tag += "_kvq"
    failures = []
    for arch, shape in cells:
        out = RESULTS / f"{arch}__{shape}__{tag}.json"
        if out.exists() and not args.force:
            print(f"[skip] {arch} x {shape} ({tag}) — cached")
            continue
        print(f"[dryrun] {arch} x {shape} ({tag}) ...", flush=True)
        try:
            rec = run_cell(arch, shape, args.multi_pod,
                           kv_quant=args.kv_quant)
        except Exception as e:  # noqa: BLE001 — record and go on
            failures.append((arch, shape, repr(e)))
            print(f"  FAIL: {e}\n{traceback.format_exc()}", flush=True)
            continue
        out.write_text(json.dumps(rec, indent=1))
        mem = rec["memory"]
        print(f"  ok ({rec['traced']}): trace {rec['trace_s']}s, "
              f"flops/dev {rec['flops_per_device']:.3g}, "
              f"args/dev {mem['argument_bytes'] / 2**30:.2f} GiB, "
              f"temp/dev {mem['temp_bytes'] / 2**30:.2f} GiB, "
              f"coll/dev "
              f"{rec['collective_bytes_per_device'].get('total', 0) / 2**20:.1f}"
              f" MiB", flush=True)
    if failures:
        print(f"\n{len(failures)} failures:")
        for a, s, e in failures:
            print(f"  {a} x {s}: {e[:200]}")
        raise SystemExit(1)
    print("\nall cells traced.")


if __name__ == "__main__":
    main()
