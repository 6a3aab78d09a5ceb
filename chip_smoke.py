#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the whole check, one card

Phases, in order; any failure raises and the script exits non-zero:

1. device  the card's name and power limit (``nvidia-smi``); no CUDA, exit.
2. build   every CUDA kernel of the main path from ``src/repro_torch/csrc``
           (one ``nvcc`` per source, all at once), with the seconds taken.
3. small   each kernel against its plain PyTorch version on ragged small
           shapes.
4. main    ``repro_torch.core.distclub.run`` at the paper's full width
           (20480 users, d=25, K=20, 100 planted clusters,
           ``distclub_paper.CONFIG``) for 2 epochs, with the kernel launch
           counters set to 0 just before and read just after; then one
           more epoch, timed warm, and once more under torch.profiler for
           the device time by kernel.
   plain   the same run with every kernel wrapper swapped for its plain
           version, on the same CUDA tensors: no kernel may launch, and
           its clusters per epoch and reward/random must agree with the
           kernel path's within the bands of ``compare_paths``.
5. full    each kernel against its plain version on the state that run
           left (and on the full first-epoch adjacency for prune).
6. times   median of 25 launches (CUDA events, L2 flushed before each) of
           every kernel and its plain version at the main path's shapes,
           beside the least time the card could take (bytes over 3.35 TB/s
           or f32 operations over 67 TFLOP/s, counted from these inputs).

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, f32 outside tensor cores
EPOCHS = 2
SEED = 0
REPS = 25

KERNEL_INFO = {  # name -> (source, TPU kernel it replaces)
    "choose": ("src/repro_torch/csrc/choose.cu",
               "src/repro/kernels/interact/interact.py:80"),
    "rank1_update_inv": ("src/repro_torch/csrc/rank1.cu",
                         "src/repro/kernels/rank1/rank1.py:72"),
    "prune": ("src/repro_torch/csrc/prune.cu",
              "src/repro/kernels/graph/graph.py:65"),
    "cc_hop": ("src/repro_torch/csrc/cc_hop.cu",
               "src/repro/kernels/graph/graph.py:123"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# kernel against plain version
# ---------------------------------------------------------------------------


def check_choose(w, Minv, ctx, occ, alpha):
    """x must be ctx[choice] exactly; choices equal except where the
    plain version's scores of the two picks are within 1e-5 max(1, |s|).
    The error reported is the largest plain-score gap between the plain
    pick and the kernel's, over all rows."""
    import torch
    from repro_torch.kernels.interact import ops, ref
    choice_k, x_k = ops.choose(w, Minv, ctx, occ, alpha)
    scores = ref.ucb_scores_ref(w, Minv, ctx, occ, alpha)
    choice_p = torch.argmax(scores, dim=-1)
    gathered = torch.take_along_dim(ctx, choice_k.long()[:, None, None],
                                    dim=1)[:, 0]
    assert torch.equal(x_k, gathered), "choose: x is not ctx[choice]"
    s_p = torch.take_along_dim(scores, choice_p[:, None], dim=1)[:, 0]
    s_k = torch.take_along_dim(scores, choice_k.long()[:, None], dim=1)[:, 0]
    gap = s_p - s_k                  # 0 where the picks agree
    near = gap <= 1e-5 * torch.clamp_min(s_p.abs(), 1.0)
    assert bool(near.all()), (
        f"choose: {int((~near).sum())} choices differ beyond a near tie")
    n_diff = int((choice_k.long() != choice_p).sum())
    return {"max_abs_err": float(gap.max()), "near_ties": n_diff}


def check_rank1(Minv, b, x, r, mask):
    """Minv and b within rtol = atol = 1e-5; masked rows bit-identical."""
    import torch
    from repro_torch.kernels.rank1 import ops, ref
    Minv_p, b_p = ref.rank1_update_inv_ref(Minv.clone(), b.clone(), x, r,
                                           mask)
    Minv_k, b_k = ops.rank1_update_inv(Minv.clone(), b.clone(), x, r, mask)
    torch.testing.assert_close(Minv_k, Minv_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b_k, b_p, rtol=1e-5, atol=1e-5)
    off = ~mask
    assert torch.equal(Minv_k[off], Minv[off]) and torch.equal(b_k[off],
                                                                b[off])
    err = max(float((Minv_k - Minv_p).abs().max()),
              float((b_k - b_p).abs().max()))
    return {"max_abs_err": err}


def check_prune(adj, v_i, cb_i, v_j, cb_j, gamma):
    """Bit-equal, except pairs with |dist - thresh| <= 1e-5 thresh.  The
    error reported is the largest |dist - thresh| (f64) over the pairs
    whose bits differ, 0 where none do."""
    import torch
    from repro_torch.kernels.graph import ops, ref
    out_k = ops.prune_packed(adj, v_i, cb_i, v_j, cb_j, gamma)
    out_p = ref.prune_packed_ref(adj, v_i, cb_i, v_j, cb_j, gamma)
    assert not bool((out_k & ~adj).any()), "prune set a bit"
    pairs = []
    for r0 in range(0, adj.shape[0], 2048):
        xor = ref.unpack_bits(out_k[r0:r0 + 2048] ^ out_p[r0:r0 + 2048],
                              v_j.shape[0])
        ij = torch.nonzero(xor)
        ij[:, 0] += r0
        pairs.append(ij)
    ij = torch.cat(pairs)
    vi, vj = v_i[ij[:, 0]].double(), v_j[ij[:, 1]].double()
    d2 = (vi * vi).sum(-1) + (vj * vj).sum(-1) - 2 * (vi * vj).sum(-1)
    dist = torch.sqrt(torch.clamp_min(d2, 0))
    thresh = gamma * (cb_i[ij[:, 0]].double() + cb_j[ij[:, 1]].double())
    near = (dist - thresh).abs() <= 1e-5 * thresh
    assert bool(near.all()), (
        f"prune: {int((~near).sum())} bits differ away from the boundary")
    err = float((dist - thresh).abs().max()) if ij.shape[0] else 0.0
    return {"max_abs_err": err, "near_ties": int(ij.shape[0])}


def check_cc_hop(adj, labels_self, labels_j):
    """Integer-exact."""
    import torch
    from repro_torch.kernels.graph import ops, ref
    out_k = ops.cc_hop_packed(adj, labels_self, labels_j)
    out_p = ref.cc_hop_packed_ref(adj, labels_self, labels_j)
    err = float((out_k.long() - out_p.long()).abs().max())
    assert err == 0, "cc_hop differs from its plain version"
    return {"max_abs_err": err}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def spd_inverse(g, n, d, device):
    import torch
    A = 0.3 * torch.randn(n, d, d, generator=g, device=device)
    M = torch.eye(d, device=device) + A @ A.transpose(1, 2)
    return torch.linalg.inv(M).contiguous()


def unit(x):
    import torch
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def small_checks(dev):
    import torch
    from repro_torch.core import clustering
    from repro_torch.kernels.graph import ref as gref
    g = torch.Generator(device=dev).manual_seed(1234)

    n, d, K = 37, 19, 7
    w = 0.5 * torch.randn(n, d, generator=g, device=dev)
    Minv = spd_inverse(g, n, d, dev)
    ctx = unit(torch.randn(n, K, d, generator=g, device=dev)).contiguous()
    occ = torch.randint(0, 1000, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    log(f"small choose (n={n}, d={d}, K={K}): "
        f"{check_choose(w, Minv, ctx, occ, 0.3)}")

    nd, Kd, dd = 16, 12, 8
    ctx2 = torch.randn(nd, Kd, dd, generator=g, device=dev)
    ctx2[:, 5] = ctx2[:, 2]
    ctx2[:, 9] = ctx2[:, 2]
    w2 = torch.randn(nd, dd, generator=g, device=dev)
    eye = torch.eye(dd, device=dev).expand(nd, dd, dd).contiguous()
    ones = torch.ones(nd, dtype=torch.int32, device=dev)
    from repro_torch.kernels.interact import ops as iops
    choice, _ = iops.choose(w2, eye, ctx2, ones, 0.3)
    assert not bool(((choice == 5) | (choice == 9)).any()), (
        "choose: a duplicate candidate beat its first copy")
    log(f"small choose duplicates: {check_choose(w2, eye, ctx2, ones, 0.3)}")

    b = torch.randn(n, d, generator=g, device=dev)
    x = torch.randn(n, d, generator=g, device=dev)
    r = torch.rand(n, generator=g, device=dev)
    mask = torch.rand(n, generator=g, device=dev) < 0.7
    log(f"small rank1 (n={n}, d={d}): {check_rank1(Minv, b, x, r, mask)}")

    ng = 33
    dense = torch.rand(ng, ng, generator=g, device=dev) < 0.7
    dense = torch.triu(dense, 1)
    dense = dense | dense.T
    adj = gref.pack_bits(dense)
    v = torch.randn(ng, d, generator=g, device=dev)
    cb = clustering.cb_width(torch.randint(0, 100, (ng,), generator=g,
                                           device=dev))
    log(f"small prune (n={ng}, d={d}): "
        f"{check_prune(adj, v, cb, v, cb, 1.2)}")
    sparse = torch.rand(ng, ng, generator=g, device=dev) < 0.08
    sparse = torch.triu(sparse, 1)
    labels = torch.randperm(ng, generator=g, device=dev).to(torch.int32)
    log(f"small cc_hop (n={ng}): "
        f"{check_cc_hop(gref.pack_bits(sparse | sparse.T), labels, labels)}")


@contextlib.contextmanager
def plain_path():
    """Every kernel wrapper swapped for its plain version, so that the
    engines run the plain PyTorch path on the CUDA tensors."""
    from repro_torch.kernels.graph import ops as gops
    from repro_torch.kernels.graph import ref as gref
    from repro_torch.kernels.interact import ops as iops
    from repro_torch.kernels.interact import ref as iref
    from repro_torch.kernels.rank1 import ops as rops
    from repro_torch.kernels.rank1 import ref as rref
    with contextlib.ExitStack() as stack:
        for module, name, plain in (
                (iops, "choose", iref.choose_ref),
                (rops, "rank1_update_inv", rref.rank1_update_inv_ref),
                (gops, "prune_packed", gref.prune_packed_ref),
                (gops, "cc_hop_packed", gref.cc_hop_packed_ref)):
            stack.enter_context(mock.patch.object(module, name, plain))
        yield


def compare_paths(kernel, plain, n: int) -> None:
    """Kernel path against plain path, each ``(reward/random, clusters per
    epoch)``.  The two trajectories part at the first candidate tie that
    they round differently (cold-start bonuses tie to the last ulp), so
    they are held to statistics, not step by step: reward/random within 1%
    of the kernel path's (the bandit's lift over random is ~5%, so a path
    that learned nothing fails), clusters after each stage 2 within 1% of
    the n users."""
    (r_k, c_k), (r_p, c_p) = kernel, plain
    log(f"paths: kernel reward/random={r_k} clusters={c_k}; "
        f"plain reward/random={r_p} clusters={c_p}")
    assert abs(r_p - r_k) <= 0.01 * r_k, "reward/random: paths disagree"
    assert all(abs(a - b) <= 0.01 * n for a, b in zip(c_k, c_p)), (
        "clusters per epoch: paths disagree")


def cuda_ms(fn, flush) -> float:
    """Median milliseconds of ``fn`` over REPS launches (CUDA events), the
    L2 cache flushed before each."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_epoch(distclub, state, ops, hyper, d, steady_s) -> None:
    """Device time by kernel over one more epoch (torch.profiler), and its
    share of ``steady_s``, the same epoch's wall time without the profiler
    (whose own host cost inflates the wall time it sees)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        distclub.epoch(state, ops, SEED, EPOCHS, hyper, d)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda ev: -ev.self_device_time_total)
    busy_us = sum(ev.self_device_time_total for ev in kernels)
    log(f"profile: device busy {busy_us / 1e3} ms in an epoch of "
        f"{steady_s * 1e3} ms wall ({busy_us / (steady_s * 1e6)} busy)")
    for ev in kernels[:25]:
        log(f"  {ev.self_device_time_total / 1e3:10.3f} ms "
            f"{ev.count:6d}x  {ev.key[:90]}")


def popcount(words):
    """Set bits in an int32 tensor of packed words."""
    x = words.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return int(((x * 0x01010101) >> 24 & 0xFF).sum())


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_mem = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops
                                     else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2

    # ---- phase 1: device ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    # f32 products in full f32: TF32 would move choices and edge bits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from repro_torch.configs import distclub_paper as paper
    from repro_torch.core import clustering, distclub, env, env_ops, linucb
    from repro_torch.kernels import _build
    from repro_torch.kernels.graph import ops as gops
    from repro_torch.kernels.graph import ref as gref
    from repro_torch.kernels.interact import ops as iops
    from repro_torch.kernels.interact import ref as iref
    from repro_torch.kernels.rank1 import ops as rops
    from repro_torch.kernels.rank1 import ref as rref

    # ---- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build: {len(reports)} kernels in {time.perf_counter() - t0:.2f} s")
    for kname, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {kname}: {line.strip()}")

    # ---- phase 3: small shapes -----------------------------------------------
    small_checks(dev)
    torch.cuda.synchronize()

    # ---- phase 4: the main path at full width --------------------------------
    n, d, hyper = paper.N_USERS, paper.D_FEAT, paper.CONFIG
    K, R = hyper.n_candidates, hyper.max_rounds
    e, _ = env.make_synthetic_env(SEED, n, d, paper.N_CLUSTERS, K,
                                  paper.WITHIN_CLUSTER_NOISE, device=dev)
    ops = env_ops.synthetic_ops(e)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    state, metrics, n_clusters = distclub.run(ops, SEED, hyper, EPOCHS, d,
                                              device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    reward = float(metrics.reward.sum())
    rand = float(metrics.rand_reward.sum())
    inter = int(metrics.interactions.sum())
    log(f"main path: n={n} d={d} K={K} epochs={EPOCHS} "
        f"interactions={inter} reward={reward} random={rand} "
        f"reward/random={reward / rand}")
    log(f"clusters per epoch={n_clusters.tolist()} "
        f"comm_bytes={float(state.comm_bytes)} "
        f"seconds/epoch={wall / EPOCHS} (incl. first-epoch warm-up) "
        f"max_memory_allocated={peak}")
    log(f"launches: {launches}")
    assert metrics.reward.shape == (EPOCHS * 2 * R,)
    for t in (state.lin.M, state.lin.Minv, state.lin.b, metrics.reward):
        assert bool(torch.isfinite(t).all()), "non-finite output"
    assert state.graph.adj.shape == (n, gref.packed_words(n))
    assert 1 <= int(n_clusters.min()) and int(n_clusters.max()) <= n
    assert reward / rand > 1.0, "the bandit does no better than random"
    assert launches["choose"] == 2 * R * EPOCHS, launches
    assert launches["rank1_update_inv"] == 2 * R * EPOCHS, launches
    assert launches["prune"] == EPOCHS, launches
    assert EPOCHS <= launches["cc_hop"] <= EPOCHS * n, launches

    # one more epoch from the run's state, warm: the steady epoch time
    t0 = time.perf_counter()
    distclub.epoch(state, ops, SEED, EPOCHS, hyper, d)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    log(f"steady epoch (epoch {EPOCHS + 1}): {steady_s} s")
    profile_epoch(distclub, state, ops, hyper, d, steady_s)

    # ---- phase 4, plain: the same run through the plain versions -------------
    _build.reset_launches()
    t0 = time.perf_counter()
    with plain_path():
        _, p_metrics, p_clusters = distclub.run(ops, SEED, hyper, EPOCHS, d,
                                                device=dev)
    torch.cuda.synchronize()
    log(f"plain path: seconds/epoch={(time.perf_counter() - t0) / EPOCHS} "
        f"interactions={int(p_metrics.interactions.sum())}")
    assert not any(_build.LAUNCHES.values()), dict(_build.LAUNCHES)
    compare_paths(
        (reward / rand, n_clusters.tolist()),
        (float(p_metrics.reward.sum()) / float(p_metrics.rand_reward.sum()),
         p_clusters.tolist()), n)

    # ---- phase 5: kernels against plain versions at full width --------------
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    Minv, b, occ = state.lin.Minv, state.lin.b, state.lin.occ
    w = linucb.user_vector(Minv, b)
    ctx = ops.contexts_fn(SEED, EPOCHS * 2 * R, occ)
    errs = {"choose": check_choose(w, Minv, ctx, occ, hyper.alpha)}
    _, x = iops.choose(w, Minv, ctx, occ, hyper.alpha)
    r = (torch.rand(n, generator=g, device=dev) < 0.5).float()
    mask = 0 < state.u_rounds
    errs["rank1_update_inv"] = check_rank1(Minv, b, x, r, mask)
    cb = clustering.cb_width(occ)
    full = gref.init_packed_adj(n, n, device=dev)
    errs["prune"] = check_prune(full, w, cb, w, cb, hyper.gamma)
    log(f"full prune on the epoch's pruned graph: "
        f"{check_prune(state.graph.adj, w, cb, w, cb, hyper.gamma)}")
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    errs["cc_hop"] = check_cc_hop(state.graph.adj, ids, ids)
    log(f"full cc_hop on the labels: "
        f"{check_cc_hop(state.graph.adj, state.graph.labels, state.graph.labels)}")
    for kname, res in errs.items():
        log(f"full {kname}: {res}")

    # ---- phase 6: times ------------------------------------------------------
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    # both updates work in place: each gets its own copy to overwrite
    Minv_w, b_w = Minv.clone(), b.clone()
    Minv_p, b_p = Minv.clone(), b.clone()
    adj = state.graph.adj
    W = adj.shape[1]
    live = int(mask.sum())
    work = {
        "choose": (
            lambda: iops.choose(w, Minv, ctx, occ, hyper.alpha),
            lambda: iref.choose_ref(w, Minv, ctx, occ, hyper.alpha),
            4 * (n * K * d + n * d * d + n * d + n + n + n * d),
            n * K * (4 * d + 2 * d * d + 6)),
        "rank1_update_inv": (
            lambda: rops.rank1_update_inv(Minv_w, b_w, x, r, mask),
            lambda: rref.rank1_update_inv_ref(Minv_p, b_p, x, r, mask),
            live * 4 * (2 * d * d + 3 * d + 1) + n,
            live * (5 * d * d + 4 * d + 2)),
        "prune": (
            lambda: gops.prune_packed(full, w, cb, w, cb, hyper.gamma),
            lambda: gref.prune_packed_ref(full, w, cb, w, cb, hyper.gamma),
            2 * 4 * n * W + 2 * 4 * n * (d + 1),
            popcount(full) * (2 * d + 8)),
        "cc_hop": (
            lambda: gops.cc_hop_packed(adj, ids, ids),
            lambda: gref.cc_hop_packed_ref(adj, ids, ids),
            4 * (n * W + 3 * n),
            0),
    }
    rows = []
    for kname, (kern, plain, n_bytes, flops) in work.items():
        ms = cuda_ms(kern, flush)
        plain_ms = cuda_ms(plain, flush)
        bms, by = bound_ms(n_bytes, flops)
        source, replaces = KERNEL_INFO[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kname]["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "near_ties": errs[kname].get("near_ties", 0),
        })
        log(f"time {kname}: kernel {ms} ms, plain {plain_ms} ms, "
            f"bound {bms} ms ({by}; {n_bytes} bytes, {flops} f32 ops), "
            f"{math.ceil(ms / bms)}x the bound")
    torch.cuda.synchronize()

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
