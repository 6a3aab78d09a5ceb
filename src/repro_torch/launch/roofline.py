"""Roofline model of each cell on the H100 (``repro.launch.roofline``).

Three terms a (arch x shape x mesh), in seconds a step:

    compute    = FLOPs            / (cards x 989e12 bf16 FLOP/s)
    memory     = HBM bytes        / (cards x 3.35e12 B/s)
    collective = collective bytes / 50e9 B/s a card

The rates are ``launch.mesh``'s H100 constants, each with its source
there; the collective rate is a card's InfiniBand port, which bounds a
ring over ``repro``'s 16-wide "model" axis (two 8-card NVLink nodes).

The numerators are ``repro``'s analytic workload model, ported with its
arithmetic unchanged: exact matmul and byte counts from the config
(``ana_*``).  A dry-run record (``hlo_*`` and memory fields) comes from
the port's own dry run (``launch.dryrun``), whose records for every cell
on both production meshes are kept under ``results/dryrun_torch``.

MODEL_FLOPS = 6 N D (dense train) / 6 N_active D (MoE) / 2 N D (forward
only): the useful-compute yardstick; ana_flops / MODEL_FLOPS shows the
remat, attention and dispatch overhead.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

from . import mesh as mesh_lib
from .. import configs

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" \
    / "dryrun_torch"

PEAK = mesh_lib.PEAK_FLOPS_BF16
HBM = mesh_lib.HBM_BW
LINK = mesh_lib.LINK_BW


@dataclasses.dataclass
class Terms:
    arch: str
    shape: str
    mesh: str
    chips: int
    kind: str
    model_flops: float          # global, a step
    ana_flops: float            # global, a step
    ana_hbm_bytes: float        # global, a step
    ana_coll_bytes: float       # a card, a step
    hlo_flops: float            # a card, from the dry run
    hlo_bytes: float
    hlo_coll_bytes: float
    mem_args_gib: float
    mem_temp_gib: float

    @property
    def t_compute(self):
        return self.ana_flops / (self.chips * PEAK)

    @property
    def t_memory(self):
        return self.ana_hbm_bytes / (self.chips * HBM)

    @property
    def t_collective(self):
        return self.ana_coll_bytes / LINK

    @property
    def bottleneck(self):
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def roofline_fraction(self):
        """Useful-compute time over the bottleneck's (1.0: at the
        roofline)."""
        t_useful = self.model_flops / (self.chips * PEAK)
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_bound if t_bound else 0.0


# ---- analytic workload models ----------------------------------------------


def _lm_flops_bytes(cfg, shape: str, chips: int, multi_pod: bool):
    """(model_flops, ana_flops, hbm_bytes, coll_bytes a card) a step."""
    p_all = cfg.param_count()
    p_act = cfg.active_param_count()
    tp = 16
    dp = chips // tp

    def attn_flops(batch, s_q, s_kv):
        # scores + pv a layer
        return cfg.n_layers * batch * 2 * 2 * cfg.n_heads * s_q * s_kv \
            * cfg.d_head

    if shape == "train_4k":
        tokens = 256 * 4096
        mm = 6 * p_act * tokens                     # fwd + bwd matmuls
        remat = 2 * p_act * tokens                  # the forward once more
        att = 3 * attn_flops(256, 4096, 4096) / 2   # causal halves scores
        model = 6 * p_act * tokens
        ana = mm + remat + att * (1 + 0.5)          # attention recomputed
        # HBM: weights read a microbatch (gathered) + moments + acts
        w_bytes = 2 * p_all
        hbm = (cfg.microbatches * w_bytes
               + 3 * w_bytes
               + tokens * cfg.d_model * 2 * cfg.n_layers * 3)
        # a card's collectives: ZeRO weight gathers a microbatch, the
        # gradient reduce-scatter, TP
        coll = (cfg.microbatches * 2 * p_all / chips * 2
                + 2 * 2 * p_all / chips
                + tokens // dp * cfg.d_model * 2 * cfg.n_layers * 2 / 4)
        return model, ana, hbm, coll
    if shape == "prefill_32k":
        tokens = 32 * 32768
        model = 2 * p_act * tokens
        ana = model + attn_flops(32, 32768, 32768) / 2
        hbm = 2 * p_all + tokens * cfg.d_model * 2 * cfg.n_layers * 2
        coll = 2 * p_all / chips * 2 \
            + tokens // dp * cfg.d_model * 2 * cfg.n_layers / 2
        return model, ana, hbm, coll
    # decode shapes
    batch, s = (128, 32768) if shape == "decode_32k" else (1, 524288)
    model = 2 * p_act * batch
    ana = model + attn_flops(batch, 1, s)
    cache = cfg.n_layers * 2 * batch * cfg.n_kv_heads * s * cfg.d_head * 2
    hbm = 2 * p_all + cache
    coll = (batch * cfg.d_model * 2 * cfg.n_layers * 3    # TP gathers, psum
            + batch * cfg.n_heads * cfg.d_head * 4 * 16   # flash merge
            ) / min(chips, 256)
    return model, ana, hbm, coll


def _gnn_flops_bytes(cfg, shape, chips, dims):
    n, e, f, c = dims
    h = cfg.n_heads * cfg.d_hidden
    # layer 1: n f h matmul + edge ops; layer 2: n h (heads c)
    mm = 2 * n * f * h + 2 * n * h * cfg.n_heads * c
    edge = e * (cfg.n_heads * (2 * cfg.d_hidden + 6)
                + 2 * cfg.n_heads * cfg.d_hidden)
    model = mm + edge
    ana = 3 * model                                   # fwd + bwd
    hbm = 4 * (n * f + 2 * e + n * h) * 3
    # a card's all-gather of node features at both layers' widths, plus
    # the cotangent reduce-scatters
    widths = h + cfg.n_heads * c
    fwd_bytes = 1.02 if getattr(cfg, "quantized_gather", False) else 2
    coll = n * widths * fwd_bytes + n * widths * 4 / chips * 4
    return model, ana, hbm, coll


def _recsys_flops_bytes(spec, cfg, shape, chips):
    from ..configs import recsys_shapes as rs

    if spec.arch_id == "dcn-v2":
        d = cfg.d_interact
        per_row = 2 * (cfg.n_cross_layers * d * d
                       + 1024 * d + 1024 * 1024 + 1024 * 512 + (d + 512))
        emb_bytes_row = cfg.n_sparse * cfg.embed_dim * 4
        batch = {"train_batch": rs.TRAIN_B, "serve_p99": rs.P99_B,
                 "serve_bulk": rs.BULK_B,
                 "retrieval_cand": rs.N_CAND_RETR}[shape]
        mult = 3 if shape == "train_batch" else 1
        model = per_row * batch * mult
        hbm = batch * (emb_bytes_row + 52) * mult + 2 * 4 * (
            cfg.n_sparse * cfg.vocab_per_field * cfg.embed_dim) * (
            1 if shape == "train_batch" else 0) / 100   # ~1% of rows touched
        coll = batch * emb_bytes_row / chips * 2
        return model, model, hbm, coll
    # sequence models
    d = cfg.embed_dim
    L = cfg.seq_len
    blocks = getattr(cfg, "n_blocks", 2)
    per_user = blocks * (2 * L * (3 * d * d + d * d) + 2 * 2 * L * L * d
                         + 2 * L * 8 * d * d)
    if spec.arch_id == "mind":
        per_user = cfg.capsule_iters * 2 * L * cfg.n_interests * d \
            + 2 * L * d * d
    batch = {"train_batch": rs.TRAIN_B, "serve_p99": rs.P99_B,
             "serve_bulk": rs.BULK_B, "retrieval_cand": 1}[shape]
    cand = {"train_batch": 128, "serve_p99": rs.N_CAND_SERVE,
            "serve_bulk": rs.N_CAND_SERVE,
            "retrieval_cand": rs.N_CAND_RETR}[shape]
    score = 2 * batch * cand * d
    mult = 3 if shape == "train_batch" else 1
    model = (per_user * batch + score) * mult
    hbm = (batch * L * d * 4 * blocks * 3 + batch * cand * d * 4 / 8
           + score / 100) * mult
    coll = batch * cand * 4 / chips + batch * d * 4 / chips
    return model, model, hbm, coll


def _bandit_flops_bytes(hyper, chips):
    from ..configs import distclub_paper as dp

    n, d, K, R = dp.N_USERS, dp.D_FEAT, hyper.n_candidates, hyper.max_rounds
    per_i = 2 * K * d * d + 2 * K * d + 6 * d * d    # UCB + SM update
    inter = n * 2 * R * per_i
    stage2 = 2 * n * n * d + n * d ** 3              # prune + CC + inverses
    model = inter + stage2
    hbm = 2 * R * n * (3 * d * d * 4) + n * n * 1 + n * d * d * 4 * 4
    coll = (n * (d * d + d) * 4 * 2 + n * 4 * 10) / chips * 2
    return model, model, hbm, coll


def analyze(rec: dict) -> Terms:
    shape = rec["shape"]
    chips = 1
    for s in rec["mesh"]:
        chips *= s
    spec = configs.get(rec["arch"])
    cfg = spec.cell_cfg(shape)
    if spec.family == "bandit":
        model, ana, hbm, coll = _bandit_flops_bytes(cfg, chips)
    elif spec.family == "lm":
        model, ana, hbm, coll = _lm_flops_bytes(cfg, shape, chips,
                                                rec["multi_pod"])
    elif spec.family == "gnn":
        from ..configs.gat_cora import CELL_DIMS
        model, ana, hbm, coll = _gnn_flops_bytes(cfg, shape, chips,
                                                 CELL_DIMS[shape])
    else:
        model, ana, hbm, coll = _recsys_flops_bytes(spec, cfg, shape, chips)
    return Terms(
        arch=rec["arch"], shape=shape,
        mesh="x".join(str(s) for s in rec["mesh"]), chips=chips,
        kind=rec["kind"], model_flops=model, ana_flops=ana,
        ana_hbm_bytes=hbm, ana_coll_bytes=coll,
        hlo_flops=rec.get("flops_per_device") or 0.0,
        hlo_bytes=rec.get("bytes_per_device") or 0.0,
        hlo_coll_bytes=(rec.get("collective_bytes_per_device") or {}).get(
            "total", 0),
        mem_args_gib=(rec["memory"]["argument_bytes"] or 0) / 2 ** 30,
        mem_temp_gib=(rec["memory"]["temp_bytes"] or 0) / 2 ** 30,
    )


def load_all(tag: str = "pod1") -> list[Terms]:
    return [analyze(json.loads(p.read_text()))
            for p in sorted(RESULTS.glob(f"*__{tag}.json"))]


def table(terms: list[Terms]) -> str:
    hdr = ("| arch | shape | chips | compute s | memory s | coll s | "
           "bottleneck | MODEL_TF | useful/ana | roofline frac |")
    rows = [hdr, "|" + "---|" * 10]
    for t in terms:
        rows.append(
            f"| {t.arch} | {t.shape} | {t.chips} | {t.t_compute:.2e} | "
            f"{t.t_memory:.2e} | {t.t_collective:.2e} | {t.bottleneck} | "
            f"{t.model_flops/1e12:.1f} | "
            f"{t.model_flops/max(t.ana_flops,1):.2f} | "
            f"{t.roofline_fraction:.2f} |")
    return "\n".join(rows)


if __name__ == "__main__":
    for tag in ("pod1", "pod2"):
        ts = load_all(tag)
        if ts:
            print(f"\n== mesh {ts[0].mesh} ==\n")
            print(table(ts))
