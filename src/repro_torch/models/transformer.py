"""Decoder-only transformer LM, dense and MoE, with KV-cache decode
(``repro.models.transformer``).

Parameters keep ``repro``'s tree: ``embed`` [V, d], ``blocks.l{i}.*``
with every leaf stacked on a leading [n_blocks] axis (``ln1.scale``,
``attn.{wq,wk,wv,wo}``, ``attn.{q,k}_norm.scale`` under qk-norm,
``ln2.scale``, ``ffn.{gate,up,down}``), ``final_norm.scale``, ``lm_head``
[d, V].  A MoE config's block is ``moe_every`` layers, the last of which
has ``moe.{router,experts.{gate,up,down},shared.*}`` (``models.moe``) in
place of ``ffn``, so its expert leaves are [n_blocks, E, ...].
``repro`` scans over the blocks; here a Python loop walks them through
per-layer views of the stacked parameters.

``lm_specs`` gives the tree's partition specs, as ``repro``'s (the
sharded decode, ``distributed.decode_shard``, reads them), and
``param_shapes`` its leaves' shapes and dtypes without allocating them.

Serving: ``lm_fwd``, ``lm_prefill`` (the prompt pass that fills the
cache), ``init_cache`` and ``lm_decode_step``.  Training: ``lm_loss``,
on a model whose parameters were turned on with ``requires_grad_(True)``;
with ``cfg.remat`` each block is recomputed in the backward pass
(``torch.utils.checkpoint``), as ``repro``'s ``jax.checkpoint`` does,
its collectives with it.  Attention runs the flash kernel on the card
(``models.attention``; its backward is that of ``chunked_attention``).
Where ``repro`` takes a traced scalar position, ``pos`` is a host int
here; the cache is written in place.

``lm_fwd``, ``lm_loss`` and ``lm_prefill`` also run as one rank of a
tensor-parallel mesh (``ax``, ``distributed.spmd.Axes``): the body of
the LM train and prefill cells (``launch.steps``), on a model holding the
rank's shards (``LM.of``).  The embedding's rows are split over "model"
(each rank looks up the ids it holds, the rows summed over "model"), the
head's columns too (a vocab-parallel cross-entropy: max, sum of
exponentials and the label's logit reduced over "model"); attention and
the MoE layer split as ``models.attention`` and ``models.moe`` say, the
FFN's SwiGLU by columns then rows.  A rank's loss is its tokens' sum
over the whole (micro)batch's, so the shares, and their gradients, sum to
the global mean's; the batch's rows need not divide over the batch
ranks (DTensor's uneven split).  On one rank every collective is the
identity.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from .. import resolve_device
from ..distributed import spmd
from ..distributed.sharding import P
from . import attention, layers, moe


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    qk_norm: bool = False
    rope_base: float = 10000.0
    # MoE (n_experts=0 -> dense)
    n_experts: int = 0
    top_k: int = 1
    n_shared: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1          # MoE on every k-th layer (llama4: 2)
    dtype: torch.dtype = torch.bfloat16
    attn_chunk: int = 1024
    remat: bool = True
    microbatches: int = 1       # grad-accumulation splits of the global batch

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def block_layers(self) -> int:
        """Layers per block (dense layers + optional trailing MoE)."""
        return self.moe_every if self.is_moe else 1

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % self.block_layers == 0
        return self.n_layers // self.block_layers

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, Dh = self.d_model, self.d_head
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * Dh \
            + self.n_heads * Dh * d
        dense_ffn = 3 * d * self.d_ff
        n_moe = self.n_layers // self.moe_every if self.is_moe else 0
        n_dense = self.n_layers - n_moe
        moe_ffn = n_moe * (
            self.n_experts * 3 * d * self.d_ff_expert
            + self.n_shared * 3 * d * self.d_ff_expert
            + d * self.n_experts
        )
        return (self.vocab * d * 2 + self.n_layers * attn
                + n_dense * dense_ffn + moe_ffn)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        n_moe = self.n_layers // self.moe_every
        all_experts = n_moe * self.n_experts * 3 * d * self.d_ff_expert
        active = n_moe * (self.top_k + self.n_shared) * 3 * d \
            * self.d_ff_expert
        return self.param_count() - all_experts + active


# --- single layer ------------------------------------------------------------


def _init_layer(gen: torch.Generator, cfg: LMConfig,
                is_moe_layer: bool) -> dict:
    dev = gen.device
    p = {"ln1": layers.init_rms_norm(cfg.d_model, dev),
         "attn": attention.init_attention(gen, cfg, cfg.dtype),
         "ln2": layers.init_rms_norm(cfg.d_model, dev)}
    if is_moe_layer:
        p["moe"] = moe.init_moe(gen, cfg, cfg.dtype)
    else:
        p["ffn"] = layers.init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.dtype)
    return p


def _is_moe_layer(cfg: LMConfig, i: int) -> bool:
    """Whether layer ``i`` of a block is its MoE layer (the last)."""
    return cfg.is_moe and i == cfg.block_layers - 1


def _layer_fwd(p, cfg: LMConfig, x, *, positions, cache=None, cache_pos=0,
               is_moe_layer=False, ax=spmd.ONE_RANK, rows=None,
               prompt_kv=False):
    """One layer; ``p`` a mapping of one layer's parameters.  Returns
    ``(x, cache, aux)``, aux an f32 scalar (0 for a dense layer); with
    ``prompt_kv`` the layer's ``(k, v)`` in the cache's place
    (``attention.attention_fwd``)."""
    h, cache = attention.attention_fwd(
        p["attn"], cfg, layers.rms_norm(x, p["ln1"]["scale"]).to(x.dtype),
        positions=positions, cache=cache, cache_pos=cache_pos,
        attn_chunk=cfg.attn_chunk, ax=ax, prompt_kv=prompt_kv)
    x = x + h
    z = layers.rms_norm(x, p["ln2"]["scale"]).to(x.dtype)
    if is_moe_layer:
        h, aux = moe.moe_fwd(p["moe"], cfg, z, ax, rows)
    else:
        h = spmd.leave(layers.swiglu(p["ffn"], spmd.enter(z, ax.model)),
                       ax.model)
        aux = torch.zeros((), device=x.device)
    return x + h, cache, aux


def _layer_specs(cfg: LMConfig, is_moe_layer: bool) -> dict:
    p = {"ln1": layers.rms_norm_specs(),
         "attn": attention.attention_specs(cfg),
         "ln2": layers.rms_norm_specs()}
    if is_moe_layer:
        p["moe"] = moe.moe_specs(cfg)
    else:
        p["ffn"] = layers.swiglu_specs()
    return p


# --- full model --------------------------------------------------------------


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_set(dst, i: int, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _tree_set(dst[k], i, src[k])
    else:
        dst[i] = src


def init_lm(gen: torch.Generator, cfg: LMConfig) -> dict:
    """The parameter tree, drawn on the generator's device: the embedding,
    then block by block (each drawn, then copied into its slot of the
    stacked leaves, so the stack never exists twice; a single block is
    the stack, as a view), then the head."""
    dev = gen.device
    embed = (torch.randn(cfg.vocab, cfg.d_model, generator=gen, device=dev)
             * 0.02).to(cfg.dtype)

    def init_block():
        return {f"l{i}": _init_layer(gen, cfg, _is_moe_layer(cfg, i))
                for i in range(cfg.block_layers)}

    first = init_block()
    if cfg.n_blocks == 1:
        blocks = _tree_map(lambda t: t[None], first)
    else:
        blocks = _tree_map(lambda t: torch.empty((cfg.n_blocks, *t.shape),
                                                 dtype=t.dtype, device=dev),
                           first)
        _tree_set(blocks, 0, first)
    del first
    for i in range(1, cfg.n_blocks):
        _tree_set(blocks, i, init_block())
    return {"embed": embed, "blocks": blocks,
            "final_norm": layers.init_rms_norm(cfg.d_model, dev),
            "lm_head": layers.dense_init(gen, cfg.d_model, cfg.vocab,
                                         cfg.dtype)}


def lm_specs(cfg: LMConfig) -> dict:
    """The parameter tree's partition specs (training layout): each block
    leaf gains a replicated leading [n_blocks] dim; the embedding rows
    and the head's columns are split over "model" (vocab-sharded)."""
    def add_layer_dim(tree):
        if isinstance(tree, P):
            return P(None, *tree)
        return {k: add_layer_dim(v) for k, v in tree.items()}

    blocks = {f"l{i}": add_layer_dim(_layer_specs(cfg, _is_moe_layer(cfg, i)))
              for i in range(cfg.block_layers)}
    return {"embed": P("model", None), "blocks": blocks,
            "final_norm": layers.rms_norm_specs(),
            "lm_head": P(None, "model")}


def param_shapes(cfg: LMConfig) -> dict:
    """The parameter tree as ``(shape, dtype)`` leaves, allocating
    nothing (``repro`` takes ``jax.eval_shape`` of ``init_lm``)."""
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    nb, f32, dt = cfg.n_blocks, torch.float32, cfg.dtype

    def norm(n):
        return {"scale": ((nb, n), f32)}

    def swiglu(f):
        return {"gate": ((nb, d, f), dt), "up": ((nb, d, f), dt),
                "down": ((nb, f, d), dt)}

    def layer(is_moe_layer):
        attn = {"wq": ((nb, d, H * Dh), dt), "wk": ((nb, d, Hkv * Dh), dt),
                "wv": ((nb, d, Hkv * Dh), dt), "wo": ((nb, H * Dh, d), dt)}
        if cfg.qk_norm:
            attn["q_norm"], attn["k_norm"] = norm(Dh), norm(Dh)
        p = {"ln1": norm(d), "attn": attn, "ln2": norm(d)}
        if not is_moe_layer:
            p["ffn"] = swiglu(cfg.d_ff)
            return p
        E, fe = cfg.n_experts, cfg.d_ff_expert
        p["moe"] = {"router": ((nb, d, E), f32),
                    "experts": {"gate": ((nb, E, d, fe), dt),
                                "up": ((nb, E, d, fe), dt),
                                "down": ((nb, E, fe, d), dt)}}
        if cfg.n_shared > 0:
            p["moe"]["shared"] = swiglu(fe * cfg.n_shared)
        return p

    return {"embed": ((cfg.vocab, d), dt),
            "blocks": {f"l{i}": layer(_is_moe_layer(cfg, i))
                       for i in range(cfg.block_layers)},
            "final_norm": {"scale": ((d,), f32)},
            "lm_head": ((d, cfg.vocab), dt)}


def _views(module, n: int) -> list[dict]:
    """The stacked parameters of ``module`` as ``n`` nested dicts of views,
    one a block, made by one ``unbind`` a leaf: its backward stacks the
    blocks' gradients once, where indexing each block would build a
    leaf-sized gradient a block and sum them."""
    leaves = {name: p.unbind(0) for name, p in module._parameters.items()}
    kids = {name: _views(m, n) for name, m in module._modules.items()}
    return [{**{k: v[b] for k, v in leaves.items()},
             **{k: v[b] for k, v in kids.items()}} for b in range(n)]


class LM(layers.Params):
    """A decoder LM (dense or MoE) with random weights from ``seed``, on
    ``device`` (default cuda; raises without a card unless
    ``device="cpu"``)."""

    _layer_views = None

    def __init__(self, cfg: LMConfig, *, seed: int = 0, device=None):
        dev = resolve_device(device)
        super().__init__(init_lm(
            torch.Generator(device=dev).manual_seed(seed), cfg))
        self.cfg = cfg

    @classmethod
    def of(cls, cfg: LMConfig, tree: dict) -> "LM":
        """A model holding ``tree``'s tensors, drawing nothing: a rank's
        shards in a cell (``launch.steps``)."""
        model = cls.__new__(cls)
        layers.Params.__init__(model, tree)
        model.cfg = cfg
        return model

    def _apply(self, fn, *args, **kwargs):
        self._layer_views = None      # .to() makes new parameters
        return super()._apply(fn, *args, **kwargs)

    def layer_params(self) -> list[list[dict]]:
        """[block][layer in block] -> that layer's parameters, as views
        into the stacked leaves.  Where a gradient may be taken (grad
        mode on and a block leaf requiring grad) the views are made anew
        on each call, so that autograd reaches the stacked leaves through
        them: a view made before ``requires_grad_(True)`` would report
        ``requires_grad`` and pass no gradient back.  Otherwise they are
        made once and kept."""
        if self.wants_grad():
            return self._make_views()
        if self._layer_views is None:
            self._layer_views = self._make_views()
        return self._layer_views

    def wants_grad(self) -> bool:
        """Whether a forward pass now may be differentiated: grad mode on
        and a block leaf requiring grad."""
        return torch.is_grad_enabled() and any(
            p.requires_grad for p in self.blocks.parameters())

    def _make_views(self) -> list[list[dict]]:
        per_layer = [_views(getattr(self.blocks, f"l{i}"), self.cfg.n_blocks)
                     for i in range(self.cfg.block_layers)]
        return [[views[b] for views in per_layer]
                for b in range(self.cfg.n_blocks)]


def _embed(table, ids, ax: spmd.Axes):
    """Rows of ``table`` for ``ids``; on a rank of ``ax`` the table is its
    vocab rows [V / model, d] and the rows are summed over "model"."""
    if ax.m == 1:
        return table[ids]
    vl = table.shape[0]
    local = ids.long() - ax.r * vl
    ok = (local >= 0) & (local < vl)
    rows = table[local.clamp(0, vl - 1)]
    return spmd.leave(rows.masked_fill(~ok[..., None], 0), ax.model)


def _head(model: LM, x, ax: spmd.Axes):
    """The logits (on a rank of ``ax``, its vocab columns)."""
    x = layers.rms_norm(x, model.final_norm.scale).to(x.dtype)
    return spmd.enter(x, ax.model) @ model.lm_head


def lm_fwd(model: LM, tokens: torch.Tensor, ax: spmd.Axes = spmd.ONE_RANK,
           rows: int | None = None):
    """tokens [B, S] -> (logits [B, S, V] in the model's dtype, the MoE
    layers' aux losses summed, an f32 scalar: 0 for a dense model).  On a
    rank of ``ax``: its rows of a batch of ``rows`` rows, its vocab
    columns of the logits."""
    cfg = model.cfg
    x = _embed(model.embed, tokens, ax)
    positions = torch.arange(tokens.shape[1], device=x.device)

    def block_fwd(x, block):
        aux = torch.zeros((), device=x.device)
        for i, p in enumerate(block):
            x, _, a = _layer_fwd(p, cfg, x, positions=positions,
                                 is_moe_layer=_is_moe_layer(cfg, i), ax=ax,
                                 rows=rows)
            aux = aux + a
        return x, aux

    remat = cfg.remat and model.wants_grad()
    aux = torch.zeros((), device=x.device)
    for block in model.layer_params():
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(block_fwd, x, block,
                                                     use_reentrant=False)
        else:
            x, a = block_fwd(x, block)
        aux = aux + a
    return _head(model, x, ax), aux


def _token_nll(logits, labels, ax: spmd.Axes):
    """Per-token log-sum-exp of the f32 logits less the label's logit;
    on a rank of ``ax``, over the vocab split over "model"."""
    lf = logits.float()
    if ax.m == 1:
        lse = torch.logsumexp(lf, dim=-1)
        return lse - torch.gather(lf, -1, labels[..., None].long())[..., 0]
    mx = spmd.pmax(lf.detach().amax(dim=-1), ax.model)
    se = spmd.leave(torch.exp(lf - mx[..., None]).sum(dim=-1), ax.model)
    lse = torch.log(se) + mx
    vl = lf.shape[-1]
    local = labels.long() - ax.r * vl
    ok = (local >= 0) & (local < vl)
    ll = torch.gather(lf, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    return lse - spmd.leave(ll * ok, ax.model)


def lm_loss(model: LM, tokens: torch.Tensor, labels: torch.Tensor,
            ax: spmd.Axes = spmd.ONE_RANK, rows: int | None = None):
    """Mean next-token cross-entropy of the f32 logits (log-sum-exp less
    the label's logit) plus 0.01 x the aux loss, as ``repro``'s.  On a
    rank of ``ax``, ``tokens``/``labels`` [B_loc, S] are its rows of a
    (micro)batch of ``rows`` rows and the value is its share: its
    tokens' sum over all the batch's tokens, plus the aux term over the
    batch ranks."""
    B, S = tokens.shape
    rows = B if rows is None else rows
    logits, aux = lm_fwd(model, tokens, ax, rows)
    nll = _token_nll(logits, labels, ax)
    return nll.sum() / (rows * S) + 0.01 * aux / ax.nb


def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None):
    """Zero (k, v) caches [n_blocks, block_layers, batch, Hkv, max_len,
    Dh] in the config's dtype, on ``device`` (default cuda; raises without
    a card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    shape = (cfg.n_blocks, cfg.block_layers, batch, cfg.n_kv_heads,
             max_len, cfg.d_head)
    return (torch.zeros(shape, dtype=cfg.dtype, device=dev),
            torch.zeros(shape, dtype=cfg.dtype, device=dev))


def lm_prefill(model: LM, tokens: torch.Tensor,
               ax: spmd.Axes = spmd.ONE_RANK, rows: int | None = None):
    """Prompt pass that also builds the KV cache: tokens [B, S] ->
    (last-position logits [B, V], cache ([nb, bl, B, Hkv, S, Dh] k, same
    v)).  Attention runs as through a cache of the prompt's length (so
    with ``kv_len = S``), as ``repro``'s does.  On a rank of ``ax``: its
    rows of a batch of ``rows`` rows, its vocab columns of the logits
    and its ``S / model`` positions of the caches (every kv head)."""
    cfg = model.cfg
    B, S = tokens.shape
    x = _embed(model.embed, tokens, ax)
    positions = torch.arange(S, device=x.device)
    sl = S // ax.m
    shape = (cfg.n_blocks, cfg.block_layers, B, cfg.n_kv_heads, sl,
             cfg.d_head)
    kc = torch.empty(shape, dtype=cfg.dtype, device=x.device)
    vc = torch.empty(shape, dtype=cfg.dtype, device=x.device)
    for b, block in enumerate(model.layer_params()):
        for i, p in enumerate(block):
            x, (k, v), _ = _layer_fwd(p, cfg, x, positions=positions,
                                      is_moe_layer=_is_moe_layer(cfg, i),
                                      ax=ax, rows=rows, prompt_kv=True)
            kc[b, i] = k[:, :, ax.r * sl:(ax.r + 1) * sl]
            vc[b, i] = v[:, :, ax.r * sl:(ax.r + 1) * sl]
    return _head(model, x[:, -1:], ax)[:, 0], (kc, vc)


def lm_decode_step(model: LM, token: torch.Tensor, cache, pos: int):
    """One decode step: token [B] at position ``pos`` (a host int) against
    ``cache`` as ``init_cache`` lays it out, which is written in place.
    Returns (logits [B, V], cache)."""
    cfg = model.cfg
    x = model.embed[token][:, None, :]                  # [B, 1, d]
    positions = torch.arange(pos, pos + 1, device=x.device)
    kc, vc = cache
    for b, block in enumerate(model.layer_params()):
        for i, p in enumerate(block):
            x, _, _ = _layer_fwd(p, cfg, x, positions=positions,
                                 cache=(kc[b, i], vc[b, i]), cache_pos=pos,
                                 is_moe_layer=_is_moe_layer(cfg, i))
    return _head(model, x, spmd.ONE_RANK)[:, 0], (kc, vc)
