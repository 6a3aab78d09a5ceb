"""Device dispatch for the DCN-v2 cross layer: the plain version for CPU
tensors, the CUDA kernels (``csrc/cross.cu``) for CUDA tensors.  The
inputs are not padded: the kernels mask ragged rows, columns and depth
(d = 429 at the published config).  The tensor route first splits W
into TF32 hi and lo tiles (``cross_split``, its own launch, counted as
such) into a buffer the wrapper allocates.

Gradients: where grad mode is on and an input requires grad, the call
goes through an autograd Function whose forward is the same dispatch
and whose backward is the layer's closed form in torch ops on either
device, with ``u = xl W^T + b`` recomputed: for the output's gradient g,
``h = g x0``, ``dx0 = g u``, ``dxl = h W + g``, ``dW = h^T xl``,
``db = sum_rows h`` (``repro`` differentiates ``cross_layer_ref``; it
has no backward kernel)."""
from __future__ import annotations

import math

import torch

from .. import _build
from .ref import cross_layer_ref

SIMT, TENSOR = 0, 1
TC_BM, TC_BN, TC_BK = 64, 144, 32   # csrc/cross.cu: the tensor route's tile
TC_BLOCKS_PER_SM = 2
MAX_GRID_Y = 65535                  # its row tiles, at most


def route(B: int, d: int, sms: int) -> int:
    """The kernel's route for ``B`` rows of width ``d`` on ``sms`` SMs:
    3xTF32 on the tensor cores where its 64 x 144 tiles fill every SM
    (two blocks an SM) at least once; else f32 SIMT, whose smaller tiles
    keep the SMs busy at small batch (serve_p99's B = 512 at d = 429 is
    24 tensor tiles against 264 block slots)."""
    rows = math.ceil(B / TC_BM)
    tiles = rows * math.ceil(d / TC_BN)
    if tiles >= TC_BLOCKS_PER_SM * sms and rows <= MAX_GRID_Y:
        return TENSOR
    return SIMT


def split_words(d: int) -> int:
    """int32 words of the W split the tensor route reads: hi and lo of
    each 144-row tile and 32-column stage (``kernels.cross.ref``
    ``cross_split_ref``)."""
    return math.ceil(d / TC_BN) * math.ceil(d / TC_BK) * 2 * TC_BN * TC_BK


def cross_layer(
    x0: torch.Tensor,     # [B, d] f32
    xl: torch.Tensor,     # [B, d] f32
    W: torch.Tensor,      # [d, d] f32, contracted on its dim 1
    bias: torch.Tensor,   # [d] f32
) -> torch.Tensor:
    """``x0 * (xl @ W.T + bias) + xl`` as a new [B, d] tensor; the
    inputs are left as they are."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x0, xl, W, bias)):
        return _Cross.apply(x0, xl, W, bias)
    return _forward(x0, xl, W, bias)


class _Cross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, xl, W, bias):
        ctx.save_for_backward(x0, xl, W, bias)
        return _forward(x0, xl, W, bias)

    @staticmethod
    def backward(ctx, g):
        x0, xl, W, bias = ctx.saved_tensors
        u = xl @ W.T + bias
        h = g * x0
        return g * u, h @ W + g, h.T @ xl, h.sum(dim=0)


def _forward(x0, xl, W, bias):
    """The kernels for CUDA tensors, the plain version for CPU ones."""
    dev = x0.device
    if dev.type == "cpu":
        return cross_layer_ref(x0, xl, W, bias)
    if dev.type != "cuda":
        raise ValueError(f"cross_layer runs on cpu or cuda, not {dev}")
    B, d = x0.shape
    args = [
        _build.check(x0, "x0", torch.float32, (B, d), dev),
        _build.check(xl, "xl", torch.float32, (B, d), dev),
        _build.check(W, "W", torch.float32, (d, d), dev),
        _build.check(bias, "bias", torch.float32, (d,), dev),
    ]
    out = torch.empty(B, d, dtype=torch.float32, device=dev)
    if B and d:
        r = route(B, d, _build.sm_count(dev.index or 0))
        split = None
        if r == TENSOR:
            split = torch.empty(split_words(d), dtype=torch.int32, device=dev)
            _build.launch("cross_split", args[2], d, split.data_ptr())
        _build.launch("cross", *args, out.data_ptr(), B, d, r,
                      0 if split is None else split.data_ptr())
    return out
