"""Device dispatch for the DCN-v2 cross layer: the plain version for CPU
tensors, the CUDA kernel (``csrc/cross.cu``) for CUDA tensors.  Nothing
is padded: the kernel masks ragged rows, columns and depth (d = 429 at
the published config)."""
from __future__ import annotations

import torch

from .. import _build
from .ref import cross_layer_ref


def cross_layer(
    x0: torch.Tensor,     # [B, d] f32
    xl: torch.Tensor,     # [B, d] f32
    W: torch.Tensor,      # [d, d] f32, contracted on its dim 1
    bias: torch.Tensor,   # [d] f32
) -> torch.Tensor:
    """``x0 * (xl @ W.T + bias) + xl`` as a new [B, d] tensor; the
    inputs are left as they are."""
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
        _build.launch("cross", *args, out.data_ptr(), B, d)
    return out
