"""Device dispatch for the M-free rank-1 update: plain version for CPU
tensors, the CUDA kernel (``csrc/rank1.cu``) for CUDA tensors."""
from __future__ import annotations

import torch

from .. import _build
from .ref import rank1_update_inv_ref


def rank1_update_inv(
    Minv: torch.Tensor,   # [n, d, d] f32
    b: torch.Tensor,      # [n, d] f32
    x: torch.Tensor,      # [n, d] f32
    r: torch.Tensor,      # [n] f32
    mask: torch.Tensor,   # [n] bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Minv', b') after one masked interaction per user.

    On either device ``Minv`` and ``b`` are updated IN PLACE (by the
    kernel on CUDA, by the plain version on the CPU) and returned.
    """
    dev = Minv.device
    if dev.type == "cpu":
        return rank1_update_inv_ref(Minv, b, x, r, mask)
    if dev.type != "cuda":
        raise ValueError(f"rank1_update_inv runs on cpu or cuda, not {dev}")
    n, d = b.shape
    args = [
        _build.check(Minv, "Minv", torch.float32, (n, d, d), dev),
        _build.check(b, "b", torch.float32, (n, d), dev),
        _build.check(x, "x", torch.float32, (n, d), dev),
        _build.check(r, "r", torch.float32, (n,), dev),
        _build.check(mask, "mask", torch.bool, (n,), dev),
    ]
    if n:
        _build.launch("rank1_update_inv", *args, n, d)
    return Minv, b
