"""Device dispatch for the fused choose: plain version for CPU tensors,
the CUDA kernel (``csrc/choose.cu``) for CUDA tensors."""
from __future__ import annotations

import torch

from .. import _build
from .ref import choose_ref


def choose(
    w: torch.Tensor,          # [n, d] f32
    Minv: torch.Tensor,       # [n, d, d] f32
    contexts: torch.Tensor,   # [n, K, d] f32
    occ: torch.Tensor,        # [n] i32
    alpha: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(choice [n] i32, x [n, d]); the first index wins a tie."""
    dev = contexts.device
    if dev.type == "cpu":
        return choose_ref(w, Minv, contexts, occ, alpha)
    if dev.type != "cuda":
        raise ValueError(f"choose runs on cpu or cuda, not {dev}")
    n, K, d = contexts.shape
    if K < 1 or d < 1:
        raise ValueError(f"choose needs K >= 1 and d >= 1, got {K=} {d=}")
    args = [
        _build.check(w, "w", torch.float32, (n, d), dev),
        _build.check(Minv, "Minv", torch.float32, (n, d, d), dev),
        _build.check(contexts, "contexts", torch.float32, (n, K, d), dev),
        _build.check(occ, "occ", torch.int32, (n,), dev),
    ]
    choice = torch.empty(n, dtype=torch.int32, device=dev)
    x = torch.empty(n, d, dtype=torch.float32, device=dev)
    if n:
        _build.launch("choose", *args, float(alpha), n, K, d,
                      choice.data_ptr(), x.data_ptr())
    return choice, x
