"""Plain PyTorch version of the DCN-v2 cross layer (``csrc/cross.cu``)."""
from __future__ import annotations

import torch


def cross_layer_ref(
    x0: torch.Tensor,     # [B, d] base features
    xl: torch.Tensor,     # [B, d] current layer input
    W: torch.Tensor,      # [d, d]
    bias: torch.Tensor,   # [d]
) -> torch.Tensor:
    """x_{l+1} = x0 * (xl W^T + bias) + xl   (DCN-v2, arXiv:2008.13535)."""
    return x0 * (xl @ W.T + bias) + xl
