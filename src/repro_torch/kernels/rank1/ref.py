"""Plain PyTorch versions of the fused rank-1 updates (``csrc/rank1.cu``):
the M-free one of DistCLUB's rounds and the M-ful one of CLUB."""
from __future__ import annotations

import torch


def rank1_update_ref(
    M: torch.Tensor,      # [n, d, d]
    Minv: torch.Tensor,   # [n, d, d]
    b: torch.Tensor,      # [n, d]
    x: torch.Tensor,      # [n, d]
    r: torch.Tensor,      # [n]
    mask: torch.Tensor,   # [n] bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(M', Minv', b') after one masked interaction per user.

    ``M' = M + (m x)(m x)^T``, Minv' its Sherman-Morrison inverse and
    ``b' = b + r m x``; a masked-out user (m = 0) is an identity update.
    ``M``, ``Minv`` and ``b`` are updated IN PLACE and returned, as the
    kernel does, so both devices share one aliasing contract.

    ``Minv`` may be bf16 (``Precision.state_dtype``; ``M`` and ``b`` stay
    f32): it is widened once, the math runs in f32 as for an f32
    ``Minv``, and the result is rounded back to nearest even, as
    :func:`rank1_update_inv_ref` does.
    """
    m = mask.to(x.dtype)
    xm = x * m[:, None]
    M32 = Minv if Minv.dtype == torch.float32 else Minv.float()
    Mx = torch.einsum("nij,nj->ni", M32, xm)
    denom = 1.0 + torch.einsum("ni,ni->n", xm, Mx)
    M32.sub_((Mx[:, :, None] * Mx[:, None, :]) / denom[:, None, None])
    if M32 is not Minv:
        Minv.copy_(M32)
    M.add_(xm[:, :, None] * xm[:, None, :])
    b.add_((r * m)[:, None] * x)
    return M, Minv, b


def rank1_update_inv_ref(
    Minv: torch.Tensor,   # [n, d, d]
    b: torch.Tensor,      # [n, d]
    x: torch.Tensor,      # [n, d]
    r: torch.Tensor,      # [n]
    mask: torch.Tensor,   # [n] bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Minv', b') after one masked interaction per user.

    Minv' is the Sherman-Morrison inverse of ``M + (m x)(m x)^T`` and
    ``b' = b + r m x``; a masked-out user (m = 0) is an identity update.
    ``Minv`` and ``b`` are updated IN PLACE and returned, as the kernel
    does, so both devices share one aliasing contract.

    ``Minv`` may be bf16 (``Precision.state_dtype``): it is upcast once,
    the math runs in f32 in the f32 version's order, and the result is
    rounded back to nearest even, as ``repro``'s ``astype`` does.  A
    masked-out row comes back bit-identical (``x - 0`` is ``x``).
    """
    m = mask.to(x.dtype)
    xm = x * m[:, None]
    M32 = Minv if Minv.dtype == torch.float32 else Minv.float()
    Mx = torch.einsum("nij,nj->ni", M32, xm)
    denom = 1.0 + torch.einsum("ni,ni->n", xm, Mx)
    M32.sub_((Mx[:, :, None] * Mx[:, None, :]) / denom[:, None, None])
    if M32 is not Minv:
        Minv.copy_(M32)
    b.add_((r * m)[:, None] * x)
    return Minv, b
