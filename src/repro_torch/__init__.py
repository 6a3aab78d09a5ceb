"""PyTorch / CUDA port of the DistCLUB bandit system.

Mirrors the layout of the JAX package ``repro`` (``core/``, ``runtime/``,
``kernels/<name>/{ref,ops}.py``, ``configs/``) so each module has an
obvious counterpart, but imports nothing from it: the port depends on
``torch`` and ``numpy`` only.

Device rule: entry points (``core.distclub.run``, ``init_state``, the
environment constructors) run on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit device they raise.  Below
the entry points the tensor's device decides: each kernel wrapper in
``kernels/*/ops.py`` runs its plain PyTorch version for CPU tensors and
launches its hand-written CUDA kernel (``csrc/``) for CUDA tensors.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; never a silent CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    return torch.device("cuda")
