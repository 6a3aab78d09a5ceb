"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Libraries land in ``build/kernels/`` at the root
of the checkout, named by a hash of their source and of the shared
``csrc/*.cuh`` headers, so an edited kernel is never served stale; they
are built at first use, and ``build_all`` starts one ``nvcc`` per source
at once.

Each build keeps the compiler's ``-Xptxas -v`` report beside its library
(``<library>.log``); ``ptxas_usage`` reads registers and spills from it.

``LAUNCHES`` counts launches per kernel: each wrapper in
``kernels/*/ops.py`` adds one where it launches its kernel and nowhere
else, so a run can show which kernels its path went through.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the (Minv, items) name parts of the top-K filter kernels: bf16 and int8
# items with Minv f32 or bf16, f32 items with Minv bf16
_TC_KINDS = [(m, i) for m in ("", "_minv_bf16") for i in ("_bf16", "_int8")
             ] + [("_minv_bf16", "")]
# kernel name -> (source, C entry point, argtypes)
KERNELS = {
    "choose": ("choose.cu", "choose_launch",
               [_P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P]),
    "choose_bf16": ("choose.cu", "choose_bf16_launch",
                    [_P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P]),
    # the tensor-core filter on a bf16 Minv (d <= 32, K <= 64): the grid
    # before the outputs, fstats after them
    "choose_bf16_tc": ("choose_tc.cu", "choose_bf16_tc_launch",
                       [_P, _P, _P, _P, _F, _I, _I, _I, _I, _P, _P, _P]),
    "rank1_update_inv": ("rank1.cu", "rank1_update_inv_launch",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "rank1_update_inv_bf16": ("rank1.cu", "rank1_update_inv_bf16_launch",
                              [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "rank1_update": ("rank1.cu", "rank1_update_launch",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "rank1_update_bf16": ("rank1.cu", "rank1_update_bf16_launch",
                          [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "ucb": ("ucb.cu", "ucb_launch",
            [_P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P]),
    "ucb_bf16": ("ucb.cu", "ucb_bf16_launch",
                 [_P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P]),
    "prune": ("prune.cu", "prune_launch",
              [_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P]),
    "cc_hop": ("cc_hop.cu", "cc_hop_launch",
               [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]),
    "cc_hop_warp": ("cc_hop.cu", "cc_hop_warp_launch",
                    [_P, _P, _P, _I, _I, _I, _P, _P]),
    "topk": ("topk.cu", "topk_launch",
             [_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P, _P,
              _P]),
    "topk_bf16": ("topk.cu", "topk_bf16_launch",
                  [_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P,
                   _P, _P]),
    "topk_int8": ("topk.cu", "topk_int8_launch",
                  [_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P,
                   _P, _P, _P]),
    "topk_pruned": ("topk.cu", "topk_pruned_launch",
                    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I,
                     _I, _I, _I, _P, _P, _P, _P, _P, _P]),
    "topk_pruned_bf16": ("topk.cu", "topk_pruned_bf16_launch",
                         [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I,
                          _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]),
    "topk_pruned_int8": ("topk.cu", "topk_pruned_int8_launch",
                         [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I,
                          _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]),
    "topk_minv_bf16": ("topk.cu", "topk_minv_bf16_launch",
                       [_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P,
                        _P, _P, _P]),
    "topk_minv_bf16_bf16": ("topk.cu", "topk_minv_bf16_bf16_launch",
                            [_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P,
                             _P, _P, _P, _P]),
    "topk_minv_bf16_int8": ("topk.cu", "topk_minv_bf16_int8_launch",
                            [_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I,
                             _P, _P, _P, _P, _P]),
    "topk_pruned_minv_bf16": (
        "topk.cu", "topk_pruned_minv_bf16_launch",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I,
         _P, _P, _P, _P, _P, _P]),
    "topk_pruned_minv_bf16_bf16": (
        "topk.cu", "topk_pruned_minv_bf16_bf16_launch",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I,
         _P, _P, _P, _P, _P, _P]),
    "topk_pruned_minv_bf16_int8": (
        "topk.cu", "topk_pruned_minv_bf16_int8_launch",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I,
         _I, _P, _P, _P, _P, _P, _P]),
    # the tensor-core filter kernels (bf16 and int8 items, and f32 items
    # with a bf16 Minv, d <= 32): the chain kernels' arguments, then
    # fstats before the stream
    **{f"topk{m}{i}_tc": ("topk_tc.cu", f"topk{m}{i}_tc_launch",
                          [_P, _P, _P, _P, _P] + [_P] * (i == "_int8")
                          + [_F, _I, _I, _I, _I, _I] + [_P] * 6)
       for m, i in _TC_KINDS},
    **{f"topk_pruned{m}{i}_tc": (
        "topk_tc.cu", f"topk_pruned{m}{i}_tc_launch",
        [_P] * (10 + (i == "_int8")) + [_F, _I, _I, _I, _I, _I, _I]
        + [_P] * 7)
       for m, i in _TC_KINDS},
    "cross": ("cross.cu", "cross_launch",
              [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P]),
    "cross_split": ("cross.cu", "cross_split_launch", [_P, _I, _P, _P]),
    "embedding_bag": ("embag.cu", "embedding_bag_launch",
                      [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "flash": ("flash.cu", "flash_launch",
              [_P, _P, _P, _P, _P, ctypes.c_size_t, _I, _I, _I, _I, _I, _I,
               _I, _I, _I, _I, _I, _F, _P]),
}

LAUNCHES = {name: 0 for name in KERNELS}

# the card's shared memory, as the kernels' launch plans count it
MAX_SMEM = 232448                # a block's at most: csrc/stage.cuh kMaxSmem
SM_SMEM = 233472                 # an H100 SM's
BLOCK_RESERVED = 1024            # what the card keeps for each block

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def library_path(source: str, csrc: Path = CSRC) -> Path:
    """The source's library, named by a hash of the source and of every
    shared header in ``csrc`` (a source may include any of them); ``csrc``
    another checkout's sources, to compare a kernel with its earlier
    version."""
    h = hashlib.sha256((csrc / source).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}_{digest}.so"


def build_all(names=None, csrc: Path = CSRC) -> dict[str, str]:
    """Compile every (or the named) kernel that is not built yet, one
    ``nvcc`` per source (kernels that share a source share its build),
    all started together.  Returns ``{name: ptxas report}`` for the
    sources compiled by this call; raises with the compiler's output if
    any build fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    sources = set()
    for name in names:
        source = KERNELS[name][0]
        out = library_path(source, csrc)
        if out.exists() or source in sources:
            continue
        sources.add(source)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def ptxas_usage(report: str) -> dict[str, tuple[int, int, int]]:
    """``{mangled kernel: (registers, spill store bytes, spill load
    bytes)}`` from an ``nvcc -Xptxas -v`` report."""
    usage, func, spill = {}, None, (0, 0)
    for line in report.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            func, spill = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and func:
            usage[func] = (int(m.group(1)), *spill)
            func = None
    return usage


def build_report(name: str, csrc: Path = CSRC) -> str:
    """The ptxas report kept from the build of the kernel's library."""
    return library_path(KERNELS[name][0], csrc).with_suffix(
        ".log").read_text()


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The kernel's library, built on first use, with argtypes set."""
    lib = _loaded.get((name, csrc))
    if lib is None:
        source, entry, argtypes = KERNELS[name]
        path = library_path(source, csrc)
        if not path.exists():
            build_all([name], csrc)
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[(name, csrc)] = lib
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(t, name: str, dtype, shape: tuple, device) -> int:
    """Validate a tensor handed to a kernel; return its data pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def minv_kernel(kernels: dict, Minv, op: str) -> str:
    """The kernel of ``kernels`` (``{Minv dtype: name}``) for ``Minv``'s
    dtype; ``TypeError`` for a dtype no kernel takes."""
    name = kernels.get(Minv.dtype)
    if name is None:
        raise TypeError(f"Minv has dtype {Minv.dtype}; {op} takes "
                        f"{list(kernels)}")
    return name


def launch(name: str, *args) -> None:
    """Call the kernel's C launcher on the current stream; raise if the
    launch was refused, count it otherwise."""
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(load(name), KERNELS[name][1])
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
