"""Fault-tolerant checkpointing: atomic, keep-K
(``repro.train.checkpoint``).

  * A state tree (dicts, NamedTuples, tuples and lists of tensors, numpy
    arrays and Python numbers) is saved as numpy arrays keyed by their
    paths in the tree (``arrays.npz``) plus a JSON manifest: a magic
    string, the step, and each array's key, shape and dtype.  numpy has
    no bfloat16, so a bf16 tensor is stored as its ``uint16`` bits and the
    manifest keeps ``bfloat16``.  Nothing of the device is stored:
    ``restore`` puts each tensor on the device of the ``like`` tree's
    leaf.
  * Writes go to ``<dir>/tmp-<step>`` and are then ``os.replace``d into
    ``step-<step>``: a crashed writer never corrupts a finished
    checkpoint.
  * The newest ``keep`` checkpoints are kept; ``latest_step`` scans the
    directory, so a restarted job calls ``restore_latest``.
  * ``restore_latest`` skips a checkpoint that fails to load (truncated
    arrays, a malformed or wrong-magic manifest, missing keys) with a
    warning and restores the next-newest; it raises only when none
    loads.
  * Ranks: ``save(..., col=)`` on the ranks of a sharded job (each
    holding the same global tree) writes from rank 0 alone, then waits
    on a psum of one scalar, so that no rank reads before the rename.
    No rank layout is stored: a tree saved by any number of ranks is the
    tree one process would save, and a restoring job slices it as it
    likes.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import warnings
import zipfile
from typing import Any

import numpy as np
import torch

_MAGIC = "repro-ckpt-v1"
# what a checkpoint that does not load raises on its way in
_LOAD_ERRORS = (OSError, EOFError, ValueError, KeyError, TypeError,
                zipfile.BadZipFile)


def _children(node):
    """``[(path suffix, child)]`` of an inner node of the tree, or None
    for a leaf; suffixes as ``jax.tree_util.keystr`` writes them."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for suffix, child in kids:
        out.update(_flatten(child, prefix + suffix))
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _from_numpy(a: np.ndarray, dtype: str, like):
    """The stored array ``a`` (logical ``dtype``) as ``like``'s kind: a
    tensor of its dtype on its device, a numpy array or a Python number."""
    if isinstance(like, torch.Tensor):
        if dtype == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))          # a copy, 0-d kept
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return a.astype(like.dtype)
    return type(like)(a.item())


def _unflatten(like, arrays: dict, prefix: str = ""):
    kids = _children(like)
    if kids is None:
        if prefix not in arrays:
            raise KeyError(f"checkpoint missing {prefix}")
        a, dtype = arrays[prefix]
        return _from_numpy(a, dtype, like)
    vals = [_unflatten(child, arrays, prefix + suffix)
            for suffix, child in kids]
    if isinstance(like, dict):
        return dict(zip(like.keys(), vals))
    if hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


class CheckpointManager:
    """Checkpoints of one job in ``directory``, the newest ``keep``
    kept."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- paths ------------------------------------------------------------
    def _step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step-{step:010d}"

    def steps(self) -> list[int]:
        """The steps with a finished checkpoint (a manifest), ascending."""
        out = []
        for p in self.dir.glob("step-*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save -------------------------------------------------------------
    def save(self, state, step: int, col=None) -> pathlib.Path:
        """Write ``state`` as checkpoint ``step``: to ``tmp-<step>``
        first, then renamed into place; older ones past ``keep`` go.
        With the ranks' ``col`` (``runtime.collectives``) rank 0 writes
        and every rank returns after the rename."""
        if col is None or col.n_shards == 1:
            return self._write(state, step)
        if col.axis_index() == 0:
            self._write(state, step)
        dev = next(v.device for v in _flatten(state).values()
                   if isinstance(v, torch.Tensor))
        col.psum(torch.zeros((), dtype=torch.int32, device=dev))   # barrier
        return self._step_dir(step)

    def _write(self, state, step: int) -> pathlib.Path:
        flat = _flatten(state)
        logical = {k: (str(v.dtype).removeprefix("torch.")
                       if isinstance(v, torch.Tensor) else None)
                   for k, v in flat.items()}
        host = {k: _to_numpy(v) for k, v in flat.items()}
        tmp = self.dir / f"tmp-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz",
                 **{str(i): v for i, v in enumerate(host.values())})
        manifest = {
            "magic": _MAGIC,
            "step": step,
            "keys": list(host),
            "shapes": [list(v.shape) for v in host.values()],
            "dtypes": [("bfloat16" if logical[k] == "bfloat16"
                        else str(v.dtype)) for k, v in host.items()],
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)                      # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def restore(self, step: int, like):
        """Checkpoint ``step`` rebuilt in the structure of ``like``, each
        leaf of its kind, dtype and device."""
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        magic = manifest.get("magic") if isinstance(manifest, dict) else None
        if magic != _MAGIC:
            raise ValueError(f"bad checkpoint magic {magic!r} in {d}")
        with np.load(d / "arrays.npz") as z:
            arrays = {key: (z[str(i)], dt) for i, (key, dt) in enumerate(
                zip(manifest["keys"], manifest["dtypes"]))}
        return _unflatten(like, arrays)

    def restore_latest(self, like):
        """``(state, step)`` of the newest checkpoint that loads, skipping
        corrupted or partial ones with a warning; ``(None, None)`` for an
        empty directory.  Raises only when every checkpoint fails."""
        steps = self.steps()
        if not steps:
            return None, None
        errors = []
        for step in reversed(steps):
            try:
                return self.restore(step, like), step
            except _LOAD_ERRORS as e:      # corrupt entry: the next-newest
                errors.append((step, e))
                warnings.warn(
                    f"skipping corrupted checkpoint step {step}: {e!r}")
        raise RuntimeError(
            f"no loadable checkpoint in {self.dir}: "
            + "; ".join(f"step {s}: {e!r}" for s, e in errors))
