"""The port's training checkpoints, resume and CLI on the CPU: the keys,
shapes and dtypes of a checkpoint of ``(params, AdamWState)`` against
``repro``'s, resume bit for bit against an unbroken run, every family of
``python -m repro_torch.launch.train`` at ``--reduce``, its refusals,
and ``examples/train_lm_torch.py --device cpu``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models import transformer as jtr  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as joptim  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.train import checkpoint, optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_train import _reduced_lm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _manifest(directory, step):
    d = Path(directory) / f"step-{step:010d}" / "manifest.json"
    m = json.loads(d.read_text())
    return m["keys"], m["shapes"], m["dtypes"]


def test_checkpoint_keys_match_reference(tmp_path):
    """``(params, AdamWState)`` of the reduced bf16 LM: the port's
    checkpoint has the keys, shapes and dtypes of ``repro``'s, in its
    order, and the port restores ``repro``'s files into its tree."""
    jcfg, cfg = _reduced_lm("qwen3-4b", bf16=True)
    params = jtr.init_lm(jax.random.PRNGKey(0), jcfg)
    jckpt.CheckpointManager(tmp_path / "repro").save(
        (params, joptim.adamw_init(params)), 3)
    model = tr.LM(cfg, seed=0, device="cpu")
    tree = model.tree()
    opt = optimizer.adamw_init(tree)
    mgr = checkpoint.CheckpointManager(tmp_path / "port")
    mgr.save((tree, opt), 3)
    assert _manifest(tmp_path / "port", 3) == _manifest(tmp_path / "repro",
                                                        3)
    back, step = checkpoint.CheckpointManager(
        tmp_path / "repro").restore_latest((tree, opt))
    assert step == 3
    for got, want in zip(tree_leaves(back[0]), jax.tree.leaves(params)):
        assert got.dtype == torch.bfloat16 or got.dtype == torch.float32
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def _args(*argv):
    return ["--arch", "qwen3-4b", "--reduce", "--batch", "2", "--seq", "16",
            "--log-every", "1", "--device", "cpu", *argv]


def test_resume_is_bit_equal_to_an_unbroken_run(tmp_path, monkeypatch,
                                                capsys):
    """To step 10 (checkpoints every 5), then a fresh process-like run to
    15, against one run to 15: the same losses, bit for bit, and the same
    step-15 checkpoint."""
    losses = []
    step = train.lm_step

    def record(*a, **kw):
        out = step(*a, **kw)
        losses.append(float(out[2]))
        return out

    monkeypatch.setattr(train, "lm_step", record)
    train.main(_args("--steps", "10", "--ckpt-every", "5", "--ckpt-dir",
                     str(tmp_path / "a")))
    train.main(_args("--steps", "15", "--ckpt-every", "5", "--ckpt-dir",
                     str(tmp_path / "a")))
    assert "resumed from checkpoint step 10" in capsys.readouterr().out
    broken, losses[:] = list(losses), []
    train.main(_args("--steps", "15", "--ckpt-every", "5", "--ckpt-dir",
                     str(tmp_path / "b")))
    assert broken == losses and len(losses) == 15
    with np.load(tmp_path / "a" / "step-0000000015" / "arrays.npz") as a, \
            np.load(tmp_path / "b" / "step-0000000015" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("arch,steps", [
    ("sasrec", 2), ("bert4rec", 2), ("mind", 2), ("dcn-v2", 2),
    ("distclub-paper", 1), ("deepseek-moe-16b", 2),
    ("llama4-maverick-400b-a17b", 2)])
def test_cli_families_run_reduced_on_the_cpu(arch, steps, capsys):
    train.main(["--arch", arch, "--reduce", "--steps", str(steps),
                "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    if arch == "distclub-paper":
        assert "interactions, reward/random" in out
    else:
        assert "step     0  loss" in out and "done; final loss" in out


def test_cli_refuses_what_is_not_ported_and_needs_a_card(tmp_path, capsys):
    """The GNN exits with ``repro``'s message; a MoE arch, refused
    before the MoE slice, trains under ``--reduce``; without a card the
    default device raises."""
    with pytest.raises(SystemExit, match="GNN"):
        train.main(["--arch", "gat-cora", "--device", "cpu"])
    train.main(["--arch", "deepseek-moe-16b", "--reduce", "--steps", "1",
                "--batch", "2", "--seq", "16", "--device", "cpu",
                "--ckpt-dir", str(tmp_path)])
    assert "done; final loss" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--arch", "qwen3-4b", "--reduce", "--steps", "1"])


def test_example_trains_and_resumes_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300, check=True).stdout
    assert "resumed from checkpoint step 30" in out
    first = float(out.split("step     0  loss ")[1].split()[0])
    final = float(out.rsplit("done; final loss ", 1)[1].split()[0])
    assert first > final, (first, final)
