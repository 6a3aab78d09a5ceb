"""Train a small qwen3-family LM on the PyTorch port with checkpoint and
resume (``train_lm.py``'s story): 30 steps, then the same command asked
for 40, which resumes from the checkpoint of step 30.

    PYTHONPATH=src python examples/train_lm_torch.py               # card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

The checkpoints go to a fresh temporary directory, removed at the end.
"""
import argparse
import subprocess
import sys
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = [] if args.device is None else ["--device", args.device]
    with tempfile.TemporaryDirectory() as ckpt:
        cmd = [sys.executable, "-m", "repro_torch.launch.train",
               "--arch", "qwen3-4b", "--reduce", "--batch", "4", "--seq",
               "64", "--ckpt-every", "10", "--log-every", "5", "--ckpt-dir",
               ckpt, *device]
        subprocess.run(cmd + ["--steps", "30"], check=True)
        print("\n-- simulating failure + resume (same command continues) --",
              flush=True)
        subprocess.run(cmd + ["--steps", "40"], check=True)


if __name__ == "__main__":
    main()
