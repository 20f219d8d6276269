"""End-to-end training example on the PyTorch port: a reduced llama-family
model through the training substrate (chunk-store pipeline -> training
step -> checkpoints), with a simulated failure and restart mid-run to
demonstrate fault tolerance.

    PYTHONPATH=src python examples/torch_train_end_to_end.py [--device cuda|cpu]

The twin of ``examples/train_end_to_end.py`` on ``repro_torch.launch.train``,
which imports nothing of JAX: 40 steps with a checkpoint every 20, then a
"crash" and a restart that resumes from step 40 (weights, optimizer state
and data cursor) and runs to 60. Attention runs through the hand-written
CUDA flash kernel on the card (its plain version on the CPU), its backward
through the plain chunked attention. It runs on the card unless
``--device cpu`` is given; without a card it refuses to run.
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    common = ["--arch", "tinyllama-1.1b", "--smoke", "--batch", "4", "--seq", "64",
              "--lr", "3e-3", "--ckpt-every", "20", "--device", args.device]
    with tempfile.TemporaryDirectory() as ckpt:
        print("=== phase 1: train 40 steps, checkpoint every 20 ===")
        train(["--steps", "40", "--ckpt", ckpt, *common])

        print("\n=== phase 2: 'crash' after step 40; restart resumes and runs to 60 ===")
        losses = train(["--steps", "60", "--ckpt", ckpt, *common])
        print(f"\nresumed run executed {len(losses)} steps (expected 20)")
    return losses


if __name__ == "__main__":
    main()
