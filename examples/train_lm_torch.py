"""End-to-end run of the PyTorch port: train a language model on the
synthetic corpus through ``repro_torch.launch.train``, as
``examples/train_lm.py`` does over the JAX package.

Default is a reduced config; pass --d-model 512 for larger runs. It trains
on the card unless --device cpu; the checkpoint goes to
``build/examples/<arch>-lm.npz`` under the checkout.

    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen2-0.5b \\
        --steps 200 --device cpu
"""
import argparse
from pathlib import Path

from repro_torch.launch.train import main as train_main

OUT = Path(__file__).resolve().parents[1] / "build" / "examples"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    train_main(["--arch", args.arch, "--reduced",
                "--d-model", str(args.d_model),
                "--steps", str(args.steps),
                "--batch", str(args.batch), "--seq", str(args.seq),
                "--device", args.device,
                "--checkpoint", str(OUT / f"{args.arch}-lm.npz")])


if __name__ == "__main__":
    main()
