"""Training launcher: the reference's (``src/repro/launch/train.py``) flags
and defaults, plus ``--device`` (default ``cuda``; without CUDA it raises
instead of falling back to the CPU) and ``--log-every``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 10 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --steps 200 --device cpu --checkpoint runs/w.npz

Random initial weights come from ``torch.Generator().manual_seed(--seed)``
on the CPU and are copied to the device, so a CPU and a card run start
from the same weights. On the card attention is differentiated through
the flash-attention backward kernel and an SSM layer's scan through the
SSD scan's (``--arch mamba2-130m`` trains there at full width and depth).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.arch.model import TransformerLM, tree_map
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.loop import train
from repro_torch.train.optimizer import AdamWConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer small-width family variant (CPU-friendly)")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--log-every", type=int, default=10,
                    help="log the loss at the first step and every N-th")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    return ap


def main(argv=None, log_fn=print):
    """Train as the flags say; returns the final ``TrainState``. ``log_fn``
    receives each log line."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(d_model=args.d_model)
    model = TransformerLM(cfg, device=device)
    params = TransformerLM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(args.seed))
    params = tree_map(lambda t: t.to(device), params)
    pipe = SyntheticCorpus(PipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, batch_size=args.batch,
        seed=args.seed, n_image_tokens=cfg.n_image_tokens,
        d_model=cfg.d_model))
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps)
    state = train(model, params, iter(pipe), args.steps, opt,
                  log_every=args.log_every, log_fn=log_fn)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state.params, state.opt, state.step,
                        {"arch": cfg.name})
        log_fn(f"saved {args.checkpoint}")
    return state


if __name__ == "__main__":
    main()
