"""Synthetic token pipeline for end-to-end LM training.

A deterministic, seedable stream of (tokens, labels) batches. The "corpus"
is a Markov-ish synthetic language (so loss genuinely decreases with
training — pure-uniform tokens would have nothing to learn) plus optional
modality stubs (image embeddings) for VLM configs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    batch_size: int
    seed: int = 0
    n_image_tokens: int = 0
    d_model: int = 0


class SyntheticCorpus:
    """Order-2 Markov chain over a reduced alphabet, remapped into vocab."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        k = min(cfg.vocab, 64)
        self.k = k
        # sparse-ish transition table: each (a, b) context prefers few tokens
        logits = rng.standard_normal((k, k, k)) * 2.0
        self.probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        self.remap = rng.permutation(cfg.vocab)[:k]
        self._step = 0

    def batch(self, step: int | None = None):
        cfg = self.cfg
        step = self._step if step is None else step
        self._step = step + 1
        rng = np.random.default_rng(cfg.seed * 1_000_003 + step)
        B, S, k = cfg.batch_size, cfg.seq_len, self.k
        seq = np.zeros((B, S + 1), np.int64)
        seq[:, 0] = rng.integers(0, k, B)
        seq[:, 1] = rng.integers(0, k, B)
        u = rng.random((B, S + 1))
        for t in range(2, S + 1):
            p = self.probs[seq[:, t - 2], seq[:, t - 1]]     # (B, k)
            seq[:, t] = (p.cumsum(-1) > u[:, t, None]).argmax(-1)
        tokens = self.remap[seq[:, :-1]]
        labels = self.remap[seq[:, 1:]]
        out = {"tokens": tokens.astype(np.int32),
               "labels": labels.astype(np.int32)}
        if cfg.n_image_tokens:
            out["image_embeds"] = rng.standard_normal(
                (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
        return out

    def __iter__(self):
        while True:
            yield self.batch()
