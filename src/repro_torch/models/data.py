"""Synthetic, structure-matched datasets for the paper's workloads.

WikiNER / IWSLT / PTB / Weibo are unavailable offline; every claim we
validate is structural (batch counts, copies, throughput), so we synthesize
inputs with matching *structure*: sentence lengths, random binary parse
trees, and character lattices with word jump-links (Fig. 7). Token ids are
Zipfian.
"""

from __future__ import annotations

import random
from dataclasses import dataclass


def zipf_token(rng: random.Random, vocab: int) -> int:
    """Zipf-ish token id in [0, vocab)."""
    r = rng.random()
    return min(int(vocab ** r) - 1, vocab - 1)


@dataclass
class TreeNode:
    token: int | None = None       # leaves carry tokens
    left: "TreeNode | None" = None
    right: "TreeNode | None" = None
    tag: int = 0                   # internal-node subtype (TreeLSTM-2Type)

    @property
    def is_leaf(self) -> bool:
        return self.left is None


def random_tree(rng: random.Random, n_leaves: int, vocab: int = 1000,
                n_tags: int = 1) -> TreeNode:
    """Random binary parse tree over n_leaves tokens (PTB stand-in)."""
    nodes = [TreeNode(token=zipf_token(rng, vocab)) for _ in range(n_leaves)]
    while len(nodes) > 1:
        i = rng.randrange(len(nodes) - 1)
        l = nodes.pop(i)
        r = nodes.pop(i)
        nodes.insert(i, TreeNode(left=l, right=r, tag=rng.randrange(n_tags)))
    return nodes[0]


def random_sentence(rng: random.Random, lo: int = 8, hi: int = 32,
                    vocab: int = 1000) -> list[int]:
    return [zipf_token(rng, vocab) for _ in range(rng.randint(lo, hi))]


@dataclass
class Lattice:
    """A character chain with word jump links (Zhang & Yang 2018, Fig. 7).

    ``words[j]`` is either None or (start, token): a word spanning characters
    [start, j] whose cell output merges into the char cell at j+1. At most
    one word ends per character position (see DESIGN.md)."""

    chars: list[int]
    words: list[tuple[int, int] | None]


def random_lattice(rng: random.Random, lo: int = 10, hi: int = 30,
                   vocab: int = 1000, word_vocab: int = 5000,
                   p_word: float = 0.35) -> Lattice:
    n = rng.randint(lo, hi)
    chars = [zipf_token(rng, vocab) for _ in range(n)]
    words: list[tuple[int, int] | None] = [None] * n
    for j in range(1, n - 1):
        if rng.random() < p_word:
            start = max(0, j - rng.randint(1, 3))
            if start < j:
                words[j] = (start, zipf_token(rng, word_vocab))
    return Lattice(chars, words)
