"""Learnable synthetic datasets.

`make_cifar_like`: class-template images + structured noise + augmentation —
a 10/100-class, 32x32x3 dataset on which CNNs genuinely learn (accuracy
rises well above chance), standing in for CIFAR-10/100 in the no-network
container (documented substitution, DESIGN.md §7).

`make_lm_data`: token sequences from a sparse random bigram/skip-gram
process — a language-model dataset with real structure so LM training loss
decreases.
"""
from __future__ import annotations

import numpy as np


def make_cifar_like(n_classes: int = 10, n_train: int = 2000,
                    n_test: int = 400, image_size: int = 32,
                    seed: int = 0):
    rng = np.random.default_rng(seed)
    # class templates: low-frequency random fields per class
    freq = 4
    base = rng.standard_normal((n_classes, freq, freq, 3))
    templates = np.stack([
        np.kron(base[c], np.ones((image_size // freq, image_size // freq, 1)))
        for c in range(n_classes)])                     # [C, H, W, 3]
    templates = templates / np.abs(templates).max()

    def sample(n):
        labels = rng.integers(0, n_classes, n)
        imgs = templates[labels].copy()
        # augmentation: shifts, brightness, noise
        shifts = rng.integers(-3, 4, (n, 2))
        for i in range(n):
            imgs[i] = np.roll(imgs[i], shifts[i], axis=(0, 1))
        imgs += rng.normal(0, 0.35, imgs.shape)
        imgs *= rng.uniform(0.8, 1.2, (n, 1, 1, 1))
        return imgs.astype(np.float32), labels.astype(np.int32)

    xtr, ytr = sample(n_train)
    xte, yte = sample(n_test)
    return (xtr, ytr), (xte, yte)


def make_lm_data(vocab: int = 512, n_seqs: int = 512, seq_len: int = 128,
                 seed: int = 0):
    """Structured token stream: a random sparse Markov chain."""
    rng = np.random.default_rng(seed)
    # each token has a small successor set -> learnable transitions
    n_succ = 4
    successors = rng.integers(0, vocab, (vocab, n_succ))
    seqs = np.zeros((n_seqs, seq_len + 1), np.int32)
    state = rng.integers(0, vocab, n_seqs)
    for t in range(seq_len + 1):
        seqs[:, t] = state
        pick = rng.integers(0, n_succ, n_seqs)
        state = successors[state, pick]
        # occasional random jump for entropy
        jump = rng.random(n_seqs) < 0.05
        state = np.where(jump, rng.integers(0, vocab, n_seqs), state)
    tokens = seqs[:, :-1]
    labels = seqs[:, 1:]
    return tokens, labels
