"""Bag-of-words place recognition for large keyframe stores.

Port of ``multimot_track_tpu.ops.bow``: a vocabulary trained by k-means
over {-1, +1} descriptors (the dot product ranks like the Hamming
distance, so an assignment is one product), a TF-IDF word histogram per
keyframe, L2-normalised, and retrieval as one (K, V) matrix-vector
product.  Every product runs in full float32 whatever the caller's TF32
setting: a rounded product would move word assignments.

The k-means seeds are an input of ``train_vocabulary``.  The JAX package
draws them with ``jax.random.choice`` under a threefry key, which torch
cannot reproduce; ``draw_seed_indices`` makes the same kind of draw
(without replacement, proportional to p, a Gumbel top-k) from a
``torch.Generator``.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch


class Vocabulary(NamedTuple):
    words: torch.Tensor    # (V, D) float32 centroids in sign space
    idf: torch.Tensor      # (V,) inverse-document-frequency weights


@contextlib.contextmanager
def full_fp32():
    """Products in full float32 on the card (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def seed_probabilities(valid: torch.Tensor) -> torch.Tensor:
    """(N,) draw probabilities of the k-means seeds: uniform over valid rows."""
    vf = valid.to(torch.float32)
    return vf / torch.clamp(vf.sum(), min=1.0)


def draw_seed_indices(p: torch.Tensor, n_words: int, generator: torch.Generator) -> torch.Tensor:
    """``n_words`` distinct indices, drawn proportional to p (N,) by the
    Gumbel top-k trick, lowest index first among equal keys.  The
    generator's device must be the CPU's.  Raises ValueError when p has
    fewer than ``n_words`` entries, as ``jax.random.choice`` does."""
    if n_words > p.shape[0]:
        raise ValueError(f"cannot draw {n_words} distinct vocabulary seeds from "
                         f"{p.shape[0]} training descriptors")
    u = torch.rand(p.shape[0], generator=generator, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    keys = torch.log(p.cpu()) - torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.sort(keys, descending=True, stable=True).indices[:n_words].to(p.device)


def _assign(x: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Nearest word of each row (first maximum of the similarity)."""
    return torch.argmax(x @ words.T, dim=1)


def train_vocabulary(init_idx: torch.Tensor, desc: torch.Tensor, valid: torch.Tensor,
                     n_words: int = 256, iters: int = 10) -> Vocabulary:
    """k-means in dot-product space from the seed rows ``init_idx``
    (n_words,).  desc (N, D) int8 signs, valid (N,)."""
    if init_idx.shape != (n_words,):
        raise ValueError(f"{n_words} vocabulary seeds needed, got {tuple(init_idx.shape)}")
    with full_fp32():
        x = desc.to(torch.float32)
        vf = valid.to(torch.float32)
        words = x[init_idx]
        for _ in range(iters):
            onehot = torch.nn.functional.one_hot(_assign(x, words), n_words).to(torch.float32)
            onehot = onehot * vf[:, None]
            sums = onehot.T @ x                              # (V, D)
            counts = onehot.sum(0)[:, None]
            words = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), words)
        # idf over the training features, as DBoW2 computes it
        df = torch.zeros(n_words, dtype=torch.float32, device=x.device).index_add_(
            0, _assign(x, words), vf)
        idf = torch.log(torch.clamp(vf.sum(), min=1.0) / torch.clamp(df, min=1.0) + 1.0)
    return Vocabulary(words=words, idf=idf)


def signature(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, D) descriptors -> (V,) L2-normalised TF-IDF word histogram."""
    with full_fp32():
        assign = _assign(desc.to(torch.float32), voc.words)
    hist = torch.zeros(voc.words.shape[0], dtype=torch.float32, device=desc.device).index_add_(
        0, assign, valid.to(torch.float32))
    v = hist * voc.idf
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-9)


def retrieve(query_sig: torch.Tensor, db_sigs: torch.Tensor) -> torch.Tensor:
    """Similarity of a query signature against a (K, V) database."""
    with full_fp32():
        return db_sigs @ query_sig
