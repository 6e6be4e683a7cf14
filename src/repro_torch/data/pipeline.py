"""Deterministic synthetic data, the port of `repro.data.pipeline`: the
paper problems' numpy generators (copied), plus the token stream for LM
training with per-node disjoint shards and async host prefetch, whose
batches are the reference's numpy bits, handed over as torch tensors on the
run's device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Paper problems
# ---------------------------------------------------------------------------


def synthetic_mnist_like(m: int, d: int = 784, num_classes: int = 10,
                         seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """MNIST-like class-clustered vectors (the paper uses real MNIST; the
    container has no dataset downloads, so we build class clusters with
    matching dimensionality and scale -- documented in DESIGN.md)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 1.0, (num_classes, d))
    labels = rng.integers(0, num_classes, m)
    x = centers[labels] + rng.normal(0.0, 0.8, (m, d))
    return x.astype(np.float32), labels.astype(np.int32)


def metric_learning_pairs(m_pairs: int, d: int = 784, seed: int = 0,
                          num_classes: int = 10):
    """Pairs (u_j, v_j, s_j) for the paper's section V.A metric-learning
    task: s=+1 if same class else -1."""
    x, y = synthetic_mnist_like(2 * m_pairs, d, num_classes, seed)
    u, v = x[0::2], x[1::2]
    s = np.where(y[0::2] == y[1::2], 1.0, -1.0).astype(np.float32)
    return u, v, s


def nonsmooth_quadratic_problem(n_nodes: int, M: int, d: int, seed: int = 0,
                                center_scale: float = 1.0):
    """Paper section V.B: f_i(x) = sum_j max(l^1_j(x), l^2_j(x)) with
    l^xi = ||x - c^xi||^2; node centers drawn far apart so communication is
    essential. Returns centers (n, M, 2, d)."""
    rng = np.random.default_rng(seed)
    node_shift = rng.normal(0.0, center_scale, (n_nodes, 1, 1, d))
    centers = rng.normal(0.0, 0.3, (n_nodes, M, 2, d)) + node_shift
    return centers.astype(np.float32)


def partition_rows(m: int, n_nodes: int) -> list[slice]:
    """Even partition (paper assumes n | m; we give the remainder to the
    last node)."""
    base = m // n_nodes
    out = []
    for i in range(n_nodes):
        lo = i * base
        hi = (i + 1) * base if i < n_nodes - 1 else m
        out.append(slice(lo, hi))
    return out


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TokenStream:
    """Deterministic synthetic LM token stream with disjoint per-node shards
    and background host prefetch.

    Documents are Zipf-sampled token blocks with an injected bigram
    structure so the loss has real signal (a pure-uniform stream trains to
    log(V) and nothing else). Batches are (batch, seq+1); the step splits
    tokens[:, :-1] / labels[:, 1:], int32 tensors on `device` (None: the
    CUDA card). A producer thread fills the queue: `close()` every stream.
    """

    vocab_size: int
    seq_len: int
    batch_size: int
    node_index: int = 0
    num_nodes: int = 1
    seed: int = 0
    prefetch: int = 2
    device: Any = None

    def __post_init__(self):
        from repro_torch import resolve_device

        self.device = resolve_device(self.device)
        self._q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.node_index) * 977 + step)
        B, S, V = self.batch_size, self.seq_len + 1, self.vocab_size
        base = rng.zipf(1.3, size=(B, S)).astype(np.int64)
        toks = (base - 1) % V
        # bigram structure: every even position strongly predicts the next
        toks[:, 1::2] = (toks[:, 0::2][:, : toks[:, 1::2].shape[1]]
                         * 31 + 7) % V
        return toks.astype(np.int32)

    def _producer(self):
        step = 0
        while not self._stop.is_set():
            try:
                self._q.put(self._batch_at(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        toks = torch.from_numpy(self._q.get())
        return {"tokens": toks[:, :-1].contiguous().to(self.device),
                "labels": toks[:, 1:].contiguous().to(self.device)}

    def close(self):
        """Stop the producer and wait for it: the queue is drained so that
        a put it is blocked in returns at once."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.01)
