"""Deterministic synthetic data pipeline (port of ``repro/data/synthetic.py``).

Tokens follow a Zipf unigram prior modulated by a low-rank order-1 Markov
transition. Sampling stays in numpy with the reference's ``RandomState``
draws, so a fixed seed gives bit-identical token streams in both packages;
only the finished batch becomes a tensor on the requested device. A
config with several codebooks draws them one after another from the one
stream; a frontend config's prefix embeddings come from a generator of
their own, as in the reference. ``sharded_batches`` yields one host's
contiguous row slice of that stream; the hosts' slices concatenated give
the stream of ``batches`` back bit for bit. ``process_local_batches`` yields
one process's rows of every microbatch (a multi-process SPMD run); the
processes' slices stacked over a partition of the data shards give the
microbatched stream back bit for bit.
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


class SyntheticLM:
    """Order-1 Markov token stream with planted low-rank structure.

    P(next | cur) = softmax(log zipf + A[cur] @ B), computed per row for the
    batch's current tokens; the dense (V, V) table is never built."""

    def __init__(self, vocab: int, seed: int = 0, rank: int = 8, zipf_a: float = 1.2):
        rng = np.random.RandomState(seed)
        self.vocab = vocab
        base = 1.0 / np.arange(1, vocab + 1) ** zipf_a
        self.log_base = np.log(base / base.sum())
        self.A = (rng.randn(vocab, rank) * 2.0).astype(np.float32)
        self.B = (rng.randn(rank, vocab) * 2.0 / np.sqrt(rank)).astype(np.float32)
        self.rng = np.random.RandomState(seed + 1)

    def _rows(self, cur: np.ndarray) -> np.ndarray:
        """Transition rows P(. | cur) for a vector of current tokens."""
        logits = self.log_base[None, :] + self.A[cur] @ self.B
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        return p / p.sum(axis=1, keepdims=True)

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len + 1), np.int32)
        out[:, 0] = self.rng.randint(0, self.vocab, size=batch)
        for t in range(seq_len):
            cum = np.cumsum(self._rows(out[:, t]), axis=1)
            u = self.rng.rand(batch, 1)
            # first index with cum > u, clamped against float rounding at the
            # top of the cumulative sum
            idx = (cum <= u).sum(axis=1)
            out[:, t + 1] = np.minimum(idx, self.vocab - 1)
        return out


def batches(
    cfg: ModelConfig,
    batch_size: int,
    seq_len: int,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite iterator of {tokens, labels[, frontend]} batches on
    ``device``: int64 tokens and labels, (B, S) or, with ``K =
    cfg.num_codebooks > 1``, (B, S, K), the codebooks sampled in turn from
    the one stream; and for a frontend config with prefix tokens, float32
    prefix embeddings (B, cfg.frontend_tokens, cfg.frontend_dim or d_model)
    drawn from ``RandomState(seed + 7)``."""
    stream = SyntheticLM(cfg.vocab_size, seed)
    rng = np.random.RandomState(seed + 7)
    while True:
        if cfg.num_codebooks > 1:
            toks = np.stack([stream.sample(batch_size, seq_len)
                             for _ in range(cfg.num_codebooks)], axis=-1)  # (B, S+1, K)
        else:
            toks = stream.sample(batch_size, seq_len)
        toks = torch.from_numpy(toks.astype(np.int64)).to(device)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend is not None and cfg.frontend_tokens:
            dim = cfg.frontend_dim or cfg.d_model
            prefix = rng.randn(batch_size, cfg.frontend_tokens, dim).astype(np.float32) * 0.02
            batch["frontend"] = torch.from_numpy(prefix).to(device)
        yield batch


def sharded_batches(
    cfg: ModelConfig,
    batch_size: int,
    seq_len: int,
    num_hosts: int,
    host_id: int,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Host ``host_id``'s contiguous row slice of the global batch stream.

    Every host walks the same seeded global stream and keeps rows
    ``[host_id * B/num_hosts, (host_id + 1) * B/num_hosts)``: the sampler
    draws each batch's rows from one generator, so slicing after sampling is
    the only way to shard it exactly. Every key (tokens, labels, the
    frontend prefix) is sliced on its rows."""
    if batch_size % num_hosts:
        raise ValueError(f"global batch {batch_size} must divide over {num_hosts} hosts")
    local = batch_size // num_hosts
    lo, hi = host_id * local, (host_id + 1) * local
    for batch in batches(cfg, batch_size, seq_len, seed=seed, device=device):
        yield {k: v[lo:hi] for k, v in batch.items()}


def process_local_batches(
    cfg: ModelConfig,
    batch_size: int,
    seq_len: int,
    num_microbatches: int,
    data_shards: int,
    shard_lo: int,
    shard_hi: int,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Process-local slice of the global microbatched stream (the
    multi-process loading path).

    The pipeline takes the global batch as ``(B, S) -> (M, B//M, S)`` with
    each microbatch's rows split over the pod-major data shards. A process
    that runs data shards ``[shard_lo, shard_hi)`` of ``data_shards``
    (``Topology.process_data_shards``) gets, for every microbatch, the rows
    of those shards: ``(M, (hi - lo) * B//M//shards, S)``. Like
    ``sharded_batches`` it samples the whole global batch (on the host) and
    keeps its slice, which alone goes to ``device``."""
    M = num_microbatches
    if batch_size % M:
        raise ValueError(f"global batch {batch_size} must divide into {M} microbatches")
    mb = batch_size // M
    if mb % data_shards:
        raise ValueError(f"microbatch size {mb} must divide over {data_shards} data shards")
    if not 0 <= shard_lo < shard_hi <= data_shards:
        raise ValueError(f"shard range [{shard_lo}, {shard_hi}) outside [0, {data_shards})")
    w = mb // data_shards
    for batch in batches(cfg, batch_size, seq_len, seed=seed, device="cpu"):
        out = {}
        for k, v in batch.items():
            rest = tuple(v.shape[1:])
            local = v.reshape((M, data_shards, w) + rest)[:, shard_lo:shard_hi]
            out[k] = local.reshape((M, (shard_hi - shard_lo) * w) + rest).to(device)
        yield out


def eval_batches(
    cfg: ModelConfig,
    batch_size: int,
    seq_len: int,
    n: int,
    seed: int = 10_000,
    device: torch.device | str = "cuda",
) -> List[Dict[str, torch.Tensor]]:
    """``n`` held-out batches, from a stream of their own seed."""
    it = batches(cfg, batch_size, seq_len, seed, device)
    return [next(it) for _ in range(n)]
