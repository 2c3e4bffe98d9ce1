"""Deterministic synthetic LM data pipeline (the port's own copy of the
JAX package's `data/pipeline.py`: numpy only, the same arrays bit for
bit; the train loop moves them to its device).

Production shape without external datasets: a seeded Zipfian token
stream chopped into documents, packed into fixed-length sequences with
segment ids (so attention masking is exercised end-to-end), sharded by
host, with straggler mitigation hooks:

  * every host can deterministically regenerate ANY shard (backup-task
    reassignment costs one seed, no data movement);
  * the loader yields (batch, skipped) so the train loop can renormalize
    gradient accumulation when a straggler's microbatch is dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    zipf_a: float = 1.2
    pack: bool = True


class SyntheticCorpus:
    """Seeded, order-deterministic document stream."""

    def __init__(self, cfg: DataConfig, shard: int, num_shards: int):
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards

    def _doc(self, idx: int) -> np.ndarray:
        rng = np.random.RandomState(
            (self.cfg.seed * 1_000_003 + idx) % (2 ** 31 - 1))
        n = max(8, int(rng.exponential(self.cfg.mean_doc_len)))
        toks = rng.zipf(self.cfg.zipf_a, size=n) % (self.cfg.vocab - 2)
        return (toks + 2).astype(np.int32)  # 0=pad, 1=eos reserved

    def docs(self) -> Iterator[np.ndarray]:
        idx = self.shard
        while True:
            yield self._doc(idx)
            idx += self.num_shards


def packed_batches(cfg: DataConfig, shard: int = 0, num_shards: int = 1
                   ) -> Iterator[dict]:
    """Yields {'tokens','labels','segment_ids'} of the per-shard batch.

    labels are next-token (shift-left); cross-document boundaries are
    masked with -1 and attention is segment-masked.
    """
    assert cfg.global_batch % num_shards == 0
    bsz = cfg.global_batch // num_shards
    S = cfg.seq_len
    corpus = SyntheticCorpus(cfg, shard, num_shards)
    docs = corpus.docs()

    buf_tok = np.zeros((bsz, S + 1), np.int32)
    buf_seg = np.zeros((bsz, S + 1), np.int32)
    while True:
        for b in range(bsz):
            fill = 0
            seg = 1
            while fill < S + 1:
                d = next(docs)[: S + 1 - fill]
                buf_tok[b, fill:fill + len(d)] = d
                buf_seg[b, fill:fill + len(d)] = seg
                fill += len(d)
                seg += 1
                if not cfg.pack:
                    buf_tok[b, fill:] = 0
                    buf_seg[b, fill:] = 0
                    break
        tokens = buf_tok[:, :-1].copy()
        seg = buf_seg[:, :-1].copy()
        labels = buf_tok[:, 1:].copy().astype(np.int32)
        # mask next-token targets that cross a document boundary / padding
        labels = np.where(buf_seg[:, 1:] == seg, labels, -1)
        yield {"tokens": tokens, "labels": labels, "segment_ids": seg}


def microbatches(batch: dict, n_micro: int) -> list[dict]:
    """Split a host batch into gradient-accumulation microbatches."""
    out = []
    bsz = batch["tokens"].shape[0]
    assert bsz % n_micro == 0
    m = bsz // n_micro
    for i in range(n_micro):
        out.append({k: v[i * m:(i + 1) * m] for k, v in batch.items()})
    return out


class StragglerSimulator:
    """Test/bench hook: marks a deterministic subset of microbatches as
    late.  The train loop drops them and renormalizes (see train.step)."""

    def __init__(self, drop_prob: float = 0.0, seed: int = 0):
        self.drop_prob = drop_prob
        self.rng = np.random.RandomState(seed)

    def is_late(self) -> bool:
        return bool(self.rng.rand() < self.drop_prob)
