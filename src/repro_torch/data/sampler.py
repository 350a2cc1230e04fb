"""Negative samplers + batch iterators for the paper-repro training runs
(GMF/NeuMF pointwise with sampled negatives; SASRec sequence batches),
plus a shard-aware wrapper for multi-host input pipelines.

Copied verbatim from the JAX package (numpy and threads only), so both
packages draw identical batches from one seed; the batches stay numpy
and the training loop moves them to the params' device.
"""
from __future__ import annotations

import threading
import queue as queue_mod
from typing import Dict, Iterator

import numpy as np

from repro_torch.data.synthetic import InteractionData


class PointwiseSampler:
    """(user, item, label) batches: each positive paired with
    ``n_neg`` sampled negatives (NCF protocol)."""

    def __init__(self, data: InteractionData, batch_pos: int = 256,
                 n_neg: int = 4, seed: int = 0):
        self.data = data
        self.batch_pos = batch_pos
        self.n_neg = n_neg
        self.rng = np.random.default_rng(seed)
        self.users = np.concatenate([
            np.full(len(s), u, np.int64)
            for u, s in enumerate(data.train_seqs) if len(s)])
        self.items = np.concatenate(
            [s for s in data.train_seqs if len(s)])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.users)
        while True:
            idx = self.rng.integers(0, n, self.batch_pos)
            u_pos, i_pos = self.users[idx], self.items[idx]
            u_neg = np.repeat(u_pos, self.n_neg)
            i_neg = self.rng.integers(0, self.data.n_items,
                                      self.batch_pos * self.n_neg)
            users = np.concatenate([u_pos, u_neg])
            items = np.concatenate([i_pos, i_neg])
            labels = np.concatenate([
                np.ones(self.batch_pos, np.float32),
                np.zeros(self.batch_pos * self.n_neg, np.float32)])
            yield {"user_ids": users, "item_ids": items, "label": labels}


class SequenceSampler:
    """SASRec batches: (seq (B, L), pos (B, L), neg (B, L)) with 0 = pad
    and item ids shifted by +1 (0 reserved)."""

    def __init__(self, data: InteractionData, batch: int = 128,
                 maxlen: int = 50, seed: int = 0):
        self.data = data
        self.batch = batch
        self.maxlen = maxlen
        self.rng = np.random.default_rng(seed)
        self.valid_users = [u for u, s in enumerate(data.train_seqs)
                            if len(s) >= 2]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        l = self.maxlen
        while True:
            users = self.rng.choice(self.valid_users, self.batch)
            seq = np.zeros((self.batch, l), np.int64)
            pos = np.zeros((self.batch, l), np.int64)
            neg = np.zeros((self.batch, l), np.int64)
            for row, u in enumerate(users):
                s = self.data.train_seqs[u] + 1          # shift: 0 = pad
                take = min(len(s) - 1, l)
                seq[row, l - take:] = s[-take - 1:-1]
                pos[row, l - take:] = s[-take:]
                neg[row, l - take:] = self.rng.integers(
                    1, self.data.n_items + 1, take)
            yield {"seq": seq, "pos": pos, "neg": neg}


class ShardedIterator:
    """Slices a global batch for one host: host h of H takes rows
    [h*B/H, (h+1)*B/H) — the multi-host input-pipeline contract."""

    def __init__(self, base: Iterator[Dict[str, np.ndarray]],
                 host_id: int, num_hosts: int):
        self.base = iter(base)
        self.host_id = host_id
        self.num_hosts = num_hosts

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = next(self.base)
        out = {}
        for k, v in batch.items():
            b = v.shape[0]
            if b % self.num_hosts:
                raise ValueError(
                    f"batch leaf {k!r} has {b} rows, not divisible over "
                    f"{self.num_hosts} hosts")
            per = b // self.num_hosts
            out[k] = v[self.host_id * per:(self.host_id + 1) * per]
        return out


class Prefetcher:
    """Background-thread prefetch so host-side sampling overlaps with
    device compute (the CPU analogue of an input pipeline)."""

    def __init__(self, base: Iterator, depth: int = 2):
        self.base = iter(base)
        self.q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self.thread = threading.Thread(target=self._fill, daemon=True)
        self.thread.start()

    def _fill(self):
        try:
            while True:
                self.q.put(next(self.base))
        except StopIteration:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item
