"""Deterministic synthetic token pipeline, restart-safe (port of
``repro.data.synthetic``, pure numpy, copied so the port imports nothing
of the reference; batches are bitwise the reference's).

The stream is a learnable language: token t+1 depends on token t (order
1) or on tokens t and t-1 (order 2) through fixed random permutation
tables, plus uniform noise at rate ``noise``, so a model with enough
capacity pushes the loss well below the unigram entropy.

``batch_at(step, host, n_hosts)`` is a pure function: any host can
reproduce any step's shard after a restart without coordination, and
re-sharding only changes ``(host, n_hosts)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    noise: float = 0.1
    seed: int = 1234
    order: int = 1   # 1: t+1 = f(t);  2: t+1 = f(t, t-1) (harder)

    def _tables(self) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        t1 = rng.permutation(self.vocab)
        t2 = rng.permutation(self.vocab)
        return t1, t2

    def batch_at(self, step: int, host: int = 0, n_hosts: int = 1) -> dict:
        """``{tokens, labels}`` (int32 ``[local, seq_len]``) of this host's
        shard of ``step``."""
        if self.global_batch % n_hosts:
            raise ValueError("global_batch must divide by n_hosts")
        local = self.global_batch // n_hosts
        t1, t2 = self._tables()
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + host)
        b = np.empty((local, self.seq_len + 1), np.int64)
        b[:, 0] = rng.integers(0, self.vocab, local)
        b[:, 1] = rng.integers(0, self.vocab, local)
        noise_mask = rng.random((local, self.seq_len + 1)) < self.noise
        noise_tok = rng.integers(0, self.vocab, (local, self.seq_len + 1))
        for t in range(2, self.seq_len + 1):
            if self.order == 1:
                b[:, t] = t1[b[:, t - 1]]
            else:
                b[:, t] = (t1[b[:, t - 1]] + t2[b[:, t - 2]]) % self.vocab
            b[:, t] = np.where(noise_mask[:, t], noise_tok[:, t], b[:, t])
        return {
            "tokens": b[:, :-1].astype(np.int32),
            "labels": b[:, 1:].astype(np.int32),
        }

    def optimal_accuracy(self) -> float:
        """Best achievable next-token accuracy: ``1 - noise +
        noise / vocab``."""
        return 1.0 - self.noise + self.noise / self.vocab


def token_iterator(spec: SyntheticLM, start_step: int = 0, host: int = 0,
                   n_hosts: int = 1):
    """``(step, batch)`` from ``start_step`` on, forever."""
    step = start_step
    while True:
        yield step, spec.batch_at(step, host, n_hosts)
        step += 1
