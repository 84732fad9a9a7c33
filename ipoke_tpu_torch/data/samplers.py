"""Index samplers (the port's copy of ``ipoke_tpu/data/samplers.py``).

FixedLengthSampler (reference: data/samplers.py:59-79): per epoch, a random
1/zero_poke_amount fraction of the indices is replaced by -1, which the
datasets read as "sample a zero-poke example" (the zero-poke signal travels
through the index).  Each sampler draws from ``np.random.default_rng(seed)``
as the JAX package's does, so the same seed gives the same order."""
from __future__ import annotations

import numpy as np


class FixedLengthSampler:
    def __init__(self, n_examples: int, zero_poke: bool, zero_poke_amount: int = 12, seed: int = 0):
        self.n = n_examples
        self.zero_poke = zero_poke
        self.zero_poke_amount = zero_poke_amount
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.n

    def __iter__(self):
        idx = self.rng.permutation(self.n)
        if self.zero_poke and self.zero_poke_amount:
            n_zero = max(self.n // self.zero_poke_amount, 1)
            zero_positions = self.rng.choice(self.n, n_zero, replace=False)
            idx = idx.copy()
            idx[zero_positions] = -1
        return iter(idx.tolist())


class SequenceSampler:
    """Legacy per-batch-lag BATCH sampler (reference data/samplers.py:7-37,
    unused by released configs): every batch carries ONE lag drawn from
    ``valid_lags``, yielded as (idx, lag) tuples so the dataset can load the
    matching flow file."""

    def __init__(self, n_examples: int, valid_lags, batch_size: int,
                 shuffle: bool = True, drop_last: bool = False, seed: int = 0):
        self.n = n_examples
        self.valid_lags = list(valid_lags)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        full, rem = divmod(self.n, self.batch_size)
        return full + (1 if rem and not self.drop_last else 0)

    def __iter__(self):
        order = self.rng.permutation(self.n) if self.shuffle else np.arange(self.n)
        batch, lag = [], int(self.rng.choice(self.valid_lags))
        for idx in order.tolist():
            batch.append((idx, lag))
            if len(batch) == self.batch_size:
                yield batch
                batch, lag = [], int(self.rng.choice(self.valid_lags))
        if batch and not self.drop_last:
            yield batch


class SequenceLengthSampler:
    """Legacy variable-sequence-length BATCH sampler (reference
    data/samplers.py:83-150, unused by released configs): each batch carries
    one sequence length in [0, max_frames); with zero_poke, length -1 marks a
    zero-poke batch and pairs with a random actual length.  Weighted length
    distribution: zeropoke_weight on the -1 slot, longest_seq_weight on the
    longest (train only).  Yields batches of (n_frames, n_frames_actual)."""

    def __init__(self, n_examples: int, max_frames: int, batch_size: int,
                 shuffle: bool = True, drop_last: bool = False,
                 zero_poke: bool = False, zeropoke_weight: float = 1.0,
                 longest_seq_weight=None, train: bool = True, seed: int = 0):
        self.n = n_examples
        self.max_frames = max_frames
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.zero_poke = zero_poke
        self.start = -1 if zero_poke else 0
        self.rng = np.random.default_rng(seed)
        if zero_poke:
            p = np.asarray(([zeropoke_weight] if train else [1.0]) + [1.0] * max_frames)
        else:
            p = np.asarray([1.0] * max_frames)
        if longest_seq_weight is not None and train:
            p[-1] = longest_seq_weight
            if zero_poke:
                p[0] = longest_seq_weight / 2
        self.len_p = p / p.sum()

    def __len__(self):
        full, rem = divmod(self.n, self.batch_size)
        return full + (1 if rem and not self.drop_last else 0)

    def _draw(self, last_n):
        if self.shuffle:
            n = int(self.rng.choice(np.arange(self.start, self.max_frames), p=self.len_p))
        else:
            n = last_n + 1 if last_n < self.max_frames - 1 else self.start
        actual = int(self.rng.integers(0, self.max_frames)) if n == -1 else None
        return n, actual

    def __iter__(self):
        batch = []
        last_n = self.start
        n, actual = (self._draw(last_n) if self.shuffle else (last_n, None))
        for _ in range(self.n):
            batch.append((n, actual))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
                if not self.shuffle:
                    last_n = n
                n, actual = self._draw(last_n)
        if batch and not self.drop_last:
            yield batch


class SequentialSampler:
    def __init__(self, n_examples: int):
        self.n = n_examples

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter(range(self.n))


class WeightedRandomSampler:
    """Object-weighted sampling (reference datamodule obj_weighting path)."""

    def __init__(self, weights: np.ndarray, n_samples: int, seed: int = 0):
        self.p = np.asarray(weights, np.float64)
        self.p = self.p / self.p.sum()
        self.n = n_samples
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter(self.rng.choice(len(self.p), self.n, p=self.p).tolist())
