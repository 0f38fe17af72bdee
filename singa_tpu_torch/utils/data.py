"""Batches from in-memory arrays, ported from ``singa_tpu/utils/data.py``
(``DataLoader``'s numpy pipeline with its resume cursor and the
``data.next`` fault site, and ``synthetic_dataset``).

The loader shuffles each epoch with ``np.random.RandomState(seed +
epoch)``, as the reference's numpy pipeline does, so the two packages
yield the same batches for the same seed and epoch.  The reference's
native threaded loader and multi-host sharding are not ported.
"""

from __future__ import annotations

import warnings
from typing import Iterator, Optional, Tuple

import numpy as np

from .. import faults

__all__ = ["DataLoader", "synthetic_dataset"]


class DataLoader:
    """Iterate (x, y) minibatches of in-memory arrays; one iteration is
    one epoch, reshuffled each epoch (seed + epoch).

    The loader keeps an (epoch, batch) cursor: a loop that breaks leaves
    it mid-epoch, and the next ``__iter__`` resumes at the next batch of
    the same permutation instead of reshuffling.  `state_dict` /
    `load_state_dict` carry the cursor across a restart."""

    def __init__(self, x: np.ndarray, y: Optional[np.ndarray] = None,
                 batch_size: int = 32, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        x = np.asarray(x)
        self.x = (x.astype(np.int32, copy=False)
                  if np.issubdtype(x.dtype, np.integer)
                  else x.astype(np.float32, copy=False))
        self.y = np.asarray(y, np.int32) if y is not None else None
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0       # epochs fully consumed
        self._batch_idx = 0   # batches consumed within the current epoch
        self._len_warned = False

    def __len__(self) -> int:
        n = len(self.x)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        # "data.next" injection site, once per batch drawn (error/hang
        # before the yield; nan corrupts the yielded float arrays).  The
        # cursor has already advanced, so a caller that retries past an
        # injected error skips that batch
        idx = np.arange(len(self.x))
        if self.shuffle:
            # the permutation is a function of the cursor alone, so a
            # resumed loader replays the same epoch order
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        for b in range(self._batch_idx, len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            self._batch_idx = b + 1
            faults.fire("data.next", epoch=self._epoch, batch=b + 1)
            yield faults.corrupt(
                "data.next",
                (self.x[sel], self.y[sel] if self.y is not None else None))
        self._epoch += 1
        self._batch_idx = 0

    def state_dict(self) -> dict:
        """The loader's position: what reproduces the rest of its data
        trajectory after a restart."""
        return {"epoch": int(self._epoch), "batch_idx": int(self._batch_idx),
                "seed": int(self.seed), "num_samples": int(len(self.x))}

    def load_state_dict(self, state: dict) -> None:
        """Restore a position taken by `state_dict`.  Warns once when the
        dataset's length changed between save and load: the resumed
        shuffle then runs over other data."""
        n = state.get("num_samples")
        if n is not None and int(n) != len(self.x) and not self._len_warned:
            self._len_warned = True
            warnings.warn(
                f"DataLoader dataset length changed between save "
                f"({int(n)} samples) and load ({len(self.x)}): the "
                f"resumed shuffle trajectory covers different data",
                stacklevel=2)
        self.seed = int(state.get("seed", self.seed))
        self._epoch = int(state.get("epoch", 0))
        self._batch_idx = int(state.get("batch_idx", 0))


def synthetic_dataset(kind: str = "blobs", n: int = 1024, classes: int = 10,
                      shape=(32, 32, 3), seed: int = 0):
    """Deterministic synthetic datasets for the example scripts: "blobs"
    (Gaussian clusters) or "images" (noise with a class-dependent bright
    row, which a model can learn)."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, n).astype(np.int32)
    if kind == "blobs":
        d = int(np.prod(shape))
        centers = rng.randn(classes, d).astype(np.float32) * 2.0
        x = centers[y] + rng.randn(n, d).astype(np.float32)
        return x.reshape((n,) + tuple(shape)), y
    if kind == "images":
        x = rng.randn(n, *shape).astype(np.float32)
        for c in range(classes):
            x[y == c, c % shape[0], :, :] += 2.0
        return x, y
    raise ValueError(kind)
