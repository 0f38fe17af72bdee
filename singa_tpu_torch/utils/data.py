"""Batches from in-memory arrays, ported from ``singa_tpu/utils/data.py``
(``DataLoader``'s numpy pipeline and ``synthetic_dataset``).

The loader shuffles each epoch with ``np.random.RandomState(seed +
epoch)``, as the reference's numpy pipeline does, so the two packages
yield the same batches for the same seed and epoch.  The reference's
native threaded loader, multi-host sharding and resume are not ported.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["DataLoader", "synthetic_dataset"]


class DataLoader:
    """Iterate (x, y) minibatches of in-memory arrays; one iteration is
    one epoch, reshuffled each epoch (seed + epoch)."""

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
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.x)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        idx = np.arange(len(self.x))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield self.x[sel], self.y[sel] if self.y is not None else None
        self._epoch += 1


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
