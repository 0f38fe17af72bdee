"""Batches from in-memory arrays, ported from ``singa_tpu/utils/data.py``
(``DataLoader``'s numpy pipeline with its resume cursor and the
``data.next`` fault site, ``prefetch_to_device`` and
``synthetic_dataset``).

The loader shuffles each epoch with ``np.random.RandomState(seed +
epoch)``, as the reference's numpy pipeline does, so the two packages
yield the same batches for the same seed and epoch.  ``rank`` and
``world_size`` give each process of a data-parallel run its contiguous
shard, as the reference's do.

``use_native=True`` takes the native threaded pipeline
(``_core.NativeLoader``: `workers` threads assemble shuffled batches
into a ring of `prefetch`, so batch assembly overlaps the card's step),
as the reference's does; it raises when the library cannot be built.
Unlike the reference, whose default takes the native pipeline wherever
the library builds, the default here is the numpy pipeline.
"""

from __future__ import annotations

import warnings
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .. import _core, faults

__all__ = ["DataLoader", "prefetch_to_device", "synthetic_dataset"]


class DataLoader:
    """Iterate (x, y) minibatches of in-memory arrays; one iteration is
    one epoch, reshuffled each epoch (seed + epoch).

    The loader keeps an (epoch, batch) cursor: a loop that breaks leaves
    it mid-epoch, and the next ``__iter__`` resumes at the next batch of
    the same permutation instead of reshuffling.  `state_dict` /
    `load_state_dict` carry the cursor across a restart."""

    def __init__(self, x: np.ndarray, y: Optional[np.ndarray] = None,
                 batch_size: int = 32, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, workers: int = 2,
                 prefetch: int = 4, use_native: bool = False, rank: int = 0,
                 world_size: int = 1):
        """rank/world_size: each process loads a contiguous shard of
        exactly floor(n / world_size) samples, so every rank sees the
        same batch count and shapes (up to world_size - 1 trailing
        samples are dropped).  use_native: the native pipeline over
        `workers` threads and a ring of `prefetch` batches; integer
        inputs (token ids) warn and take the numpy pipeline, whose
        buffers keep them integral."""
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            if use_native:
                warnings.warn(
                    "DataLoader(use_native=True) ignored: integer input "
                    "(token ids) routes through the python pipeline — "
                    "the native loader's buffers are f32-typed and "
                    "would corrupt ids", stacklevel=2)
            x = x.astype(np.int32, copy=False)
            use_native = False
        else:
            x = x.astype(np.float32, copy=False)
        y = np.asarray(y, np.int32) if y is not None else None
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world {world_size}")
        if world_size > 1:
            per = len(x) // world_size
            if per == 0:
                raise ValueError(
                    f"dataset of {len(x)} samples shards to 0 per rank "
                    f"at world_size={world_size}; every rank would "
                    f"silently iterate zero batches")
            x = x[rank * per:(rank + 1) * per]
            y = y[rank * per:(rank + 1) * per] if y is not None else None
        self.x, self.y = x, y
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0       # epochs fully consumed
        self._batch_idx = 0   # batches consumed within the current epoch
        self._len_warned = False
        self._native: Optional[_core.NativeLoader] = None
        if use_native:
            self._native = _core.NativeLoader(
                self.x, self.y, batch_size, shuffle=shuffle, seed=seed,
                drop_last=drop_last, workers=workers, prefetch=prefetch)

    def __len__(self) -> int:
        n = len(self.x)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        # "data.next" injection site, once per batch drawn (error/hang
        # before the yield; nan corrupts the yielded float arrays).  The
        # cursor has already advanced, so a caller that retries past an
        # injected error skips that batch
        if self._native is not None:
            yield from self._native_epoch()
            return
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

    def _native_epoch(self):
        """The rest of this epoch from the native loader (its order is
        ``std::mt19937_64(seed + epoch)``'s, not numpy's)."""
        for _ in range(len(self) - self._batch_idx):
            try:
                b = self._native.next()
            except StopIteration:
                # under-delivery (a concurrent close) ends the epoch
                return
            self._batch_idx += 1
            faults.fire("data.next", epoch=self._epoch, batch=self._batch_idx)
            yield faults.corrupt("data.next", b)
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
        shuffle then runs over other data.  The native loader cannot
        seek: a non-zero position warns, closes it and resumes on the
        numpy pipeline, whose order differs from the native one."""
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
        if self._native is not None and (self._epoch or self._batch_idx):
            warnings.warn(
                "DataLoader: native loader cannot seek to a saved "
                "position; resuming on the python pipeline (its shuffle "
                "order differs from the native one — resume is "
                "best-effort, not bit-identical)", stacklevel=2)
            self.close()

    def close(self) -> None:
        """Stop the native loader's threads (idempotent; the numpy
        pipeline holds none)."""
        if self._native is not None:
            self._native.close()
            self._native = None


def prefetch_to_device(it, size: int = 2, device=None):
    """Overlap host->device copies with the card's compute: keep `size`
    batches in flight on the device ahead of the consumer.

    On the card each array is staged in pinned host memory and copied
    with ``non_blocking=True`` on a side stream; before a batch is
    yielded the consumer's current stream waits on an event recorded
    after its copies, and each tensor is ``record_stream``-ed on the
    consumer's stream, so its memory is not reused while the consumer's
    work may still read it.  On the CPU the batches become plain
    tensors.  Works on tuples/lists/dicts of numpy arrays or tensors
    (None passes through); yields the same structure with tensors.
    `device` is a port ``Device`` or a torch device (default: the
    default device)."""
    import collections

    if device is None:
        from ..device import get_default_device
        device = get_default_device()
    dev = torch.device(getattr(device, "torch_device", device))
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if cuda else None

    def to_dev(a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        if not cuda:
            return t.to(dev)
        if t.device.type == "cpu":
            t = t.pin_memory()
        with torch.cuda.stream(side):
            return t.to(dev, non_blocking=True)

    def tree(fn, b):
        if b is None:
            return None
        if isinstance(b, dict):
            return {k: tree(fn, v) for k, v in b.items()}
        if isinstance(b, (tuple, list)):
            return type(b)(tree(fn, v) for v in b)
        return fn(b)

    def put(batch):
        out = tree(to_dev, batch)
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record(side)
        return out, ev

    def ready(item):
        out, ev = item
        if ev is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ev)
            tree(lambda t: t.record_stream(consumer), out)
        return out

    q = collections.deque()
    it = iter(it)
    try:
        for _ in range(max(1, size)):
            q.append(put(next(it)))
    except StopIteration:
        pass
    while q:
        out = q.popleft()
        try:
            q.append(put(next(it)))
        except StopIteration:
            pass
        yield ready(out)


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
