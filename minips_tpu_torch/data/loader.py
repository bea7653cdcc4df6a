"""Batch iteration and device prefetch — the port of
``minips_tpu/data/loader.py``.

Batches are assembled on the host with numpy, exactly as the JAX package
assembles them (the same permutation from the same seed, so the two give
bit-identical batches), then copied to the device ahead of the consumer by
a producer thread: each array is pinned and copied with
``non_blocking=True`` on a copy stream of its own, so step N+1's host to
device copy overlaps step N's compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from minips_tpu_torch.parallel.mesh import DeviceLike, resolve_device
from minips_tpu_torch.utils.tree import tree_leaves, tree_map


class BatchIterator:
    """Infinite shuffled minibatches over a dict of equal-length arrays.

    ``drop_last=True`` (default) yields only full batches;
    ``drop_last=False`` also yields the ragged tail batch each epoch
    (useful for evaluation sweeps).
    """

    def __init__(self, data: dict, batch_size: int, *, seed: int = 0,
                 drop_last: bool = True):
        self.data = {k: np.asarray(v) for k, v in data.items()}
        lens = {len(v) for v in self.data.values()}
        if len(lens) != 1:
            raise ValueError("all arrays must share length")
        self.n = lens.pop()
        if batch_size > self.n:
            raise ValueError(f"batch_size {batch_size} > dataset size {self.n}")
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[dict]:
        """The same infinite stream, starting at batch ``start_batch`` —
        the resume fast-forward. Skipped epochs cost one RNG permutation
        draw each (O(n) ints), not ``start_batch`` full batch copies."""
        end = (self.n - self.batch_size + 1 if self.drop_last else self.n)
        starts = range(0, end, self.batch_size)
        per_epoch = len(starts)
        skip_epochs, skip_batches = divmod(start_batch, per_epoch)
        for _ in range(skip_epochs):
            self._rng.permutation(self.n)  # advance the stream's RNG only
        while True:
            perm = self._rng.permutation(self.n)
            for s in starts[skip_batches:]:
                sel = perm[s: s + self.batch_size]
                yield {k: v[sel] for k, v in self.data.items()}
            skip_batches = 0


_POISON = object()


def prefetch_to_device(it, device: DeviceLike = None, depth: int = 2):
    """Copy each batch of ``it`` (a tree of numpy arrays or tensors) to
    ``device`` (the card by default) on a producer thread, keeping
    ``depth`` batches in flight ahead of the consumer. On the card the
    producer pins each array and copies it with ``non_blocking=True`` on a
    copy stream; the consumer's stream waits for that copy before the
    batch is handed over. Producer errors re-raise in the consumer; an
    early consumer exit releases the producer (no thread left parked on a
    full queue)."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(batch):
        if not cuda:
            return tree_map(lambda x: torch.as_tensor(np.asarray(x))
                            .to(device), batch), None
        with torch.cuda.stream(copy_stream):
            out = tree_map(lambda x: torch.as_tensor(np.asarray(x))
                           .pin_memory().to(device, non_blocking=True), batch)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def _put(item) -> bool:
        """Blocking put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for item in it:
                if stop.is_set() or not _put(("item", put(item))):
                    return
            _put((_POISON, None))
        except BaseException as e:  # re-raised consumer-side
            _put(("error", e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            kind, item = q.get()
            if kind is _POISON:
                return
            if kind == "error":
                raise item
            batch, done = item
            if done is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                for x in tree_leaves(batch):
                    # the copy stream's memory is now read on this stream
                    x.record_stream(stream)
            yield batch
    finally:
        stop.set()
