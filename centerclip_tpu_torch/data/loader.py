# coding=utf-8
"""Batch loader: shuffling, per-process sharding, threaded prefetch, pinned
host memory (port of the JAX package's `data/loader.py`).

Replaces torch DataLoader + DistributedSampler
(reference: dataloaders/data_dataloaders.py:26-39): a seeded per-epoch
shuffle, a contiguous-strided per-process shard, a thread pool decoding
samples ahead of the training step, and fixed-shape numpy collation.  With
`pin_memory` (PyTorch DataLoader's idiom) the producer thread hands out
each batch's arrays as tensors in pinned host memory, so the trainer's
`non_blocking=True` copy to the card is asynchronous: the port's
counterpart of JAX's asynchronously dispatched `device_put`.  The
consumer's wait for each batch is a `data.wait` span (`ready`: the batch was
there when asked; `depth`: the threaded queue's batches), the worker's
gather or decode a `data.gather` span (`utils/spans.py`).
"""
from __future__ import annotations

import copy
import queue
import threading
from typing import Dict, Iterator, List

import numpy as np
import torch

from ..utils.spans import span


def collate(samples) -> Dict[str, np.ndarray]:
    """Stack dict samples into batch arrays [B, ...]."""
    out = {}
    for key in samples[0]:
        out[key] = np.stack([s[key] for s in samples], axis=0)
        if out[key].ndim >= 2 and out[key].shape[1] == 1 \
                and key != "video":
            # squeeze the pair axis for text fields: [B, 1, L] -> [B, L]
            out[key] = out[key][:, 0]
    if "video_mask" in out and out["video_mask"].ndim == 3:
        out["video_mask"] = out["video_mask"][:, 0]
    return out


def pin_batch(batch) -> Dict[str, torch.Tensor]:
    """Every array of a batch as a tensor in pinned host memory (a tensor
    already pinned is kept as it is).  Needs a CUDA device."""
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(value)
        out[key] = t if t.is_pinned() else t.pin_memory()
    return out


def _wait(fut):
    """The batch of a gather under way, in a `data.wait` span whose
    `ready` says whether the gather had finished when asked."""
    with span("data.wait", ready=fut.done()):
        return fut.result()


class BatchLoader:
    """Iterable over collated batches.

    Args:
        dataset: indexable with dict samples.
        batch_size: per-process batch size.
        shuffle: seeded shuffle, re-derived per epoch via `set_epoch`
            (DistributedSampler.set_epoch semantics, main.py:245-246).
        drop_last: drop the ragged tail (train) or keep it (eval).
        num_threads: decode worker threads (the reference's
            num_thread_reader processes; threads suffice since decode is
            C-bound in the reader, numpy or PIL, which release the GIL).
        process_index/process_count: multi-process sharding.
        pin_memory: hand out tensors in pinned host memory instead of numpy
            arrays (only with a CUDA device).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_threads: int = 0,
                 seed: int = 42, process_index: int = 0,
                 process_count: int = 1, prefetch: int = 2,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.seed = seed
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = max(prefetch, 1)
        self.pin_memory = pin_memory
        self.batch_stride = (0, 1)

    def strided(self, index: int, count: int) -> "BatchLoader":
        """A copy of this loader that loads and yields only its batches i
        with i % count == index (a spread evaluation: each rank reads
        only the batches it encodes)."""
        other = copy.copy(self)
        other.batch_stride = (index, count)
        return other

    def batch_sizes(self) -> List[int]:
        """The row count of each batch this loader yields, in order; no
        sample is loaded."""
        return [len(c) for c in self._batches_of_indices()]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        # the dataset's augmentation RNG is keyed by (seed, epoch, sample)
        # so threaded decode stays run-to-run deterministic
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.process_count > 1:
            # DistributedSampler semantics (reference
            # data_dataloaders.py:26-39): pad with wrapped-around indices so
            # every process gets the SAME number of samples — unequal shard
            # lengths would desync per-process step counts and hang the
            # collectives.
            per = -(-n // self.process_count)  # ceil
            total = per * self.process_count
            if total > n:
                order = np.concatenate([order, order[:total - n]])
            order = order[self.process_index::self.process_count]
            assert len(order) == per
        return order

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            n = n // self.batch_size
        else:
            n = (n + self.batch_size - 1) // self.batch_size
        index, count = self.batch_stride
        return len(range(index, n, count))

    def _batches_of_indices(self):
        idx = self._indices()
        index, count = self.batch_stride
        for i, s in enumerate(range(0, len(idx), self.batch_size)):
            chunk = idx[s:s + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            if i % count == index:
                yield chunk

    def _collate(self, samples):
        batch = collate(samples)
        return pin_batch(batch) if self.pin_memory else batch

    def _gather(self, chunk):
        """The batched fast path's whole-batch gather, on its worker."""
        with span("data.gather"):
            return self.dataset.get_batch(chunk, pin_memory=self.pin_memory)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if hasattr(self.dataset, "get_batch"):
            # batched fast path (FrameStoreClipDataset): whole-batch native
            # gather with one batch of lookahead so the host gather overlaps
            # device compute
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=1) as pool:
                fut = None
                for chunk in self._batches_of_indices():
                    nxt = pool.submit(self._gather, chunk)
                    if fut is not None:
                        yield _wait(fut)
                    fut = nxt
                if fut is not None:
                    yield _wait(fut)
            return
        if self.num_threads <= 0:
            for chunk in self._batches_of_indices():
                yield self._collate([self.dataset[int(i)] for i in chunk])
            return
        yield from self._threaded_iter()

    def _threaded_iter(self):
        """A producer thread decodes batches ahead into a bounded queue.  A
        sample that raises ends the epoch with that exception in the
        consumer (the producer hands it over instead of dying silently and
        leaving the consumer waiting); a consumer that stops early stops the
        producer."""
        from concurrent.futures import ThreadPoolExecutor
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                    for chunk in self._batches_of_indices():
                        with span("data.gather"):
                            batch = self._collate(list(pool.map(
                                lambda i: self.dataset[int(i)], chunk)))
                        if not put(batch):
                            return
                put(done)
            except Exception as e:            # handed to the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                with span("data.wait", ready=not q.empty(),
                          depth=q.qsize()):
                    item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
