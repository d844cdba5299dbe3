"""Host-sharded, prefetching batch pipeline: HDF5 datasets -> stacked numpy
batches (``poseidon_tpu/data/loader.py`` in the port). Batches stay numpy;
the Trainer moves them to the device.

Replaces the reference's torch DataLoader workers (SURVEY.md §3.5) with a
thread pool (h5py releases the GIL during reads) plus a bounded prefetch
queue. Iteration order is deterministic given (seed, epoch) and identical
across hosts; each host materializes only its slice of every global batch, so
scaling out hosts never changes the math.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np


def _collate(samples) -> Dict[str, np.ndarray]:
    from .native import collate_stack

    out: Dict[str, np.ndarray] = {}
    first = samples[0]
    for key in first:
        vals = [np.asarray(s[key]) for s in samples]
        if key == "pixel_mask":
            out[key] = np.stack(vals).astype(np.bool_)
        elif vals[0].ndim >= 1:
            # hot path: OpenMP-parallel stack via the native collate library
            # (falls back to numpy when native/ isn't built)
            out[key] = collate_stack(vals)
        else:
            out[key] = np.stack(vals).astype(np.float32)
    if "time" not in out:
        out["time"] = np.zeros(len(samples), np.float32)
    out["time"] = np.asarray(out["time"], np.float32).reshape(len(samples))
    return out


class DataLoader:
    """Deterministic, host-sharded loader.

    Args:
        dataset: indexable dataset returning sample dicts.
        batch_size: GLOBAL batch size (summed over hosts).
        shuffle: reshuffle each epoch with seed (seed, epoch).
        drop_last: drop the trailing partial batch (training). When False
          (eval), the final batch is padded by repeating the last sample and
          the true count is reported in the "_valid" entry.
        num_hosts / host_id: data-parallel host sharding of each global batch.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_hosts: int = 1,
        host_id: int = 0,
        num_workers: int = 8,
        prefetch: int = 4,
    ):
        if batch_size % num_hosts != 0:
            raise ValueError(f"global batch {batch_size} not divisible by {num_hosts} hosts")
        self.dataset = dataset
        self.batch_size = batch_size
        self.local_batch = batch_size // num_hosts
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.num_workers = num_workers
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
            return rng.permutation(n)
        return np.arange(n)

    def _batch_index_lists(self, epoch: int):
        idx = self._epoch_indices(epoch)
        n = len(idx)
        nb = len(self)
        for b in range(nb):
            lo = b * self.batch_size
            global_batch = idx[lo: lo + self.batch_size]
            valid = len(global_batch)
            if valid < self.batch_size:  # only when drop_last=False
                pad = np.repeat(global_batch[-1:], self.batch_size - valid)
                global_batch = np.concatenate([global_batch, pad])
            local = global_batch[self.host_id * self.local_batch:
                                 (self.host_id + 1) * self.local_batch]
            # valid count within THIS host's slice, plus the global count
            lo_v = self.host_id * self.local_batch
            local_valid = int(np.clip(valid - lo_v, 0, self.local_batch))
            yield local, local_valid, valid

    def epoch(self, epoch: int = 0,
              start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield host-local batches for one epoch, with background prefetch.

        ``start_batch`` skips the first N batches WITHOUT reading their data
        (index lists are pure numpy slicing) — the loader-position half of
        step-granular resume: iteration order is deterministic given
        (seed, epoch), so batch ``start_batch`` here is bit-identical to the
        one an uninterrupted run would have seen."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        SENTINEL = object()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for bnum, (local_idx, valid, valid_global) in enumerate(
                            self._batch_index_lists(epoch)):
                        if stop.is_set():
                            return
                        if bnum < start_batch:
                            continue
                        samples = list(pool.map(self.dataset.__getitem__, local_idx))
                        batch = _collate(samples)
                        batch["_valid"] = np.int32(valid)
                        batch["_valid_global"] = np.int32(valid_global)
                        q.put(batch)
            except Exception as e:  # surface worker errors to the consumer
                q.put(e)
            finally:
                q.put(SENTINEL)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is SENTINEL:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # Drain so the producer can exit.
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
