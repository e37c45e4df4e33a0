"""Prefetching host data loader (port of ``transfusion_tpu/data/loader.py``).

Replaces the reference's torch DataLoader (6 workers, prefetch_factor 3,
``runner/run_experiment.py:376-395``) with a pooled pipeline: JPEG decode +
augmentation fan out over a persistent thread pool (PIL/cv2 and large-array
numpy ufuncs release the GIL) or, with ``worker_type="process"`` (or
``TRANSFUSION_LOADER_WORKERS=process``), a fork-based process pool for
GIL-free decode; batches assemble into numpy arrays and a
background thread keeps a bounded queue ahead of the device step. Sharding
over processes is by index stride; the order, the per-batch bucket and the
per-example seeds are the JAX loader's for the same seed and epoch. A batch
that fails in the producer thread raises in the consumer (the JAX loader ends
the epoch there without an error).

``rank_slice=(rank, world)`` is the data-parallel mode: the loader walks the
one-rank run's global batches (order, bucket and per-example seeds drawn as
there) and yields rank ``rank``'s contiguous slice of each, decoding only
those examples. A short batch (``drop_last`` off) is first padded to a
multiple of ``world`` by repeating its last example, as the JAX trainer
pads before sharding; ``batch["n_real"]`` counts the slice's rows that are
not padding.

The process pool forks the caller, as the JAX loader does, so the workers
share the dataset's pages without pickling it; each worker calls only the
dataset's ``get_example`` (numpy, Pillow, OpenCV) and never touches a
tensor, so a parent that has initialised CUDA forks safely.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from transfusion_torch.data.dataset import EgoNaoDataset, collate

# Process-pool plumbing: the dataset reaches each worker once (through the
# fork), then each item sends only (idx, seed, bucket, training).
_WORKER_DS: EgoNaoDataset | None = None


def _init_worker(dataset):
    global _WORKER_DS
    _WORKER_DS = dataset


def _worker_get_example(args):
    idx, seed, bucket, training = args
    return _WORKER_DS.get_example(int(idx), np.random.default_rng(seed), bucket, training)


class DataLoader:
    def __init__(
        self,
        dataset: EgoNaoDataset,
        batch_size: int,
        tokenizer=None,
        training: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 2,
        shard_index: int = 0,
        num_shards: int = 1,
        lang_max_length: int = 128,
        drop_last: bool | None = None,
        rank_slice: tuple[int, int] | None = None,
        worker_type: str | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self.training = training
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.lang_max_length = lang_max_length
        self.drop_last = training if drop_last is None else drop_last
        self.rank_slice = rank_slice
        self.epoch = 0
        # One persistent decode pool per loader (the reference's torch
        # DataLoader keeps 6 workers alive, run_experiment.py:376-395).
        self.worker_type = worker_type or os.environ.get("TRANSFUSION_LOADER_WORKERS", "thread")
        if self.worker_type == "process":
            import multiprocessing as mp

            self._pool = ProcessPoolExecutor(
                max_workers=num_workers, mp_context=mp.get_context("fork"),
                initializer=_init_worker, initargs=(dataset,))
        elif self.worker_type == "thread":
            self._pool = ThreadPoolExecutor(max_workers=num_workers)
        else:
            raise ValueError(f"worker_type {self.worker_type!r}: 'thread' or 'process'")
        # host-side input timing: seconds spent decoding+collating per batch
        # (consumed by the trainer for history.jsonl input/step accounting).
        self.decode_times: list[float] = []

    def __len__(self):
        n = len(range(self.shard_index, len(self.dataset), self.num_shards))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.training:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx[self.shard_index :: self.num_shards]

    def _make_batch(self, rng: np.random.Generator, indices: np.ndarray) -> dict:
        t0 = time.perf_counter()
        buckets = self.dataset.aug.buckets
        bucket = buckets[rng.integers(len(buckets))] if self.training else self.dataset.aug.eval_bucket()
        seeds = [int(rng.integers(2**31)) for _ in indices]
        n_real = len(indices)
        if self.rank_slice is not None:
            rank, world = self.rank_slice
            pad = (-len(indices)) % world
            indices = list(indices) + [indices[-1]] * pad
            seeds = seeds + [seeds[-1]] * pad
            b = len(indices) // world
            indices, seeds = indices[rank * b:(rank + 1) * b], seeds[rank * b:(rank + 1) * b]
            n_real = max(min(n_real - rank * b, b), 0)
        if self.worker_type == "process":
            samples = list(self._pool.map(
                _worker_get_example,
                [(int(i), s, bucket, self.training) for i, s in zip(indices, seeds)],
                chunksize=max(1, len(indices) // (4 * self.num_workers))))
        else:
            samples = list(self._pool.map(
                lambda iw: self.dataset.get_example(
                    int(iw[0]), np.random.default_rng(iw[1]), bucket, self.training),
                zip(indices, seeds)))
        batch = collate(samples, self.tokenizer, self.lang_max_length)
        batch["image_hw"] = bucket
        if self.rank_slice is not None:
            batch["n_real"] = n_real
        self.decode_times.append(time.perf_counter() - t0)
        return batch

    def close(self):
        self._pool.shutdown(wait=False)

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self._pool.shutdown(wait=False)
        except Exception:
            pass

    def __iter__(self):
        indices = self._epoch_indices()
        n = len(indices)
        steps = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        rng = np.random.default_rng((self.seed, self.epoch, self.shard_index))
        self.epoch += 1

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for s in range(steps):
                    if stop.is_set():
                        return
                    chunk = indices[s * self.batch_size : (s + 1) * self.batch_size]
                    q.put(self._make_batch(rng, chunk))
            except BaseException as e:  # re-raised by the consumer, not swallowed
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
