"""Datasets, samplers and the DataLoader of the port (counterpart of
paddle_tpu/io/__init__.py; reference python/paddle/fluid/reader.py:146 and
python/paddle/fluid/dataloader/).

The loader's workers are threads, as in the JAX package, not
``torch.utils.data``'s processes: with ``num_workers > 0`` a pool runs
dataset fetch and collate ahead of the consumer into a bounded queue
(``num_workers * prefetch_factor`` batches), delivers the batches in the
sampler's order whatever the workers' timing, re-raises a worker's
exception at the consumer's ``next()``, and stops cooperatively on
``close()`` (also at garbage collection).

Workers collate into host tensors (``default_collate_fn``: numpy f64 as
f32, Python ints as int64, Python floats as f32), pinned when the loader's
device is the card. The iterator moves each batch to the device on the
consumer's thread with ``non_blocking=True``. ``device`` is resolved by
``resolve_device`` (the card unless ``device="cpu"`` is asked for);
``places`` is its alias, as the reference names it.

``RandomSampler`` draws from its ``generator`` (a ``torch.Generator``);
without one it makes its own, seeded with ``DEFAULT_SEED``, so one
sampler's epochs differ and two samplers built alike repeat each other.
The JAX package ignores that argument and seeds from its global seed plus
the sampler's ``id`` (ROADMAP.md, "Deliberate differences").
``random_split`` and ``WeightedRandomSampler`` draw from numpy's
``RandomState(0)`` as the JAX package does, so both packages give the same
indices; so does ``DistributedBatchSampler``, seeded by its epoch.
"""
from __future__ import annotations

import itertools
import math
import queue as queue_mod
import threading
import time

import numpy as np
import torch

from ..device import resolve_device

#: the seed of a RandomSampler built without a generator
DEFAULT_SEED = 0
#: how long a blocked put or get waits before it looks at the stop flag again
_POLL_S = 0.1


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of the given lengths over one ``RandomState(0)`` permutation
    (the JAX package's draw; ``generator`` is accepted and not read, as
    there)."""
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths must equal dataset size")
    perm = np.random.RandomState(0).permutation(len(dataset)).tolist()
    out = []
    off = 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n]))
        off += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation (or, with ``replacement``, uniform draws) of the
    indices from ``generator``; its own generator seeded with
    ``DEFAULT_SEED`` when None (module docstring)."""

    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)
        self.generator = (generator if generator is not None
                          else torch.Generator().manual_seed(DEFAULT_SEED))

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            idx = torch.randint(0, n, (self.num_samples,), generator=self.generator)
        else:
            idx = torch.randperm(n, generator=self.generator)[: self.num_samples]
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        rng = np.random.RandomState(0)
        return iter(rng.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """This rank's batches of an epoch (reference
    python/paddle/fluid/dataloader/batch_sampler.py): the indices, shuffled
    by ``RandomState(epoch)`` when asked, padded to a multiple of the ranks
    and strided by rank. Rank and world default to the distributed
    environment's (distributed/env.py)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None, shuffle=False,
                 drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle
        if num_replicas is None or rank is None:
            from ..distributed.env import get_rank, get_world_size

            num_replicas = get_world_size() if num_replicas is None else num_replicas
            rank = get_rank() if rank is None else rank
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = list(range(n))
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        indices += indices[: (self.total_size - n)]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    """Samples stacked into host tensors: torch tensors stacked, numpy
    arrays stacked (f64 as f32), Python or numpy ints as int64 and floats
    as f32; tuples, lists and dicts field by field; anything else as the
    list it came in."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn([b[i] for b in batch]) for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        arr = np.stack(batch)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return torch.from_numpy(arr)
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, np.float32))
    return batch


def _map_tensors(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def _pinned(collate_fn):
    """``collate_fn`` whose host tensors come out in pinned memory."""
    def collate(batch):
        return _map_tensors(collate_fn(batch),
                            lambda t: t if t.is_cuda or t.is_pinned() else t.pin_memory())
    return collate


def _put(q, item, stop):
    """Put ``item`` unless ``stop`` is set first; True when it was put."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue_mod.Full:
            continue
    return False


def _get(q, alive, timeout):
    """The next item of ``q``; raises when ``alive()`` turns false with the
    queue empty (the producers ended without a word) or after ``timeout``
    seconds (0: no limit)."""
    deadline = time.monotonic() + timeout if timeout else None
    while True:
        try:
            return q.get(timeout=_POLL_S)
        except queue_mod.Empty:
            if not alive() and q.empty():
                raise RuntimeError("the DataLoader's workers ended without a batch")
            if deadline is not None and time.monotonic() > deadline:
                raise RuntimeError(f"the DataLoader waited more than {timeout} s "
                                   "for a batch")


class _PrefetchIterator:
    """One background producer thread filling a bounded queue ahead of the
    consumer, who pays only the residual wait. A producer exception is
    re-raised at the consumer's next(); close() (also at garbage
    collection) stops the producer even when the consumer leaves the
    epoch half read."""

    _DONE = object()

    def __init__(self, it, depth=2, timeout=0):
        self._q = queue_mod.Queue(maxsize=max(1, depth))
        self._it = it
        self._timeout = timeout
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="paddle_tpu_torch-io-prefetch")
        self._thread.start()

    def _worker(self):
        try:
            for item in self._it:
                if not _put(self._q, item, self._stop):
                    return
        except BaseException as e:  # re-raised at the consumer
            _put(self._q, _WorkerError(e), self._stop)
            return
        _put(self._q, self._DONE, self._stop)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = _get(self._q, self._thread.is_alive, self._timeout)
        if item is self._DONE:
            self.close()
            raise StopIteration
        if isinstance(item, _WorkerError):
            self.close()
            raise item.exc
        return item

    def close(self):
        self._stop.set()
        while True:  # unblock a producer stuck on a full queue
            try:
                self._q.get_nowait()
            except queue_mod.Empty:
                break
        if self._thread.is_alive() and self._thread is not threading.current_thread():
            self._thread.join(timeout=1.0)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _WorkerError:
    """Carries a worker's exception to the consumer, in batch order."""

    def __init__(self, exc):
        self.exc = exc


class _OrderedWorkerPool:
    """``num_workers`` threads run dataset fetch and collate ahead of the
    consumer. Each pulls a (batch_id, indices) task, collates it and puts it
    into a bounded output queue (``num_workers * prefetch_factor`` deep);
    the consumer reorders by batch_id, so delivery follows the sampler
    whatever the workers' timing. close() (also at garbage collection) sets
    a stop flag that the task pull and the output put both read, then joins
    the threads."""

    def __init__(self, dataset, batches, collate_fn, num_workers, prefetch_factor,
                 timeout=0):
        self._dataset = dataset
        self._collate_fn = collate_fn
        self._timeout = timeout
        self._n_batches = len(batches)
        self._task_q = queue_mod.Queue()
        for task in enumerate(batches):
            self._task_q.put(task)
        self._out_q = queue_mod.Queue(maxsize=max(1, num_workers * max(1, prefetch_factor)))
        self._stop = threading.Event()
        self._pending = {}
        self._next_bid = 0
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"paddle_tpu_torch-io-worker-{i}")
            for i in range(max(1, num_workers))]
        for t in self._threads:
            t.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                bid, indices = self._task_q.get_nowait()
            except queue_mod.Empty:
                return
            try:
                item = self._collate_fn([self._dataset[i] for i in indices])
            except BaseException as e:
                item = _WorkerError(e)
            if not _put(self._out_q, (bid, item), self._stop):
                return

    def _alive(self):
        return any(t.is_alive() for t in self._threads)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set() or self._next_bid >= self._n_batches:
            self.close()
            raise StopIteration
        # every task gives one queue item, and tasks are taken in order, so
        # next_bid is always among the batches in flight
        while self._next_bid not in self._pending:
            bid, item = _get(self._out_q, self._alive, self._timeout)
            self._pending[bid] = item
        item = self._pending.pop(self._next_bid)
        self._next_bid += 1
        if isinstance(item, _WorkerError):
            self.close()
            raise item.exc
        return item

    def close(self):
        self._stop.set()
        while True:  # unblock workers stuck on a full output queue
            try:
                self._out_q.get_nowait()
            except queue_mod.Empty:
                break
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=1.0)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _DeviceIterator:
    """The loader's iterator: each batch of ``inner`` moved to ``device`` on
    the consumer's thread (``non_blocking``: the host tensors are pinned
    when the device is the card). ``close()`` stops ``inner``'s threads."""

    def __init__(self, inner, device):
        self._inner = inner
        self._device = device

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._inner)
        return _map_tensors(batch, lambda t: t.to(self._device, non_blocking=True))

    def close(self):
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()


def _device_of(device, places):
    """``device``, else ``places`` (the reference's name: a device, a
    string such as ``"gpu:0"``, or a list of them, of which the first)."""
    if device is None and places is not None:
        device = places[0] if isinstance(places, (list, tuple)) else places
        if isinstance(device, str) and device.startswith("gpu"):
            device = "cuda" + device[3:]
    return resolve_device(device)


class DataLoader:
    """Batches of ``dataset`` on ``device`` (module docstring). The
    reference's ``feed_list``, ``return_list``, ``use_shared_memory``,
    ``worker_init_fn`` and ``persistent_workers`` are accepted and not
    read; ``timeout`` (seconds, 0 for none) bounds the wait for a batch
    from the worker threads."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 prefetch_factor=2, use_shared_memory=True, timeout=0,
                 worker_init_fn=None, persistent_workers=False, device=None):
        self.dataset = dataset
        self.device = _device_of(device, places)
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_buffer_reader = use_buffer_reader
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size, drop_last=drop_last)

    def _collate(self):
        return _pinned(self.collate_fn) if self.device.type == "cuda" else self.collate_fn

    def _iter_batches(self, collate):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield collate(batch)
        else:
            for indices in self.batch_sampler:
                yield collate([self.dataset[i] for i in indices])

    def __iter__(self):
        # num_workers > 0: the ordered pool; an iterable dataset cannot be
        # split by index, so it keeps one producer thread
        collate = self._collate()
        if self.num_workers > 0 and not self._iterable_mode:
            inner = _OrderedWorkerPool(self.dataset, list(self.batch_sampler), collate,
                                       self.num_workers, self.prefetch_factor, self.timeout)
        elif self.num_workers > 0 or self.use_buffer_reader:
            inner = _PrefetchIterator(self._iter_batches(collate), depth=self.prefetch_factor,
                                      timeout=self.timeout)
        else:
            inner = self._iter_batches(collate)
        return _DeviceIterator(inner, self.device)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no length")
        return len(self.batch_sampler)


def get_worker_info():
    """None: the workers are threads of this process (the JAX package's
    answer too)."""
    return None


__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset", "ChainDataset",
           "Subset", "random_split", "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
           "default_collate_fn", "DataLoader", "get_worker_info"]
