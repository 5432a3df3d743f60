"""paddle_tpu_torch.io against paddle_tpu.io on the CPU: the samplers' index
streams, ``random_split``, the datasets' containers, ``default_collate_fn``'s
dtypes, the DataLoader's batches (exactly: the same numpy samples, collated
without arithmetic but f64 -> f32), and the thread pool's order, error
re-raise and shutdown.

The JAX package's ``RandomSampler`` seeds from its global seed and the
sampler's ``id`` (ROADMAP.md, "Deliberate differences"), so no check here
compares a ``shuffle=True`` stream across the packages: the shuffled
streams compared are ``DistributedBatchSampler``'s (``RandomState(epoch)``)
and fixed lists of index lists. Every loader iterator is closed and every
wait has a limit (the DataLoader's ``timeout``); torch runs on one intra-op
thread.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu_torch.io as pio
from paddle_tpu.vision.datasets import MNIST as JaxMNIST
from paddle_tpu_torch.vision.datasets import MNIST

torch.set_num_threads(1)
WAIT_S = 30   # the loaders' timeout: no batch here takes a second


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return x


def _batches(loader):
    """Every batch of ``loader`` as numpy, the iterator closed after."""
    it = iter(loader)
    try:
        return [[_host(t) for t in b] if isinstance(b, (list, tuple)) else _host(b)
                for b in it]
    finally:
        if hasattr(it, "close"):
            it.close()


class Squares(pio.Dataset):
    """Item i: (f64 [3] of i, i as a Python int); optional delays and a
    failing index."""

    def __init__(self, n=10, delay=None, fail_at=None):
        self.n, self.delay, self.fail_at = n, delay, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.delay is not None:
            time.sleep(self.delay(i))
        if i == self.fail_at:
            raise ValueError(f"bad sample {i}")
        return np.full(3, float(i * i)), int(i)


# ------------------------------------------------------------ samplers

@pytest.mark.parametrize("n,bs,drop", [(10, 3, False), (10, 3, True), (12, 4, False)])
def test_sequence_and_batch_samplers_match(n, bs, drop):
    ds = list(range(n))
    for pkg in (pio, jio):
        assert list(pkg.SequenceSampler(ds)) == list(range(n))
    got = list(pio.BatchSampler(ds, batch_size=bs, drop_last=drop))
    assert got == list(jio.BatchSampler(ds, batch_size=bs, drop_last=drop))
    assert len(pio.BatchSampler(ds, batch_size=bs, drop_last=drop)) == len(got)


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("shuffle", [False, True])
def test_distributed_batch_sampler_streams_match(world, shuffle):
    ds = list(range(23))
    for epoch in (0, 1, 5):
        for rank in range(world):
            p = pio.DistributedBatchSampler(ds, 4, num_replicas=world, rank=rank,
                                            shuffle=shuffle, drop_last=epoch == 5)
            j = jio.DistributedBatchSampler(ds, 4, num_replicas=world, rank=rank,
                                            shuffle=shuffle, drop_last=epoch == 5)
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(p) == list(j)
            assert len(p) == len(j)


def test_distributed_batch_sampler_reads_the_environment(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    s = pio.DistributedBatchSampler(list(range(10)), 2)
    assert (s.local_rank, s.nranks) == (1, 3)
    assert list(s) == [[1, 4], [7, 0]]


def test_weighted_sampler_and_random_split_draw_what_the_jax_package_draws():
    w = [0.1, 0.5, 0.2, 0.2, 1.0]
    for repl in (True, False):
        assert list(pio.WeightedRandomSampler(w, 4, replacement=repl)) == list(
            jio.WeightedRandomSampler(w, 4, replacement=repl))
    ds = list(range(17))
    got = [list(s) for s in pio.random_split(ds, [5, 7, 5])]
    want = [list(s) for s in jio.random_split(ds, [5, 7, 5])]
    assert got == want and sorted(sum(got, [])) == ds
    with pytest.raises(ValueError):
        pio.random_split(ds, [5, 5])


def test_random_sampler_draws_from_its_generator():
    ds = list(range(50))
    a, b = pio.RandomSampler(ds), pio.RandomSampler(ds)
    first = list(a)
    assert first == list(b) and sorted(first) == ds   # the default seed, a permutation
    assert list(a) != first                            # the next epoch differs
    g = torch.Generator().manual_seed(7)
    want = torch.randperm(50, generator=torch.Generator().manual_seed(7)).tolist()
    assert list(pio.RandomSampler(ds, generator=g)) == want
    r = list(pio.RandomSampler(ds, replacement=True, num_samples=80))
    assert len(r) == 80 and all(0 <= i < 50 for i in r)
    assert len(pio.BatchSampler(ds, shuffle=True, batch_size=8)) == 7


# ------------------------------------------------------------ datasets

def test_dataset_containers_match():
    a = np.arange(12).reshape(6, 2)
    b = np.arange(6) * 10
    p, j = pio.TensorDataset([a, b]), jio.TensorDataset([a, b])
    assert len(p) == len(j) == 6
    for i in range(6):
        for x, y in zip(p[i], j[i]):
            np.testing.assert_array_equal(x, y)
    pc = pio.ComposeDataset([pio.TensorDataset([a]), pio.TensorDataset([b[:4]])])
    jc = jio.ComposeDataset([jio.TensorDataset([a]), jio.TensorDataset([b[:4]])])
    assert len(pc) == len(jc) == 4
    for i in range(4):
        assert [np.asarray(v).tolist() for v in pc[i]] == [np.asarray(v).tolist() for v in jc[i]]
    ps, js = pio.Subset(list("abcdef"), [5, 0, 2]), jio.Subset(list("abcdef"), [5, 0, 2])
    assert [ps[i] for i in range(3)] == [js[i] for i in range(3)] == ["f", "a", "c"]

    class Count(pio.IterableDataset):
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            return iter(range(self.n))

    assert list(iter(pio.ChainDataset([Count(3), Count(2)]))) == [0, 1, 2, 0, 1]
    with pytest.raises(RuntimeError):
        Count(1)[0]


# ------------------------------------------------------------ collate

def test_default_collate_dtypes_match():
    cases = {
        "f64": [np.ones(3), np.zeros(3)],
        "f32": [np.ones((2, 2), np.float32)] * 2,
        "u8": [np.arange(4, dtype=np.uint8)] * 3,
        "i64": [np.arange(2)] * 2,
        "int": [1, 2, 3],
        "np_int": [np.int32(1), np.int32(5)],
        "float": [0.5, 1.5],
    }
    for name, batch in cases.items():
        got = pio.default_collate_fn(batch)
        want = jio.default_collate_fn(batch)
        assert isinstance(got, torch.Tensor) and not got.is_pinned(), name
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=name)
        assert got.numpy().dtype == np.asarray(want.numpy()).dtype, name
    nested = [{"x": np.ones(2), "y": (1, 2.0)}, {"x": np.zeros(2), "y": (3, 4.0)}]
    got, want = pio.default_collate_fn(nested), jio.default_collate_fn(nested)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["x"].numpy(), want["x"].numpy())
    assert [t.dtype for t in got["y"]] == [torch.int64, torch.float32]
    assert pio.default_collate_fn(["a", "b"]) == ["a", "b"]
    t = pio.default_collate_fn([torch.ones(2, dtype=torch.float16)] * 3)
    assert t.shape == (3, 2) and t.dtype == torch.float16


# ------------------------------------------------------------ the loader

def _mnist_pair(size=256):
    return MNIST(mode="train", size=size), JaxMNIST(mode="train", size=size)


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_equal_the_jax_loaders(workers):
    pds, jds = _mnist_pair()
    fixed = [[5, 1, 200], [7, 8, 9, 10], [255, 0]]
    for sampler in (fixed, "dist"):
        if sampler == "dist":
            ps = pio.DistributedBatchSampler(pds, 64, num_replicas=1, rank=0, shuffle=True)
            js = jio.DistributedBatchSampler(jds, 64, num_replicas=1, rank=0, shuffle=True)
            ps.set_epoch(3)
            js.set_epoch(3)
        else:
            ps = js = fixed
        got = _batches(pio.DataLoader(pds, batch_sampler=ps, num_workers=workers,
                                      device="cpu", timeout=WAIT_S))
        want = _batches(jio.DataLoader(jds, batch_sampler=js, num_workers=workers))
        assert len(got) == len(want) > 0
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.dtype == np.float32 and gy.dtype == np.int64
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("drop", [False, True])
def test_iterable_dataset_loader_matches(drop):
    class Count(pio.IterableDataset):
        def __iter__(self):
            return iter(range(10))

    class JCount(jio.IterableDataset):
        def __iter__(self):
            return iter(range(10))

    got = _batches(pio.DataLoader(Count(), batch_size=4, drop_last=drop, device="cpu",
                                  num_workers=1, timeout=WAIT_S))
    want = _batches(jio.DataLoader(JCount(), batch_size=4, drop_last=drop, num_workers=1))
    assert [g.tolist() for g in got] == [np.asarray(w).tolist() for w in want]
    with pytest.raises(TypeError):
        len(pio.DataLoader(Count(), batch_size=4, device="cpu"))


def test_loader_places_alias_and_card_default(monkeypatch):
    ds = Squares(4)
    assert pio.DataLoader(ds, places="cpu").device == torch.device("cpu")
    assert pio.DataLoader(ds, places=["cpu"]).device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pio.DataLoader(ds)
    with pytest.raises(RuntimeError):
        pio.DataLoader(ds, places="gpu:0")


@pytest.mark.parametrize("workers", [0, 1, 3])
def test_worker_pool_keeps_the_sampler_order(workers):
    # later batches are the quick ones: the workers finish out of order
    ds = Squares(24, delay=lambda i: 0.002 * (24 - i) / 4)
    batches = [[i, i + 1] for i in range(0, 24, 2)][::-1]
    got = _batches(pio.DataLoader(ds, batch_sampler=batches, num_workers=workers,
                                  prefetch_factor=2, device="cpu", timeout=WAIT_S))
    assert [b[1].tolist() for b in got] == batches
    assert all(b[0].dtype == np.float32 for b in got)
    np.testing.assert_array_equal(got[0][0][1], np.full(3, 23.0 ** 2))


@pytest.mark.parametrize("workers", [0, 2])
def test_a_worker_error_is_raised_at_its_batch(workers):
    ds = Squares(12, fail_at=7)
    batches = [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9]]
    it = iter(pio.DataLoader(ds, batch_sampler=batches, num_workers=workers,
                             device="cpu", timeout=WAIT_S))
    try:
        got = [next(it)[1].tolist() for _ in range(3)]
        assert got == batches[:3]
        with pytest.raises(ValueError, match="bad sample 7"):
            next(it)
        with pytest.raises(StopIteration):
            next(it)
    finally:
        it.close()
    # the JAX loader raises at the same batch
    jit = iter(jio.DataLoader(ds, batch_sampler=batches, num_workers=workers))
    try:
        [next(jit) for _ in range(3)]
        with pytest.raises(ValueError, match="bad sample 7"):
            next(jit)
    finally:
        jit.close()


def _io_threads():
    return [t for t in threading.enumerate() if t.name.startswith("paddle_tpu_torch-io")]


@pytest.mark.parametrize("workers", [0, 3])
def test_close_stops_the_threads_of_a_half_read_epoch(workers):
    ds = Squares(64)
    loader = pio.DataLoader(ds, batch_size=2, num_workers=workers, prefetch_factor=1,
                            device="cpu", timeout=WAIT_S)
    it = iter(loader)
    next(it)
    assert _io_threads()
    it.close()
    deadline = time.monotonic() + 5
    while _io_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _io_threads()
    assert len(_batches(loader)) == 32   # a new epoch after a closed one


def test_loader_timeout_raises():
    ds = Squares(4, delay=lambda i: 1.0)
    it = iter(pio.DataLoader(ds, batch_size=2, num_workers=1, device="cpu", timeout=0.2))
    try:
        with pytest.raises(RuntimeError, match="waited more than 0.2 s"):
            next(it)
    finally:
        it.close()


def test_get_worker_info_is_none_in_both():
    assert pio.get_worker_info() is None and jio.get_worker_info() is None
