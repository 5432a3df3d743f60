"""paddle_tpu_torch's fleet datasets (distributed/fleet/dataset.py over the
native data_feed library) against the JAX package's on the CPU: the same
MultiSlot files, slots, batch sizes and shuffle seeds give the same batches,
exactly, when one thread loads the files (with more, the threads claim the
files in the scheduler's order, in both packages: the same records then);
and the feed drives the port's DeepFM through training steps (the JAX
package's tests/test_dataset_feed.py ``test_feeds_ps_model``)."""
import numpy as np
import pytest
import torch

import paddle_tpu.distributed as jdist
import paddle_tpu_torch.distributed as pdist

torch.set_num_threads(1)

SLOTS = [("ids", "sparse"), ("dense", "f"), ("label", "f")]


def _write_slot_file(path, rows, seed):
    """MultiSlot lines: for each slot '<n> v1 ... vn'; slots: ids (sparse
    uint64, 1-4 of them), dense (3 floats), label (1 float)."""
    rs = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        nids = rs.randint(1, 5)
        ids = rs.randint(0, 10000, nids)
        dense = rs.rand(3).round(4)
        label = float(rs.randint(0, 2))
        lines.append(" ".join([str(nids)] + [str(int(i)) for i in ids] + ["3"]
                              + [f"{v:.4f}" for v in dense] + ["1", f"{label:.1f}"]))
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture()
def slot_files(tmp_path):
    _write_slot_file(tmp_path / "part-0", 13, 0)
    _write_slot_file(tmp_path / "part-1", 9, 1)
    _write_slot_file(tmp_path / "part-2", 17, 2)
    return [str(tmp_path / f"part-{i}") for i in range(3)]


def _batches(ds):
    out = []
    for b in ds:
        out.append({k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                        else np.asarray(v)) for k, v in b.items()})
    return out


def _same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], tuple):
                assert isinstance(g[k], tuple) and len(g[k]) == 2, k
                for a, b in zip(g[k], w[k]):
                    assert a.dtype == b.dtype and np.array_equal(a, b), k
            else:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def _in_memory(pkg, files, batch_size, seed, threads=1):
    ds = pkg.InMemoryDataset()
    ds.init(batch_size=batch_size, thread_num=threads, use_var=SLOTS)
    ds.set_filelist(files)
    n = ds.load_into_memory()
    size = ds.get_memory_data_size()
    if seed is not None:
        ds.global_shuffle(seed=seed)
    out = _batches(ds)
    ds.release_memory()
    assert ds._feed is None
    return n, size, out


@pytest.mark.parametrize("batch_size,seed", [(5, None), (4, 7), (39, 11), (8, 0)])
def test_in_memory_batches_equal_the_jax_packages(slot_files, batch_size, seed):
    n, size, got = _in_memory(pdist, slot_files, batch_size, seed)
    jn, jsize, want = _in_memory(jdist, slot_files, batch_size, seed)
    assert n == size == jn == jsize == 39
    _same(got, want)
    assert sum(b["dense"].shape[0] for b in got) == 39
    assert all(b["dense"].shape[1] == 3 and isinstance(b["ids"], tuple) for b in got)


def _records(batches):
    """Every record as (ids, dense, label) bytes, in the batches' order."""
    out = []
    for b in batches:
        vals, offs = b["ids"]
        for r in range(len(offs) - 1):
            out.append((vals[offs[r]:offs[r + 1]].tobytes(), b["dense"][r].tobytes(),
                        b["label"][r].tobytes()))
    return out


def test_a_load_on_two_threads_holds_the_jax_packages_records(slot_files):
    """Two loader threads claim the files in the order the scheduler runs
    them (the same C++ in both packages), so the records' order may differ
    from run to run; the records are the same."""
    _, _, got = _in_memory(pdist, slot_files, 7, None, threads=2)
    _, _, want = _in_memory(jdist, slot_files, 7, None, threads=2)
    assert sorted(_records(got)) == sorted(_records(want)) and len(_records(got)) == 39


def test_local_shuffle_equals_the_jax_packages(slot_files):
    runs = []
    for pkg in (pdist, jdist):
        ds = pkg.InMemoryDataset()
        ds.init(batch_size=6, thread_num=1, use_var=SLOTS)
        ds.set_filelist(slot_files)
        ds.load_into_memory()
        ds.local_shuffle(seed=3)
        runs.append(_batches(ds))
        ds.release_memory()
    _same(*runs)


@pytest.mark.parametrize("batch_size", [4, 10])
def test_queue_dataset_batches_equal_the_jax_packages(slot_files, batch_size):
    runs = []
    for pkg in (pdist, jdist):
        qd = pkg.QueueDataset()
        qd.init(batch_size=batch_size, thread_num=1, use_var=SLOTS)
        qd.set_filelist(slot_files)
        runs.append(_batches(qd))
    _same(*runs)
    # a batch never spans two files
    assert sum(b["dense"].shape[0] for b in runs[0]) == 39


def test_the_feed_drives_deepfm_training_steps(slot_files):
    from paddle_tpu_torch.models import DeepFM, ctr_loss
    from paddle_tpu_torch.optimizer import Adam

    ds = pdist.InMemoryDataset()
    ds.init(batch_size=8, thread_num=2, use_var=SLOTS)
    ds.set_filelist(slot_files)
    ds.load_into_memory()
    net = DeepFM(sparse_feature_dim=10000, embedding_dim=4, num_fields=4, dense_dim=3,
                 hidden_sizes=(16,), device="cpu")
    opt = Adam(learning_rate=0.01, parameters=net.named_parameters())
    losses = []
    for batch in ds:
        vals, offs = batch["ids"]
        rows = len(offs) - 1
        ids = np.zeros((rows, 4), np.int64)   # ragged ids padded to the model's 4 fields
        for r in range(rows):
            row = vals[offs[r]:offs[r + 1]][:4]
            ids[r, :len(row)] = row.astype(np.int64)
        loss = ctr_loss(net(torch.from_numpy(ids), torch.from_numpy(batch["dense"])),
                        torch.from_numpy(batch["label"].astype(np.int64)))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    assert len(losses) == 5 and all(np.isfinite(losses))


def test_the_feed_refuses_without_a_filelist_or_a_compiler(monkeypatch, tmp_path, slot_files):
    from paddle_tpu_torch.core import native

    ds = pdist.InMemoryDataset()
    ds.init(batch_size=4, use_var=SLOTS)
    with pytest.raises(ValueError, match="set_filelist"):
        ds.load_into_memory()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    ds.set_filelist(slot_files)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        ds.load_into_memory()
