"""Checkpoints of the port (paddle_tpu_torch/distributed/elastic.py): the
counterparts of tests/test_elastic_ckpt.py (async crash-safe saves,
corruption fallback, retention, the engine hook and flags, rollback, the
mid-save SIGKILL, the fsck tool), and checkpoints across the two packages.

The port's cases train a ``Sequential`` of two Linears and a ReLU whose
forward returns the cross-entropy loss (the JAX tests' model) in one
process. Across the packages, f32 and dropout 0: gpt_tiny (the JAX weights
carried over), ids [8, 128], AdamW(1e-3, weight decay 0.01); the JAX engine
on a 2-device mesh with the parameters replicated (tests/test_torch_dp.py),
the port in one process on the global batch. A run of one package trains 2
steps and saves; the other restores and trains 2 more, held to the saving
package's own continuation: losses rtol 1e-5, parameters under
``assert_params_close``. The same both ways with Lamb and with RMSProp
(centered, momentum 0.9: three slots), whose slots the checkpoint carries
in the JAX package's order.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
import warnings

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as P
import torch_dp_workers as W
import torch_elastic_workers as EW
from paddle_tpu.distributed import elastic as jelastic
from paddle_tpu.distributed.engine import TrainStepEngine as JaxEngine
from paddle_tpu.distributed.mesh import HybridCommunicateGroup
from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.distributed import TrainStepEngine, elastic, spawn
from paddle_tpu_torch.distributed.elastic import (CheckpointCorrupt, CheckpointManager,
                                                  restore_latest, verify_checkpoint)
from paddle_tpu_torch.models import state_from_jax
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.tools import ckpt_fsck
from test_torch_dp import _jax_model, assert_params_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Net(torch.nn.Sequential):
    """Linear(16, 32), ReLU, Linear(32, 4); forward(x, y) is the mean
    cross-entropy loss."""

    def __init__(self):
        super().__init__(torch.nn.Linear(16, 32), torch.nn.ReLU(), torch.nn.Linear(32, 4))

    def forward(self, x, y):
        return torch.nn.functional.cross_entropy(super().forward(x), y)


def _make(seed=0, k=1, zero=False, fsdp=False):
    torch.manual_seed(seed)
    net = Net()
    opt = AdamW(0.01, parameters=net.named_parameters())
    return TrainStepEngine(net, opt, microbatches=k, zero_update=zero, fsdp=fsdp)


def _batch(n=32):
    rng = np.random.RandomState(0)
    return (torch.from_numpy(rng.randn(n, 16).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 4, (n,)).astype(np.int64)))


def _losses(eng, x, y, steps):
    return [eng.step(x, y).item() for _ in range(steps)]


def _stat(name):
    return monitor.stat(name).get()


def _params(eng):
    return {n: t.clone() for n, t in eng._full_params().items()}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for n in a:
        assert torch.equal(a[n], b[n]), n


# ------------------------------------------------------------ save/restore

@pytest.mark.parametrize("mode", ["replicated", "zero", "fsdp"])
def test_sync_save_restore_is_bit_continuous(tmp_path, mode):
    kw = {"zero": mode == "zero", "fsdp": mode == "fsdp", "k": 2}
    eng = _make(**kw)
    x, y = _batch()
    _losses(eng, x, y, 3)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(eng, block=True)
    after = _losses(eng, x, y, 2)
    mgr.close()

    eng2 = _make(seed=1, **kw)   # another init: the restore must overwrite it
    assert restore_latest(eng2, str(tmp_path)) == 3
    assert eng2._step_count == 3 and eng2.optimizer._step_count == 3
    assert _losses(eng2, x, y, 2) == after
    _assert_same(_params(eng2), _params(eng))


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_a_sharded_capture_holds_one_gathered_buffer_at_a_time(monkeypatch, mode):
    """Under FSDP the capture gathers one bucket, under ZeRO one optimizer
    slot, and frees it before the next gather; the snapshot holds the
    engine's full state all the same."""
    import weakref

    from paddle_tpu_torch.distributed import collective

    eng = _make(zero=mode == "zero", fsdp=mode == "fsdp")
    x, y = _batch()
    _losses(eng, x, y, 2)
    want_p, want_o = _params(eng), eng._full_opt()
    gathered, most_alive = [], []
    real = collective.all_gather_into

    def gather(output, tensor, **kw):
        most_alive.append(sum(r() is not None for r in gathered))
        gathered.append(weakref.ref(output))
        return real(output, tensor, **kw)

    monkeypatch.setattr(collective, "all_gather_into", gather)
    snap = elastic.capture_snapshot(eng)
    monkeypatch.setattr(collective, "all_gather_into", real)
    n_gathers = (3 * len(eng._fsdp_layout()[0]) if mode == "fsdp" else 2)
    assert len(gathered) == n_gathers and max(most_alive) == 0
    lin = elastic.linear_weights(eng)
    for nm, t in want_p.items():
        got = snap.params[nm]["pieces"][0][1]
        assert np.array_equal(got.T if nm in lin else got, t.numpy()), nm
        for j, s in enumerate(want_o[nm]):
            got = snap.opt[f"{nm}.{j}"]["pieces"][0][1]
            assert np.array_equal(got.T if nm in lin else got, s.numpy()), (nm, j)


def test_fsdp_cannot_be_turned_off_after_its_first_step():
    """The conversion to shards is one-way (the reference's): a step with
    fsdp turned off raises and leaves the shards as they were."""
    eng = _make(fsdp=True)
    x, y = _batch()
    _losses(eng, x, y, 1)
    shards = [s.clone() for s in eng._fsdp_params]
    eng.fsdp = False
    with pytest.raises(ValueError, match="one-way"):
        eng.step(x, y)
    assert all(torch.equal(a, b) for a, b in zip(shards, eng._fsdp_params))
    eng.fsdp = True
    assert np.isfinite(eng.step(x, y).item())


def test_async_save_is_bit_transparent_and_skips_when_busy(tmp_path):
    x, y = _batch()
    ref = _losses(_make(), x, y, 6)
    eng = _make()
    mgr = CheckpointManager(str(tmp_path), interval=2, keep=10, async_save=True)
    got = []
    for s in range(1, 7):
        loss = eng.step(x, y)
        got.append(loss.item())
        mgr.on_step(eng, s, loss)
    assert got == ref, "async checkpoints perturbed the loss trajectory"
    assert mgr.wait(timeout=60)
    saves = [step for step, _ in mgr.checkpoints()]
    assert saves and all(step % 2 == 0 for step in saves)   # a busy writer skips
    for _step, path in mgr.checkpoints():
        verify_checkpoint(path)
    mgr.close()

    eng2 = _make()
    eng2.step(x, y)
    mgr2 = CheckpointManager(str(tmp_path / "busy"), async_save=True, slow_write_ms=150)
    k0 = _stat("ckpt.skipped")
    assert mgr2.save(eng2) is True
    assert mgr2.save(eng2) is True    # one writing, one queued
    assert mgr2.save(eng2) is False   # full: skip, do not stall the step
    assert _stat("ckpt.skipped") == k0 + 1
    assert mgr2.wait(timeout=120)
    mgr2.close()


def test_an_async_snapshot_is_the_state_of_its_step(tmp_path):
    """The writer is slowed while training goes on updating the parameters
    in place: the checkpoint still holds the state of the step it was taken
    at (the capture owns its copy)."""
    x, y = _batch()
    ref = _make()
    _losses(ref, x, y, 2)
    eng = _make()
    mgr = CheckpointManager(str(tmp_path), interval=2, keep=5, async_save=True,
                            slow_write_ms=50)
    for s in range(1, 7):
        mgr.on_step(eng, s, eng.step(x, y))
    mgr.close()
    got = _make(seed=4)
    assert elastic.restore_checkpoint(got, elastic.checkpoint_path(str(tmp_path), 2)) == 2
    _assert_same(_params(got), _params(ref))
    for nm, slots in ref.optimizer._states.items():
        for a, b in zip(got.optimizer._states[nm], slots):
            assert torch.equal(a, b), nm


def test_dropout_masks_resume_where_they_left_off(tmp_path, request):
    """gpt_tiny with dropout 0.1: 2 steps, save, a fresh engine restores and
    takes 2 more; its losses are the uninterrupted run's bit for bit (the
    dropout generator's state rides the manifest)."""
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny

    def engine(seed):
        m = GPTForPretraining(gpt_tiny(dropout=0.1), device="cpu", seed=seed)
        return TrainStepEngine(m, AdamW(1e-3, parameters=m.named_parameters()))

    ids, labels = W.batch(b=4, s=64)
    # the CPU embedding's backward sums in one order only when asked to
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    request.addfinalizer(lambda: torch.use_deterministic_algorithms(was))
    ref = _losses(engine(0), ids, labels, 4)
    eng = engine(0)
    _losses(eng, ids, labels, 2)
    CheckpointManager(str(tmp_path), async_save=False).save(eng, block=True)
    eng2 = engine(7)
    restore_latest(eng2, str(tmp_path))
    assert eng2._seed == 0 and eng2.optimizer._step_count == 2
    assert _losses(eng2, ids, labels, 2) == ref[2:]
    manifest = verify_checkpoint(elastic.list_checkpoints(str(tmp_path))[0][1])
    assert manifest["key"] == {"words": [0, 0], "shape": [2]}


# ------------------------------------------------------------- corruption

def _corrupt_file(path, offset=64):
    with open(path, "r+b") as f:
        f.seek(offset)
        raw = f.read(4)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in raw))


def _two_checkpoints(tmp_path, eng, x, y):
    mgr = CheckpointManager(str(tmp_path), interval=1, keep=10, async_save=False)
    eng.step(x, y)
    mgr.save(eng, block=True)
    eng.step(x, y)
    mgr.save(eng, block=True)
    mgr.close()
    return elastic.list_checkpoints(str(tmp_path))


def _first_payload(path):
    return os.path.join(path, sorted(n for n in os.listdir(path) if n.endswith(".npy"))[0])


def test_corrupt_payload_falls_back_to_previous(tmp_path):
    eng = _make()
    x, y = _batch()
    ckpts = _two_checkpoints(tmp_path, eng, x, y)
    assert [s for s, _ in ckpts] == [1, 2]
    _corrupt_file(_first_payload(ckpts[-1][1]))
    with pytest.raises(CheckpointCorrupt, match="checksum mismatch"):
        verify_checkpoint(ckpts[-1][1])
    c0 = _stat("ckpt.corrupt")
    eng2 = _make(seed=1)
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        assert restore_latest(eng2, str(tmp_path)) == 1
    assert _stat("ckpt.corrupt") == c0 + 1
    assert any("corrupt" in str(w.message) for w in wlog)


def test_corrupt_manifest_falls_back(tmp_path):
    eng = _make()
    x, y = _batch()
    ckpts = _two_checkpoints(tmp_path, eng, x, y)
    mpath = os.path.join(ckpts[-1][1], elastic.MANIFEST)
    with open(mpath) as f:
        m = json.load(f)
    m["step"] = 999   # the body no longer matches the self-checksum
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(CheckpointCorrupt, match="manifest checksum"):
        verify_checkpoint(ckpts[-1][1])
    eng2 = _make(seed=1)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        assert restore_latest(eng2, str(tmp_path)) == 1


def test_truncated_payload_detected(tmp_path):
    eng = _make()
    x, y = _batch()
    ckpts = _two_checkpoints(tmp_path, eng, x, y)
    fp = _first_payload(ckpts[-1][1])
    with open(fp, "r+b") as f:
        f.truncate(os.path.getsize(fp) - 8)
    with pytest.raises(CheckpointCorrupt, match="truncated"):
        verify_checkpoint(ckpts[-1][1])


def test_all_corrupt_raises_filenotfound(tmp_path):
    eng = _make()
    x, y = _batch()
    for _s, path in _two_checkpoints(tmp_path, eng, x, y):
        os.remove(os.path.join(path, elastic.MANIFEST))
    eng2 = _make(seed=1)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        with pytest.raises(FileNotFoundError):
            restore_latest(eng2, str(tmp_path))


# ------------------------------------------------------- sharded and dict

def test_zero_checkpoint_restores_into_replicated_and_back(tmp_path):
    """A ZeRO engine's checkpoint (per-name sections, gathered) continues
    bit for bit in a replicated engine, and a replicated one in a ZeRO
    engine, which shards it again at its next step."""
    x, y = _batch()
    src = _make(zero=True, k=2)
    _losses(src, x, y, 3)
    assert src._zero_opt is not None
    CheckpointManager(str(tmp_path / "z"), async_save=False).save(src, block=True)
    cont = _losses(src, x, y, 3)
    er = _make(seed=2, k=2)
    restore_latest(er, str(tmp_path / "z"))
    assert er._zero_opt is None and len(er.optimizer._states) == 4
    assert _losses(er, x, y, 3) == cont

    CheckpointManager(str(tmp_path / "r"), async_save=False).save(er, block=True)
    cont = _losses(er, x, y, 2)
    ez = _make(seed=1, zero=True, k=2)
    restore_latest(ez, str(tmp_path / "r"))
    assert _losses(ez, x, y, 2) == cont
    assert ez._zero_opt is not None and not ez.optimizer._states


# ------------------------------------------------- retention / GC / hooks

def test_retention_gc_keeps_newest(tmp_path):
    eng = _make()
    x, y = _batch()
    mgr = CheckpointManager(str(tmp_path), interval=1, keep=2, async_save=False)
    g0 = _stat("ckpt.gc_removed")
    for _ in range(4):
        eng.step(x, y)
        mgr.save(eng, block=True)
    assert [s for s, _ in mgr.checkpoints()] == [3, 4]
    assert _stat("ckpt.gc_removed") == g0 + 2
    stale = os.path.join(str(tmp_path), f"{elastic.TMP_PREFIX}ckpt_9.999999")
    os.makedirs(stale)   # a crashed writer's leftovers (a dead pid)
    eng.step(x, y)
    mgr.save(eng, block=True)
    assert not os.path.isdir(stale)
    mgr.close()


def test_engine_hook_and_flags_wiring(tmp_path):
    eng = _make()
    x, y = _batch()
    mgr = eng.enable_checkpointing(str(tmp_path), interval=2, keep=10, async_save=False)
    for _ in range(5):
        eng.step(x, y)
    assert [s for s, _ in mgr.checkpoints()] == [2, 4]
    eng.disable_checkpointing()
    assert eng._ckpt is None

    eng3 = _make(seed=3)
    eng3.enable_checkpointing(str(tmp_path), resume=True)
    assert eng3._step_count == 4
    eng3.disable_checkpointing()

    saved = P.get_flags(["ckpt_dir", "ckpt_interval"])
    P.set_flags({"ckpt_dir": str(tmp_path / "auto"), "ckpt_interval": 1})
    try:
        eng2 = _make()
        assert eng2._ckpt is not None and eng2._ckpt.dirname == str(tmp_path / "auto")
        eng2.step(x, y)
        eng2._ckpt.wait()
        assert [s for s, _ in eng2._ckpt.checkpoints()] == [1]
        eng2.disable_checkpointing()
    finally:
        P.set_flags(saved)


def test_rollback_on_nonfinite_loss(tmp_path):
    eng = _make()
    x, y = _batch()
    mgr = CheckpointManager(str(tmp_path), interval=1, keep=3, async_save=False,
                            rollback_on_nonfinite=True)
    loss = eng.step(x, y)
    mgr.on_step(eng, 1, loss)          # commits ckpt_00000001
    eng.step(x, y)
    r0 = _stat("ckpt.rollbacks")
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        restored = mgr.on_step(eng, 2, float("nan"))
    assert restored == 1 and eng._step_count == 1
    assert _stat("ckpt.rollbacks") == r0 + 1
    assert any("rolled back" in str(w.message) for w in wlog)
    mgr.close()


# ------------------------------------------------------------ fsck + kill

def test_fsck_exit_codes(tmp_path, capsys):
    eng = _make()
    x, y = _batch()
    ckpts = _two_checkpoints(tmp_path, eng, x, y)
    assert ckpt_fsck.main([str(tmp_path)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["checked"] == 2 and summary["corrupt"] == 0
    assert ckpt_fsck.main([str(ckpts[0][1]), "--quiet"]) == 0
    capsys.readouterr()
    _corrupt_file(_first_payload(ckpts[-1][1]))
    assert ckpt_fsck.main([str(tmp_path)]) == 1
    rows = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert any(r.get("ok") is False for r in rows[:-1])
    assert ckpt_fsck.main([str(tmp_path / "empty")]) == 2


_VICTIM = textwrap.dedent("""
    import sys

    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.optimizer import AdamW

    class Net(torch.nn.Sequential):
        def forward(self, x, y):
            return torch.nn.functional.cross_entropy(super().forward(x), y)

    torch.manual_seed(0)
    net = Net(torch.nn.Linear(16, 32), torch.nn.ReLU(), torch.nn.Linear(32, 4))
    eng = TrainStepEngine(net, AdamW(0.01, parameters=net.named_parameters()))
    eng.enable_checkpointing(sys.argv[1], interval=1, keep=100, async_save=True)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(32, 16).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 4, (32,)).astype(np.int64))
    while True:  # the parent always SIGKILLs; steps take ms, saves ~1 s
        eng.step(x, y)
        print("STEP", eng._step_count, flush=True)
""")


def test_mid_save_sigkill_leaves_no_torn_checkpoint(tmp_path):
    script = tmp_path / "victim.py"
    script.write_text(_VICTIM)
    ckpt_dir = str(tmp_path / "ckpts")
    env = {k: v for k, v in os.environ.items() if k != "PADDLE_TPU_CKPT_DIR"}
    env.update(PYTHONPATH=REPO, PADDLE_TPU_CKPT_SLOW_WRITE_MS="60", OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(script), ckpt_dir], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    try:
        last = 0
        for line in proc.stdout:
            if line.startswith("STEP"):
                last = int(line.split()[1])
            if last >= 2 and len(elastic.list_checkpoints(ckpt_dir)) >= 2:
                break
        else:
            pytest.fail(f"victim exited early (rc={proc.wait()})")
        deadline = time.monotonic() + 30.0
        mid_save = False
        while time.monotonic() < deadline:
            if any(n.startswith(elastic.TMP_PREFIX) for n in os.listdir(ckpt_dir)):
                mid_save = True
                break
            time.sleep(0.002)
        assert mid_save, "never caught the writer mid-save (slowed to 60 ms a file)"
    finally:
        proc.kill()
        proc.wait()
        proc.stdout.close()

    committed = elastic.list_checkpoints(ckpt_dir)
    assert len(committed) >= 2
    for _step, path in committed:
        verify_checkpoint(path)
    eng = _make()
    restored = restore_latest(eng, ckpt_dir)
    assert restored == committed[-1][0]
    x, y = _batch()
    assert np.isfinite(eng.step(x, y).item())


# ------------------------------------------------------ across the packages

def _state():
    return {n: np.asarray(v._data) for n, v in _jax_model().state_dict().items()}


def _jax_engine(zero=False, rule="AdamW"):
    jm = _jax_model()
    hcg = HybridCommunicateGroup(dp_degree=2, devices=jax.devices()[:2])
    kw = {"weight_decay": 0.01} if rule == "AdamW" else W.RULE_KW[rule]
    opt = getattr(paddle.optimizer, rule)(parameters=jm.parameters(),
                                          **{"learning_rate": W.LR, **kw})
    return JaxEngine(jm, opt, hcg=hcg, zero_update=zero)


def _jax_params(eng):
    return {n: v.numpy() for n, v in state_from_jax(
        {n: np.asarray(a) for n, a in eng.params.items()}).items()}


def _port_engine(state, rule="AdamW"):
    m = W._model(state)
    return TrainStepEngine(m, W.make_opt(m.named_parameters(), rule))


@pytest.mark.parametrize("zero", [False, True], ids=["replicated", "zero"])
def test_a_jax_checkpoint_resumes_in_the_port(tmp_path, zero):
    ids, labels = W.batch()
    jids, jlabels = paddle.to_tensor(ids.numpy()), paddle.to_tensor(labels.numpy())
    je = _jax_engine(zero)
    [je.step(jids, jlabels) for _ in range(2)]
    jmgr = jelastic.CheckpointManager(str(tmp_path), async_save=False)
    jmgr.save(je, block=True)
    jmgr.close()
    manifest = verify_checkpoint(elastic.list_checkpoints(str(tmp_path))[0][1])
    assert (manifest["zero_opt"] is not None) == zero
    want = [float(je.step(jids, jlabels).item()) for _ in range(2)]

    pe = _port_engine({n: np.zeros_like(v) for n, v in _state().items()})
    assert restore_latest(pe, str(tmp_path)) == 2
    w0, w1 = manifest["key"]["words"]
    assert pe._seed == w0 << 32 | w1     # the JAX key's data as the port's seed
    got = _losses(pe, ids, labels, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_params_close({n: p.detach() for n, p in pe.model.named_parameters()},
                        _jax_params(je))
    assert ckpt_fsck.main([str(tmp_path), "--quiet"]) == 0


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_a_port_checkpoint_resumes_in_the_jax_package(tmp_path, mode):
    ids, labels = W.batch()
    pe = _port_engine(_state())
    pe.fsdp = mode == "fsdp"
    _losses(pe, ids, labels, 2)
    CheckpointManager(str(tmp_path), async_save=False).save(pe, block=True)
    want = _losses(pe, ids, labels, 2)
    want_params = {n: t.numpy() for n, t in pe._full_params().items()}
    path = elastic.list_checkpoints(str(tmp_path))[0][1]
    manifest = jelastic.verify_checkpoint(path)   # the reference's verifier
    assert manifest["key"] == {"words": [0, pe._seed], "shape": [2]}

    je = _jax_engine()
    assert jelastic.restore_latest(je, str(tmp_path)) == 2
    assert [int(w) for w in np.asarray(jax.random.key_data(je._key))] == [0, pe._seed]
    jids, jlabels = paddle.to_tensor(ids.numpy()), paddle.to_tensor(labels.numpy())
    got = [float(je.step(jids, jlabels).item()) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_params_close({n: torch.from_numpy(v) for n, v in _jax_params(je).items()},
                        want_params)


@pytest.mark.parametrize("rule", ["Lamb", "RMSProp"])
def test_a_rule_checkpoint_crosses_both_ways(tmp_path, rule):
    """A JAX checkpoint of ``rule`` resumes in the port, and the port's in
    the JAX package: 2 steps, save, 2 more, against the saving package's
    own continuation."""
    ids, labels = W.batch()
    jids, jlabels = paddle.to_tensor(ids.numpy()), paddle.to_tensor(labels.numpy())
    slots = len(W.make_opt([torch.zeros(1)], rule)._state("param_0", torch.zeros(1)))
    assert slots == {"Lamb": 2, "RMSProp": 3}[rule]

    je = _jax_engine(rule=rule)
    [je.step(jids, jlabels) for _ in range(2)]
    jelastic.CheckpointManager(str(tmp_path / "j"), async_save=False).save(je, block=True)
    manifest = verify_checkpoint(elastic.list_checkpoints(str(tmp_path / "j"))[0][1])
    assert {k.rsplit(".", 1)[1] for k in manifest["opt"]} == {str(j) for j in range(slots)}
    want = [float(je.step(jids, jlabels).item()) for _ in range(2)]
    pe = _port_engine({n: np.zeros_like(v) for n, v in _state().items()}, rule)
    assert restore_latest(pe, str(tmp_path / "j")) == 2
    np.testing.assert_allclose(_losses(pe, ids, labels, 2), want, rtol=1e-5)
    assert_params_close({n: p.detach() for n, p in pe.model.named_parameters()},
                        _jax_params(je))

    pe = _port_engine(_state(), rule)
    _losses(pe, ids, labels, 2)
    CheckpointManager(str(tmp_path / "p"), async_save=False).save(pe, block=True)
    want = _losses(pe, ids, labels, 2)
    want_params = {n: t.numpy() for n, t in pe._full_params().items()}
    je = _jax_engine(rule=rule)
    assert jelastic.restore_latest(je, str(tmp_path / "p")) == 2
    got = [float(je.step(jids, jlabels).item()) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_params_close({n: torch.from_numpy(v) for n, v in _jax_params(je).items()},
                        want_params)


def test_the_sequential_of_linears_crosses_both_ways(tmp_path):
    """The JAX tests' model: Linear weights found by module type (no name
    suffix), transposed with their optimizer slots on write and read."""
    x, y = _batch()

    def jax_engine(seed):
        paddle.seed(seed)
        jnet = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.ReLU(),
                                    paddle.nn.Linear(32, 4))
        jopt = paddle.optimizer.AdamW(learning_rate=0.01, parameters=jnet.parameters())
        return JaxEngine(jnet, jopt, loss_fn=paddle.nn.CrossEntropyLoss(),
                         hcg=HybridCommunicateGroup(dp_degree=1, devices=jax.devices()[:1]))

    je = jax_engine(0)
    jx, jy = paddle.to_tensor(x.numpy()), paddle.to_tensor(y.numpy())
    [je.step(jx, jy) for _ in range(2)]
    jelastic.CheckpointManager(str(tmp_path / "j"), async_save=False).save(je, block=True)
    want = [float(je.step(jx, jy).item()) for _ in range(2)]

    pe = _make(seed=5)
    restore_latest(pe, str(tmp_path / "j"))
    assert elastic.linear_weights(pe) == {"0.weight", "2.weight"}
    np.testing.assert_allclose(_losses(pe, x, y, 2), want, rtol=1e-5)

    CheckpointManager(str(tmp_path / "p"), async_save=False).save(pe, block=True)
    cont = _losses(pe, x, y, 2)
    je2 = jax_engine(1)
    jelastic.restore_latest(je2, str(tmp_path / "p"))
    np.testing.assert_allclose([float(je2.step(jx, jy).item()) for _ in range(2)], cont,
                               rtol=1e-5)


# ------------------------------------------------------ the model's buffers
#
# A ResNet-18's batch norm updates its running statistics (buffers) on every
# engine step; a checkpoint carries them in its ``buffers`` sections. The
# resumed run's buffers and eval logits must equal the uninterrupted run's
# bit for bit (the same steps on the same batch: the CPU's arithmetic is
# deterministic under torch.use_deterministic_algorithms).

def _bufs_and_logits_equal(a, b, what):
    assert a["losses"] == b["losses"], what
    assert a["buffers"].keys() == b["buffers"].keys()
    assert any(n.endswith("._mean") for n in a["buffers"])
    for n in a["buffers"]:
        assert torch.equal(a["buffers"][n], b["buffers"][n]), f"{what}: {n}"
    assert torch.equal(a["logits"], b["logits"]), f"{what}: eval logits"


def test_a_resumed_resnet18_has_the_uninterrupted_buffers_and_eval_logits(tmp_path):
    torch.set_num_threads(1)
    x, y = EW.resnet_batch()
    eng = EW.resnet_engine(0)
    [eng.step(x, y) for _ in range(EW.SAVED_STEPS)]
    CheckpointManager(str(tmp_path), async_save=False).save(eng, block=True)
    manifest = verify_checkpoint(elastic.list_checkpoints(str(tmp_path))[0][1])
    want_keys = set(elastic.model_buffers(eng.model))
    assert set(manifest["buffers"]) == want_keys and len(want_keys) == 40
    assert manifest["linear_layout"] == "in_out"
    assert manifest["params"]["fc.weight"]["shape"] == [512, 10]
    uninterrupted = EW.outcome(eng, x, y, EW.RESUMED_STEPS)

    fresh = EW.resnet_engine(1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # a checkpoint with buffers restores silently
        assert restore_latest(fresh, str(tmp_path)) == EW.SAVED_STEPS
    _bufs_and_logits_equal(EW.outcome(fresh, x, y, EW.RESUMED_STEPS), uninterrupted, "dp1")
    assert ckpt_fsck.main([str(tmp_path), "--quiet"]) == 0


def test_a_resumed_resnet18_over_two_gloo_ranks_has_the_uninterrupted_buffers(tmp_path):
    spawn(EW.resnet_resume, args=(str(tmp_path), str(tmp_path / "ckpt")), nprocs=2,
          timeout=240)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for mode in ("replicated", "zero"):
        for r, res in enumerate(ranks):
            assert res[mode]["step"] == EW.SAVED_STEPS
            _bufs_and_logits_equal(res[mode]["resumed"], res[mode]["uninterrupted"],
                                   f"{mode} rank {r}")
        for n, b in ranks[0][mode]["resumed"]["buffers"].items():   # replicated
            assert torch.equal(b, ranks[1][mode]["resumed"]["buffers"][n]), n


def _save_in_the_older_layout(eng, dirname, monkeypatch):
    """Save ``eng`` as the port wrote checkpoints before its buffers sections:
    its own nn.Linear weights and their slots stored ``[out, in]`` (only
    torch.nn.Linear's transposed), no ``buffers`` section and no
    ``linear_layout`` mark, the manifest checksummed again. Returns the path."""
    newer = elastic.linear_weights
    with monkeypatch.context() as m:
        m.setattr(elastic, "linear_weights",
                  lambda e, port_linear=True: newer(e, port_linear=False))
        CheckpointManager(dirname, async_save=False).save(eng, block=True)
    path = elastic.list_checkpoints(dirname)[-1][1]
    mpath = os.path.join(path, elastic.MANIFEST)
    with open(mpath) as f:
        manifest = json.load(f)
    assert manifest.pop("linear_layout") == "in_out"
    for ent in manifest.pop("buffers").values():
        for sh in ent["shards"]:
            os.remove(os.path.join(path, sh["file"]))
    manifest["manifest_checksum"] = elastic.manifest_digest(manifest)
    with open(mpath, "w") as f:
        json.dump(manifest, f, sort_keys=True)
    return path


def _assert_same_state(got, want):
    for n, p in got.model.named_parameters():
        assert torch.equal(p, dict(want.model.named_parameters())[n]), n
    assert got.optimizer._states.keys() == want.optimizer._states.keys()
    for n, slots in got.optimizer._states.items():
        for a, b in zip(slots, want.optimizer._states[n]):
            assert torch.equal(a, b), n


def test_a_checkpoint_without_buffers_restores_and_warns(tmp_path, monkeypatch):
    """A ResNet-18 checkpoint in the port's older layout (fc.weight stored
    [10, 512]) restores: its parameters and optimizer state exactly, its
    buffers left as the fresh model holds them, with a warning."""
    x, y = EW.resnet_batch()
    eng = EW.resnet_engine(0)
    [eng.step(x, y) for _ in range(2)]
    path = _save_in_the_older_layout(eng, str(tmp_path), monkeypatch)
    with open(os.path.join(path, elastic.MANIFEST)) as f:
        assert json.load(f)["params"]["fc.weight"]["shape"] == [10, 512]
    fresh = EW.resnet_engine(1)
    before = {n: b.clone() for n, b in fresh.model.named_buffers()}
    with pytest.warns(UserWarning, match="no buffers section: 40 buffers"):
        assert restore_latest(fresh, str(tmp_path)) == 2
    for n, b in fresh.model.named_buffers():
        assert torch.equal(b, before[n]), n
    _assert_same_state(fresh, eng)


def _square_engine(seed, generator):
    """Two square port nn.Linears (the case the saved shapes cannot tell
    apart), with a dropout generator on the model or without one."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import optimizer as popt

    torch.manual_seed(seed)
    pm = pnn.Sequential(pnn.Linear(6, 6, device="cpu"), pnn.ReLU(),
                        pnn.Linear(6, 6, device="cpu"))
    if generator:
        pm.generator = torch.Generator().manual_seed(seed)
    return TrainStepEngine(pm, popt.Momentum(learning_rate=0.1,
                                             parameters=pm.named_parameters()),
                           loss_fn=pnn.CrossEntropyLoss())


@pytest.mark.parametrize("generator", [True, False], ids=["generator", "no_generator"])
def test_an_older_checkpoint_of_square_linears_restores_or_is_refused(
        tmp_path, monkeypatch, generator):
    """Without the linear_layout mark, a torch_generator field says the port
    wrote the checkpoint ([out, in], restored as it is); with neither, square
    weights cannot say which package wrote them, and the restore refuses
    rather than guess."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(8, 6).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 6, (8,)).astype(np.int64))
    eng = _square_engine(0, generator)
    _losses(eng, x, y, 2)
    _save_in_the_older_layout(eng, str(tmp_path), monkeypatch)
    fresh = _square_engine(1, generator)
    if generator:
        assert restore_latest(fresh, str(tmp_path)) == 2
        _assert_same_state(fresh, eng)
    else:
        with pytest.raises(ValueError, match="every one is square"):
            restore_latest(fresh, str(tmp_path))


def _bn_net(pkg, device=None):
    """Conv (no bias) -> BatchNorm -> ReLU -> pool -> Linear, in either
    package (tests/test_torch_vision.py's)."""
    kw = {} if device is None else {"device": device}
    nn = pkg
    return nn.Sequential(nn.Conv2D(3, 8, 3, padding=1, bias_attr=False, **kw),
                         nn.BatchNorm2D(8, **kw), nn.ReLU(), nn.AdaptiveAvgPool2D(2),
                         nn.Flatten(), nn.Linear(32, 5, **kw))


def _bn_batch():
    rng = np.random.RandomState(4)
    return (rng.randn(8, 3, 6, 6).astype(np.float32),
            rng.randint(0, 5, (8,)).astype(np.int64))


def _jax_bn_engine():
    from torch_numpy_init import numpy_init

    with numpy_init(2):
        jm = _bn_net(paddle.nn)
    return JaxEngine(jm, paddle.optimizer.Momentum(learning_rate=0.1,
                                                   parameters=jm.parameters()),
                     loss_fn=paddle.nn.CrossEntropyLoss(),
                     hcg=HybridCommunicateGroup(dp_degree=1, devices=jax.devices()[:1]))


def _port_bn_engine(seed):
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import optimizer as popt

    torch.manual_seed(seed)
    pm = _bn_net(pnn, device="cpu")
    return TrainStepEngine(pm, popt.Momentum(learning_rate=0.1,
                                             parameters=pm.named_parameters()),
                           loss_fn=pnn.CrossEntropyLoss())


def test_a_port_checkpoint_with_buffers_resumes_in_the_jax_package(tmp_path):
    """The JAX reader passes over the buffers section (its engine keeps no
    running statistics) and verifies the manifest: 2 port steps, save, 2
    more, against the JAX engine restored there (losses rtol 1e-5; train
    mode normalizes by the batch's statistics)."""
    x, y = _bn_batch()
    pe = _port_bn_engine(0)
    _losses(pe, torch.from_numpy(x), torch.from_numpy(y), 2)
    CheckpointManager(str(tmp_path), async_save=False).save(pe, block=True)
    saved_mean = dict(pe.model.named_buffers())["1._mean"].numpy().copy()
    want = _losses(pe, torch.from_numpy(x), torch.from_numpy(y), 2)
    path = elastic.list_checkpoints(str(tmp_path))[0][1]
    manifest = jelastic.verify_checkpoint(path)   # the reference's verifier
    assert set(manifest["buffers"]) == {"1._mean", "1._variance"}
    np.testing.assert_array_equal(np.load(os.path.join(
        path, manifest["buffers"]["1._mean"]["shards"][0]["file"])), saved_mean)
    je = _jax_bn_engine()
    assert jelastic.restore_latest(je, str(tmp_path)) == 2
    got = [float(je.step(paddle.to_tensor(x), paddle.to_tensor(y)).item()) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_a_jax_checkpoint_restores_in_the_port_with_its_buffers_left(tmp_path):
    """A JAX checkpoint has no buffers section: the port restores its
    parameters, leaves the model's buffers as they are and says how many."""
    x, y = _bn_batch()
    je = _jax_bn_engine()
    [je.step(paddle.to_tensor(x), paddle.to_tensor(y)) for _ in range(2)]
    jelastic.CheckpointManager(str(tmp_path), async_save=False).save(je, block=True)
    want = [float(je.step(paddle.to_tensor(x), paddle.to_tensor(y)).item()) for _ in range(2)]
    pe = _port_bn_engine(5)
    before = {n: b.clone() for n, b in pe.model.named_buffers()}
    with pytest.warns(UserWarning, match="no buffers section: 2 buffers"):
        assert restore_latest(pe, str(tmp_path)) == 2
    for n, b in pe.model.named_buffers():
        assert torch.equal(b, before[n]), n
    np.testing.assert_allclose(_losses(pe, torch.from_numpy(x), torch.from_numpy(y), 2),
                               want, rtol=1e-5)
