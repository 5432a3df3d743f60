"""Checkpoints of the port (counterpart of paddle_tpu/distributed/elastic.py):
crash-safe saves in a format both packages read, newest-valid restore, and
rollback on a non-finite loss.

**The format is the JAX package's.** A checkpoint is a directory
``ckpt_<step>`` of ``.npy`` payloads and a ``manifest.json`` that lists them
with their sha256 and checksums itself. Parameters are per-name ``params``
sections, the optimizer state per-name ``opt`` sections (``name.slot``) and
the model's persistent buffers (batch norm's ``_mean`` and ``_variance``)
per-name ``buffers`` sections, all in the JAX package's layout: every
Linear weight, found by module type (``torch.nn.Linear`` and the port's
``nn.Linear``), and each of its optimizer slots is stored ``[in, out]``,
transposed on write and on read (models/convert.py's rule), and the
manifest's ``linear_layout: "in_out"`` marks that the port's ``nn.Linear``
weights are among them. The port wrote those ``[out, in]`` before it wrote
``buffers``: a checkpoint without the mark holds them ``[out, in]`` when it
has a ``torch_generator`` field (only the port writes one), else as the
shapes of its non-square port Linear weights say; one where they are all
square is refused (``stored_linears``). The port writes ``opt``
sections under ZeRO and FSDP too (gathered), as the reference's FSDP capture
does, and reads a JAX ZeRO checkpoint's flat ``zero_opt`` section (split at
the sorted-name offsets in the JAX shapes). The manifest's ``key`` is a
threefry key's data, uint32 ``[2]``: the port writes its dropout seed s as
``[s >> 32, s & 0xffffffff]``, which ``jax.random.key(s)`` has, and reads a
JAX key back into its seed. The JAX package reads ``params`` and ``opt``
and passes over ``buffers`` (its engine keeps no running statistics); a
checkpoint without ``buffers`` (the JAX package's, or the port's before
it wrote them) restores with the model's buffers left as they are and a
warning that counts them. It also writes its dropout generator's state
(``torch_generator``), which the JAX package ignores: a run resumed in the
port draws the masks the uninterrupted run draws.

**Crash-safe commit** (reference ``write_checkpoint``): payloads are written
and fsync'd in a hidden ``.tmp.ckpt_<step>.<pid>`` directory, the manifest
last, and ``os.rename`` to ``ckpt_<step>`` is the one commit point (then
the parent directory is fsync'd). A kill at any byte leaves the committed
checkpoints and an ignorable ``.tmp`` directory.

**Saves overlap training.** ``capture_snapshot`` copies the state to host
memory on the step's thread; serialisation, hashing and fsync run on a
background writer behind a depth-1 queue (one snapshot writing and one
queued); a save that fires while both are taken is skipped and counted
(``ckpt.skipped``).

**Many ranks.** The port runs one process a rank. Under ZeRO or FSDP the
capture gathers the state, so it is a collective: every rank's ``on_step``
reaches it at the same step, and rank 0's decision to save or skip is
broadcast first. It gathers one bucket (FSDP) or one optimizer slot (ZeRO)
at a time and frees it before the next, so a save holds one gathered
buffer beyond the shards. Only rank 0 writes and commits; a restore waits
for its writer and then meets the other ranks at a barrier before any rank
reads the directory. Every rank restores the full state and the next ZeRO or
FSDP step shards it again, at the new rank count.

Counters (core/monitor.py): ckpt.saves, .restores, .bytes, .skipped,
.corrupt, .failures, .rollbacks, .gc_removed. With the metrics registry on,
each commit observes the ``ckpt.save_ms`` and ``ckpt.capture_ms``
histograms, and a commit by the background writer ``ckpt.overlap_ms`` (the
writer's wall while the step's thread kept stepping). With the flight
recorder on, a corrupt checkpoint skipped by the restore walk dumps
``ckpt_corrupt``, a failed save ``ckpt_save_failed`` and a rollback
``ckpt_rollback``. ``PADDLE_TPU_CKPT_SLOW_WRITE_MS`` sleeps that long after
each payload file (widens the window of a mid-save kill for the tests). Not
ported: ``live_reshard`` (a world size changed in process).
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import queue
import shutil
import threading
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import flags as _flags
from ..core import monitor as _monitor
from ..observability import flight_recorder as _obs_flight
from ..observability import metrics as _obs_metrics
from . import collective

SAVES = _monitor.stat("ckpt.saves")
RESTORES = _monitor.stat("ckpt.restores")
BYTES_WRITTEN = _monitor.stat("ckpt.bytes")
SKIPPED = _monitor.stat("ckpt.skipped")
CORRUPT = _monitor.stat("ckpt.corrupt")
FAILURES = _monitor.stat("ckpt.failures")
ROLLBACKS = _monitor.stat("ckpt.rollbacks")
GC_REMOVED = _monitor.stat("ckpt.gc_removed")

FORMAT_VERSION = 1
CKPT_PREFIX = "ckpt_"
TMP_PREFIX = ".tmp."
MANIFEST = "manifest.json"
# the manifest's mark of the port's Linear layout (module docstring)
LINEAR_LAYOUT = "in_out"


class CheckpointCorrupt(RuntimeError):
    """A checkpoint directory failed manifest/payload verification."""


# ---------------------------------------------------------------- hashing
def file_sha256(path: str, blocksize: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(blocksize), b""):
            h.update(block)
    return h.hexdigest()


def manifest_digest(manifest: dict) -> str:
    """Self-checksum over the canonical JSON (sorted keys) of every field but
    the checksum itself."""
    body = {k: v for k, v in manifest.items() if k != "manifest_checksum"}
    return hashlib.sha256(json.dumps(body, sort_keys=True).encode()).hexdigest()


def _fsync_dir(dirname: str) -> None:
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse directory fsync; rename is still atomic
    finally:
        os.close(fd)


# ---------------------------------------------------------------- layout
def linear_weights(engine, port_linear=True) -> set:
    """The engine's names of the Linear weights of its model, by module type:
    ``torch.nn.Linear``'s and, with ``port_linear``, the port's ``nn.Linear``'s
    (which store ``[out, in]`` too): the tensors the JAX package stores
    transposed."""
    from ..nn.layers.common import Linear

    types = (torch.nn.Linear, Linear) if port_linear else torch.nn.Linear
    ids = {id(m.weight) for m in engine.model.modules() if isinstance(m, types)}
    return {nm for nm, p in engine.params.items() if id(p) in ids}


def stored_linears(engine, path, manifest) -> set:
    """The names of the Linear weights that the checkpoint at ``path`` stores
    ``[in, out]`` (module docstring): ``torch.nn.Linear``'s always; the
    port's ``nn.Linear``'s under the ``linear_layout`` mark, not in a
    checkpoint with ``torch_generator`` and without the mark (the port's
    older layout), and otherwise where the saved shapes of the non-square
    ones say so. Raises ValueError when nothing tells."""
    every = linear_weights(engine)
    torch_only = linear_weights(engine, port_linear=False)
    port = every - torch_only
    if not port or manifest.get("linear_layout") == LINEAR_LAYOUT:
        return every
    if "torch_generator" in manifest:
        return torch_only
    transposed = set()
    for nm in port:
        shape = tuple(engine._full_shapes[nm])
        saved = manifest["params"].get(nm)
        if saved is not None and shape[0] != shape[1]:
            transposed.add(tuple(saved["shape"]) == shape[::-1])
    if len(transposed) != 1:
        raise ValueError(
            f"{path}: cannot tell whether its nn.Linear weights are stored [in, out] "
            "(the JAX package's layout) or [out, in] (the port's before it marked "
            "linear_layout): " + ("every one is square" if not transposed
                                  else "their shapes disagree"))
    return every if transposed.pop() else torch_only


def _jax_shape(shape, linear):
    return tuple(reversed(shape)) if linear else tuple(shape)


def _to_host(t, linear):
    """An owned f32-or-native numpy copy of ``t`` in the JAX layout (a
    Linear weight transposed on its device, then copied)."""
    t = t.detach()
    if linear:
        t = t.t().contiguous()
    if t.dtype == torch.bfloat16:   # numpy has no bfloat16; exact in f32
        t = t.float()
    # a copy even on the CPU: training goes on updating t while the writer runs
    return t.to("cpu", copy=True).numpy()


def _seed_words(seed: int):
    seed = int(seed) & ((1 << 64) - 1)
    return [seed >> 32, seed & 0xFFFFFFFF]


# ---------------------------------------------------------------- capture
class Snapshot:
    """A host-owned copy of one training state (numpy only), safe to hand to
    the writer thread: params {name: {"shape", "dtype", "pieces": [(ranges,
    array)]}}, opt the same keyed ``name.slot``, in the JAX layout; buffers
    the same keyed by the model's buffer names, in their own dtype."""

    __slots__ = ("step", "opt_step", "key_words", "key_shape", "params", "opt",
                 "buffers", "generator", "capture_ms")

    def __init__(self, step, opt_step, key_words, key_shape, params, opt, buffers,
                 generator, capture_ms):
        self.step = step
        self.opt_step = opt_step
        self.key_words = key_words
        self.key_shape = key_shape
        self.params = params
        self.opt = opt
        self.buffers = buffers
        self.generator = generator  # {"device", "state" (hex)} or None
        self.capture_ms = capture_ms


def _entry(arr):
    """One whole array as a manifest entry of one piece."""
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "pieces": [([[0, d] for d in arr.shape], arr)]}


def model_buffers(model) -> dict:
    """{name: buffer} of the model's persistent buffers (those its
    ``state_dict()`` carries), in state-dict order."""
    ids = {id(b) for _, b in model.named_buffers()}
    return {k: v for k, v in model.state_dict(keep_vars=True).items() if id(v) in ids}


def capture_snapshot(engine) -> Optional[Snapshot]:
    """The step thread's half of a save: the engine's full state copied to
    host memory in the JAX layout. Under ZeRO or FSDP it gathers the shards,
    a collective every rank must call, one bucket (FSDP) or one optimizer
    slot (ZeRO) at a time, each freed before the next: a save holds one
    such gathered buffer beyond the step's state. The model's buffers are
    replicated (every rank's forward updates them alike), so rank 0's copy
    is taken. Ranks other than 0 get None."""
    t0 = time.perf_counter()
    rank0 = _world_rank(engine) == 0
    lin = linear_weights(engine)
    snap_params, snap_opt = {}, {}

    def keep(out, key, nm, t):
        if rank0:
            out[key] = _entry(_to_host(t, nm in lin))

    engine._visit_params(lambda nm, t: keep(snap_params, nm, nm, t))
    engine._visit_opt(lambda nm, j, t: keep(snap_opt, f"{nm}.{j}", nm, t))
    if not rank0:
        return None
    snap_buffers = {k: _entry(_to_host(b, False)) for k, b in model_buffers(engine.model).items()}
    gen = getattr(engine.model, "generator", None)
    gen_state = None if gen is None else {
        "device": gen.device.type, "state": gen.get_state().numpy().tobytes().hex()}
    return Snapshot(step=int(engine._step_count),
                    opt_step=int(engine.optimizer._step_count),
                    key_words=_seed_words(engine._seed), key_shape=[2],
                    params=snap_params, opt=snap_opt, buffers=snap_buffers,
                    generator=gen_state, capture_ms=(time.perf_counter() - t0) * 1e3)


# ---------------------------------------------------------------- commit
def checkpoint_path(dirname: str, step: int) -> str:
    return os.path.join(dirname, f"{CKPT_PREFIX}{step:08d}")


def list_checkpoints(dirname: str) -> List[Tuple[int, str]]:
    """Committed checkpoints as (step, path), oldest first; ``.tmp``
    directories are not listed."""
    out = []
    try:
        names = os.listdir(dirname)
    except OSError:
        return out
    for name in names:
        if name.startswith(CKPT_PREFIX) and name[len(CKPT_PREFIX):].isdigit():
            out.append((int(name[len(CKPT_PREFIX):]), os.path.join(dirname, name)))
    return sorted(out)


def write_checkpoint(snap: Snapshot, dirname: str,
                     slow_write_ms: float = 0.0) -> Tuple[str, int]:
    """Commit one snapshot crash-safely (module docstring); returns (path,
    payload bytes)."""
    os.makedirs(dirname, exist_ok=True)
    final = checkpoint_path(dirname, snap.step)
    tmp = os.path.join(dirname, f"{TMP_PREFIX}{os.path.basename(final)}.{os.getpid()}")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    total = 0

    def write_npy(fn, arr):
        nonlocal total
        path = os.path.join(tmp, fn)
        with open(path, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        if slow_write_ms > 0:
            time.sleep(slow_write_ms / 1e3)
        size = os.path.getsize(path)
        total += size
        return {"file": fn, "bytes": int(size), "checksum": file_sha256(path)}

    def section(kind, entries):
        out = {}
        for key, ent in entries.items():
            shards = []
            for i, (ranges, arr) in enumerate(ent["pieces"]):
                meta = write_npy(f"{kind}__{key}__{i}.npy".replace("/", "_"), arr)
                meta["ranges"] = ranges
                shards.append(meta)
            out[key] = {"shape": ent["shape"], "dtype": ent["dtype"], "shards": shards}
        return out

    manifest = {"format": FORMAT_VERSION, "step": snap.step, "opt_step": snap.opt_step,
                "key": {"words": snap.key_words, "shape": snap.key_shape},
                "params": section("params", snap.params),
                "opt": None if snap.opt is None else section("opt", snap.opt),
                "buffers": section("buffers", snap.buffers),
                "linear_layout": LINEAR_LAYOUT, "zero_opt": None}
    if snap.generator is not None:
        manifest["torch_generator"] = snap.generator
    manifest["manifest_checksum"] = manifest_digest(manifest)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    if os.path.isdir(final):
        shutil.rmtree(final)  # a step saved again after a rollback
    os.rename(tmp, final)
    _fsync_dir(dirname)
    return final, total


# ---------------------------------------------------------------- verify
def verify_checkpoint(path: str) -> dict:
    """Parse the manifest, check its self-checksum and every payload's size
    and sha256. Returns the manifest; raises CheckpointCorrupt."""
    mpath = os.path.join(path, MANIFEST)
    if not os.path.isfile(mpath):
        raise CheckpointCorrupt(f"{path}: no manifest")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (ValueError, OSError) as e:
        raise CheckpointCorrupt(f"{path}: unreadable manifest ({e})")
    if not isinstance(manifest, dict) or manifest.get("format") != FORMAT_VERSION:
        raise CheckpointCorrupt(
            f"{path}: unsupported format {manifest.get('format')!r}"
            if isinstance(manifest, dict) else f"{path}: manifest not a dict")
    if manifest_digest(manifest) != manifest.get("manifest_checksum"):
        raise CheckpointCorrupt(f"{path}: manifest checksum mismatch")
    for kind, entries in (("params", manifest.get("params") or {}),
                          ("opt", manifest.get("opt") or {}),
                          ("buffers", manifest.get("buffers") or {})):
        for key, ent in entries.items():
            for sh in ent["shards"]:
                _verify_payload(path, kind, key, sh)
    zero = manifest.get("zero_opt")
    if zero is not None:
        for sh in zero["shards"]:
            _verify_payload(path, "zero_opt", f"slot{sh.get('slot')}", sh)
    return manifest


def _verify_payload(path, kind, key, sh):
    fpath = os.path.join(path, sh["file"])
    if not os.path.isfile(fpath):
        raise CheckpointCorrupt(f"{path}: {kind}/{key}: missing {sh['file']}")
    if os.path.getsize(fpath) != sh.get("bytes"):
        raise CheckpointCorrupt(
            f"{path}: {kind}/{key}: {sh['file']} truncated "
            f"({os.path.getsize(fpath)} != {sh.get('bytes')} bytes)")
    if file_sha256(fpath) != sh.get("checksum"):
        raise CheckpointCorrupt(f"{path}: {kind}/{key}: {sh['file']} checksum mismatch")


# ---------------------------------------------------------------- restore
def _merge_entry(path, ent, dtype=np.float32):
    """The saved pieces of one entry (each with its [start, stop) range a
    dim) merged into one host array of ``dtype``."""
    out = np.zeros(tuple(ent["shape"]), dtype)
    for sh in ent["shards"]:
        piece = np.load(os.path.join(path, sh["file"]))
        out[tuple(slice(a, b) for a, b in sh["ranges"])] = piece
    return out


def _from_jax(arr, linear):
    t = torch.from_numpy(np.ascontiguousarray(arr.T if linear else arr))
    return t.float()


def _restore_opt(engine, path, manifest, lin):
    """{name: (slot, ...)} in the port's layout from the per-name ``opt``
    sections or a JAX ZeRO checkpoint's flat ``zero_opt`` section."""
    slots = engine._zero_n_slots()
    zero = manifest.get("zero_opt")
    if zero is not None:
        if int(zero["slots"]) != slots:
            raise ValueError(f"checkpoint has {zero['slots']} optimizer slots but the "
                             f"target optimizer expects {slots}: restore needs the "
                             "same optimizer rule")
        full = np.zeros((slots, int(zero["n_pad"])), np.float32)
        for sh in zero["shards"]:
            arr = np.load(os.path.join(path, sh["file"]))
            full[int(sh["slot"]), int(sh["offset"]):int(sh["offset"]) + len(arr)] = arr
        out, off = {}, 0
        for nm in sorted(engine.params):
            shape = _jax_shape(engine._full_shapes[nm], nm in lin)
            size = math.prod(shape)
            out[nm] = tuple(_from_jax(full[j, off:off + size].reshape(shape), nm in lin)
                            for j in range(slots))
            off += size
        if off != int(zero["n"]):
            raise ValueError(f"checkpoint flat optimizer state has {zero['n']} "
                             f"elements but the target model has {off}")
        return out
    opt = manifest.get("opt")
    if opt is None:
        raise CheckpointCorrupt(f"{path}: manifest has neither opt nor zero_opt")
    out = {}
    for nm in engine.params:
        comps = []
        for j in range(slots):
            key = f"{nm}.{j}"
            if key not in opt:
                raise KeyError(f"checkpoint missing optimizer state {key}")
            comps.append(_from_jax(_merge_entry(path, opt[key]), nm in lin))
        out[nm] = tuple(comps)
    return out


def _restore_buffers(engine, path, manifest):
    """The ``buffers`` section into the model's buffers, each in its own
    dtype and device; without the section they stay as they are, with a
    warning that counts them."""
    bufs = model_buffers(engine.model)
    saved = manifest.get("buffers")
    if saved is None:
        if bufs:
            warnings.warn(f"{path} has no buffers section: {len(bufs)} buffers of the "
                          "model keep their current values")
        return
    with torch.no_grad():
        for key, buf in bufs.items():
            if key not in saved:
                raise KeyError(f"checkpoint missing buffer {key}")
            ent = saved[key]
            if tuple(ent["shape"]) != tuple(buf.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(ent['shape'])} != the "
                                 f"model's {tuple(buf.shape)}")
            buf.copy_(torch.from_numpy(_merge_entry(path, ent, np.dtype(ent["dtype"]))))


def restore_checkpoint(engine, path: str, manifest: Optional[dict] = None) -> int:
    """Load one checkpoint (verified here unless ``manifest`` is given) into
    the engine, whatever its rank count or sharding: the full parameters go
    into the model, its buffers into the model's buffers and the optimizer
    state into the optimizer, and a ZeRO
    or FSDP engine shards them again at its next step. Returns the step."""
    if manifest is None:
        manifest = verify_checkpoint(path)
    lin = stored_linears(engine, path, manifest)
    params = {}
    for nm in engine.params:
        if nm not in manifest["params"]:
            raise KeyError(f"checkpoint missing param {nm}")
        params[nm] = _from_jax(_merge_entry(path, manifest["params"][nm]), nm in lin)
    opt = _restore_opt(engine, path, manifest, lin)
    engine._load_state(params, opt, int(manifest["step"]),
                       int(manifest.get("opt_step", manifest["step"])))
    _restore_buffers(engine, path, manifest)
    key = manifest.get("key")
    if key and key.get("words"):
        w = [int(x) & 0xFFFFFFFF for x in key["words"]]
        engine._seed = (w[-2] << 32 | w[-1]) if len(w) >= 2 else w[-1]
    gen = getattr(engine.model, "generator", None)
    if gen is not None:
        saved = manifest.get("torch_generator")
        if saved and saved.get("device") == gen.device.type:
            gen.set_state(torch.frombuffer(bytearray.fromhex(saved["state"]),
                                           dtype=torch.uint8).clone())
        else:   # a JAX checkpoint, or one of another device: the seed alone
            gen.manual_seed(engine._seed)
    return int(manifest["step"])


def restore_latest(engine, dirname: str) -> int:
    """Restore the newest valid checkpoint under ``dirname``: corrupt ones
    are skipped with a warning and a ``ckpt.corrupt`` count. Raises
    FileNotFoundError when none verifies."""
    last_err = None
    for _step, path in reversed(list_checkpoints(dirname)):
        try:
            manifest = verify_checkpoint(path)
        except CheckpointCorrupt as e:
            last_err = e
            CORRUPT.increase()
            warnings.warn(f"skipping corrupt checkpoint {path}: {e}")
            fr = _obs_flight.get()
            if fr is not None:
                fr.dump("ckpt_corrupt", {"path": path, "error": str(e)})
            continue
        restored = restore_checkpoint(engine, path, manifest)
        RESTORES.increase()
        return restored
    if last_err is not None:
        raise FileNotFoundError(f"no valid checkpoint under {dirname} "
                                f"(newest error: {last_err})")
    raise FileNotFoundError(f"no checkpoint under {dirname}")


# ---------------------------------------------------------------- manager
def _multi(engine) -> bool:
    return engine.world_group is not None and engine.world_group.nranks > 1


def _world_rank(engine) -> int:
    """The engine's rank among every rank (its replica rank at mp = 1):
    rank 0 writes."""
    return 0 if engine.world_group is None else engine.world_group.rank


class CheckpointManager:
    """One checkpoint directory: periodic async saves, retention, the newest
    valid restore, opt-in rollback on a non-finite loss (reference
    elastic.py:574). The engine drives it (``enable_checkpointing``,
    ``FLAGS_ckpt_*``); alone::

        mgr = CheckpointManager(dirname, interval=100, keep=3)
        for step in range(1, steps + 1):
            loss = engine.step(ids, labels)
            mgr.on_step(engine, step, loss)
        mgr.close()
    """

    def __init__(self, dirname: str, interval: int = 100, keep: int = 3,
                 async_save: bool = True, rollback_on_nonfinite: bool = False,
                 slow_write_ms: Optional[float] = None):
        self.dirname = str(dirname)
        os.makedirs(self.dirname, exist_ok=True)
        self.interval = max(1, int(interval))
        self.keep = max(1, int(keep))
        self.async_save = bool(async_save)
        self.rollback_on_nonfinite = bool(rollback_on_nonfinite)
        if slow_write_ms is None:
            slow_write_ms = os.environ.get("PADDLE_TPU_CKPT_SLOW_WRITE_MS", "0") or 0
        self._slow_write_ms = float(slow_write_ms)
        self._q = queue.Queue(maxsize=2)
        self._thread = None
        self._pending = 0
        self._cond = threading.Condition()
        self._closed = False
        self.last_error = None
        self.last_saved_step = None
        self.last_capture_ms = None
        self.last_save_ms = None
        self.last_bytes = None

    # ---- background writer ----
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._worker, name="ckpt-writer",
                                            daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            snap = self._q.get()
            if snap is None:
                return
            try:
                self._commit(snap, overlap=True)
            except Exception as e:
                self._note_failure(snap.step, e)
            finally:
                with self._cond:
                    self._pending -= 1
                    self._cond.notify_all()

    def _note_failure(self, step, e):
        self.last_error = e
        FAILURES.increase()
        fr = _obs_flight.get()
        if fr is not None:
            fr.dump("ckpt_save_failed", {"step": step, "error": repr(e)})
        warnings.warn(f"checkpoint save failed at step {step}: {e!r}")

    def _commit(self, snap, overlap=False):
        t0 = time.perf_counter()
        _path, nbytes = write_checkpoint(snap, self.dirname,
                                         slow_write_ms=self._slow_write_ms)
        self.last_save_ms = (time.perf_counter() - t0) * 1e3
        self.last_capture_ms, self.last_bytes = snap.capture_ms, nbytes
        SAVES.increase()
        BYTES_WRITTEN.increase(nbytes)
        self.last_saved_step = snap.step
        reg = _obs_metrics.active_registry()
        if reg is not None:
            reg.histogram("ckpt.save_ms").observe(self.last_save_ms)
            reg.histogram("ckpt.capture_ms").observe(snap.capture_ms)
            if overlap:
                # the writer's wall while the training thread kept stepping
                reg.histogram("ckpt.overlap_ms").observe(self.last_save_ms)
        self._gc()

    def _gc(self):
        for _step, path in list_checkpoints(self.dirname)[:-self.keep]:
            shutil.rmtree(path, ignore_errors=True)
            GC_REMOVED.increase()
        for name in os.listdir(self.dirname):
            if not name.startswith(TMP_PREFIX):
                continue
            pid = name.rsplit(".", 1)[-1]
            if pid.isdigit() and int(pid) != os.getpid() and not _pid_alive(int(pid)):
                # a crashed writer's leftovers: never part of a commit
                shutil.rmtree(os.path.join(self.dirname, name), ignore_errors=True)

    def _agree(self, engine, busy: bool) -> bool:
        """Rank 0's ``busy`` on every rank (one broadcast over the engine's
        group; the identity on one rank)."""
        if not _multi(engine):
            return busy
        t = torch.tensor([int(busy)], dtype=torch.int32, device=engine.device)
        collective.broadcast(t, src=engine.world_group.ranks[0], group=engine.world_group)
        return bool(t.item())

    # ---- public API ----
    def save(self, engine, block: bool = False) -> bool:
        """Snapshot now. Async (the default): capture on this thread and hand
        the copy to the writer; False, with a ``ckpt.skipped`` count, when a
        snapshot is writing and another queued. ``block=True`` commits before
        returning and raises a write error. Every rank of the engine's group
        calls it; rank 0 writes."""
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        rank = _world_rank(engine)
        if not (self.async_save and not block):
            snap = capture_snapshot(engine)
            if rank == 0:
                try:
                    self._commit(snap)
                except Exception as e:
                    self._note_failure(snap.step, e)
                    raise
            return True
        with self._cond:
            busy = rank == 0 and self._pending >= 2
        if self._agree(engine, busy):
            SKIPPED.increase()
            return False
        snap = capture_snapshot(engine)
        if rank == 0:
            with self._cond:
                self._pending += 1
            self._ensure_thread()
            self._q.put(snap)
        return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Drain the writer; True when idle."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending > 0:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining if remaining is not None else 0.5)
        return True

    def _settle(self, engine):
        """Rank 0's writer drained, then every rank at a barrier: the
        directory holds every commit before any rank reads it."""
        self.wait()
        if _multi(engine):
            collective.barrier(engine.world_group)

    def on_step(self, engine, step: int, loss=None, window: int = 1) -> Optional[int]:
        """The engine's per-step hook: with rollback on, a non-finite loss
        restores the newest valid checkpoint (returns its step); else a save
        when any step of ``(step - window, step]`` lands on the interval
        (``window``: the optimizer steps this call covers, K for
        ``run_steps``)."""
        if self._closed:
            return None
        if self.rollback_on_nonfinite and loss is not None:
            lv = float(loss)
            if not math.isfinite(lv):
                return self._rollback(engine, step, lv)
        if step // self.interval > (step - window) // self.interval:
            self.save(engine)
        return None

    def _rollback(self, engine, step, loss_value):
        fr = _obs_flight.get()
        if fr is not None:
            fr.dump("ckpt_rollback", {"step": step, "loss": loss_value})
        self._settle(engine)
        try:
            restored = restore_latest(engine, self.dirname)
        except FileNotFoundError:
            warnings.warn(f"non-finite loss at step {step} but no valid checkpoint "
                          f"under {self.dirname} to roll back to")
            return None
        ROLLBACKS.increase()
        warnings.warn(f"non-finite loss ({loss_value}) at step {step}: rolled back "
                      f"to checkpoint step {restored}")
        return restored

    def restore(self, engine) -> int:
        """Restore the newest valid checkpoint (a corrupt one falls back)."""
        self._settle(engine)
        return restore_latest(engine, self.dirname)

    def checkpoints(self) -> List[Tuple[int, str]]:
        return list_checkpoints(self.dirname)

    def close(self):
        """Drain and stop the writer. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.wait()
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=30)
        self._thread = None


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        pass
    return True


def from_flags() -> Optional[CheckpointManager]:
    """FLAGS_ckpt_dir (or PADDLE_TPU_CKPT_DIR) turns checkpoints on at engine
    construction; empty means off."""
    dirname = _flags.flag("ckpt_dir")
    if not dirname:
        return None
    return CheckpointManager(dirname, interval=int(_flags.flag("ckpt_interval")),
                             keep=int(_flags.flag("ckpt_keep")),
                             async_save=bool(_flags.flag("ckpt_async")),
                             rollback_on_nonfinite=bool(_flags.flag("ckpt_rollback")))
