"""Train step (counterpart of paddle_tpu/distributed/engine.py's
``TrainStepEngine``: ``step`` at engine.py:1853, the step body at
``_raw_step``, engine.py:824-871, the data-parallel step of ``_accum_step``,
engine.py:1497, and grad_comm's accumulation and ZeRO steps).

``step(ids, labels)`` advances the step count, reads the learning rate,
runs the model's forward (which returns the scalar loss) and backward under
whatever ``amp.auto_cast`` the caller holds, clips the gradients with the
optimizer's rule, and applies the optimizer's rule to the f32 parameters and
f32 state in place. It returns the loss.

One process, K = 1, f32 payload, no ZeRO, no process group: the plain step
above, unchanged. Otherwise the step is grad_comm's (distributed/grad_comm.py):

- **Data parallelism.** Under a process group (``fleet.init``, or an
  ``hcg`` built after ``init_parallel_env``) every rank is handed the
  **global** batch and takes its rows ``[r*B/N, (r+1)*B/N)``, as the JAX
  engine's batch sharding does, so a script runs unchanged at 1 and at N
  ranks. A batch dim not divisible by K x N raises.
- **Microbatches.** With ``microbatches=K`` the rank's rows split into K
  consecutive microbatches; their f32 gradients are summed into one flat
  buffer (after the first backward each parameter's ``grad`` is a view of
  it, and autograd accumulates in place), which is divided by K: the rank's
  mean gradient. The loss is the mean of the K losses.
- **The one deferred reduce** of that buffer over the replicas
  (``grad_comm.reduce_local``; payload ``FLAGS_grad_comm_dtype`` f32, bf16
  or int8, error feedback ``FLAGS_grad_comm_error_feedback``), then the
  clip and the update of every parameter. The order is the reference's:
  the rank's mean, then the mean over ranks. After the step each
  parameter's ``grad`` holds the reduced mean gradient before the clip.
- **ZeRO** (``zero_update=True``, ``FLAGS_zero_update``, the strategy's
  ``sharding``, or a ``sharding_degree`` above 1): reduce-scatter, the rank's slice clipped
  and updated with the optimizer's rule over flat f32 shards
  (``optimizer.functional.make_flat_update``), all-gather of the new
  weights into the parameters. The optimizer's per-parameter state is
  moved into the rank's flat shards at the first ZeRO step and dropped
  from the optimizer, so only 1/N of it stays allocated; ``state_dict()``
  gathers it back. The JAX engine shards the optimizer state of
  ``strategy.sharding`` or a ``sharding_degree`` above 1 by GSPMD specs
  instead; the flat shards give
  the same numbers. ZeRO needs one elementwise rule with the same kwargs
  for every parameter and a clip that is None, ``ClipGradByGlobalNorm`` or
  ``ClipGradByValue``; otherwise it warns once and runs the replicated
  update, as the JAX engine does.
- **Dropout.** Over more than one rank each microbatch reseeds the model's
  dropout generator (``model.generator``) from (seed, rank, step,
  microbatch), so ranks draw different masks and a run repeats exactly.
  The JAX engine folds the replica index into its key instead; the masks
  of the two packages differ by design (ROADMAP.md, "Sampling decision").

A collective over a group of one rank is still called (the backend runs it
as the identity), and the ``grad_comm.*`` byte counters count every call;
the JAX engine counts nothing on one replica. Without a process group no
collective is called and the low-precision payloads still round-trip.

PyTorch runs eagerly, so there is no compiled step to build, cache or
donate into. Not ported yet (ROADMAP.md): telemetry and health,
checkpoints, FSDP, hybrid meshes, CUDA graphs around the step, and the
overlap of the reduce with the backward.
"""
from __future__ import annotations

import warnings

import torch

from ..core import flags as _flags
from ..nn.clip import ClipGradByGlobalNorm, ClipGradByValue
from ..optimizer import functional as opt_funct
from . import collective
from . import grad_comm as _gc
from .mesh import get_hybrid_communicate_group

_M64 = (1 << 64) - 1


def _fold_seed(*xs) -> int:
    """A 63-bit seed mixed from the integers ``xs`` (splitmix64 steps)."""
    h = 0x9E3779B97F4A7C15
    for x in xs:
        h = ((h ^ (int(x) & _M64)) * 0xBF58476D1CE4E5B9) & _M64
        h ^= h >> 31
        h = (h * 0x94D049BB133111EB) & _M64
        h ^= h >> 29
    return h & ((1 << 63) - 1)


class TrainStepEngine:
    """Fused train step of ``model`` (whose ``forward(*batch)`` returns the
    scalar loss) with ``optimizer``, on the model's device.

    Every trainable parameter of the model must be one of the optimizer's;
    its state and its weight-decay decision go by the optimizer's name for
    it. ``hcg``: the topology (default: the one ``fleet.init`` set, if any);
    ``strategy``: a ``fleet.DistributedStrategy``, whose ``sharding`` turns
    ZeRO on; ``microbatches`` (also a mutable attribute) is K and ``zero_update``
    turns ZeRO on (module docstring)."""

    def __init__(self, model, optimizer, hcg=None, strategy=None,
                 microbatches: int = 1, zero_update: bool = False):
        self.model = model
        self.optimizer = optimizer
        self.microbatches = max(1, int(microbatches))
        self.hcg = hcg if hcg is not None else get_hybrid_communicate_group()
        self.strategy = strategy
        self.group = (self.hcg.replica_group()
                      if self.hcg is not None and self.hcg.distributed else None)
        opt_names = {id(p): n for n, p in zip(optimizer._param_names,
                                               optimizer._parameter_list)}
        self.params = {}
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            if id(p) not in opt_names:
                raise ValueError(f"parameter {name!r} of the model is not one of "
                                 "the optimizer's parameters")
            self.params[opt_names[id(p)]] = p
        self._step_count = optimizer._step_count
        self.last_loss = None
        self.zero_update = bool(zero_update)
        self._zero_opt = None          # the rank's flat [shard] f32 state slots
        self._zero_warned = False
        self._zero_reason = "unset"    # cached fallback reason (None = ZeRO can run)
        self._grad_residual = None     # the rank's [n] f32 error-feedback buffer
        self._layouts = {}             # chunk -> grad_comm.FlatLayout
        gen = getattr(model, "generator", None)
        self._seed = gen.initial_seed() if gen is not None else 0

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def _to_device(self, x):
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def step(self, *batch):
        """One optimizer step on ``batch`` (tensors or arrays, moved to the
        model's device; under a group, the global batch). Returns the loss
        (a detached 0-dim tensor; under a group, the mean over ranks)."""
        batch = [self._to_device(b) for b in batch]
        k = self.microbatches
        dtype = _gc.comm_dtype()
        zero = self._zero_on()
        if self.group is None and k == 1 and dtype == "f32" and not zero:
            return self._plain_step(batch)
        return self._comm_step(batch, k, dtype, zero)

    def _begin_step(self):
        opt = self.optimizer
        self._step_count += 1
        opt._step_count = self._step_count  # keep checkpoints consistent
        for p in self.params.values():
            p.grad = None
        return opt.get_lr()

    def _plain_step(self, batch):
        opt = self.optimizer
        lr_val = self._begin_step()
        loss = self.model(*batch)
        loss.backward()
        with torch.no_grad():
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in self.params.items()}
            grads = opt_funct.clip_grads(grads, opt._grad_clip)
            opt._apply(self.params, grads, lr_val, self._step_count)
        self.last_loss = loss.detach()
        return self.last_loss

    # ---- the grad_comm step ----
    def _flat_layout(self, chunk):
        lay = self._layouts.get(chunk)
        if lay is None:
            lay = self._layouts[chunk] = _gc.FlatLayout(
                {n: tuple(p.shape) for n, p in self.params.items()},
                _gc.replica_count(self.group), chunk)
        return lay

    def _n_grad_elems(self) -> int:
        return self._flat_layout(_gc.chunk_size()).n

    def _views(self, buf, layout):
        return {nm: buf[layout.offsets[nm]:layout.offsets[nm] + p.numel()].view(p.shape)
                for nm, p in self.params.items()}

    def _comm_step(self, batch, k, dtype, zero):
        group = self.group
        nrep = _gc.replica_count(group)
        for b in batch:
            if b.dim() and b.shape[0] % (k * nrep):
                raise ValueError(
                    f"batch dim {b.shape[0]} is not divisible by microbatches = {k} "
                    f"x replicas = {nrep}; pad or resize the batch")
        if nrep > 1:
            r = group.rank
            batch = [b.chunk(nrep)[r] if b.dim() else b for b in batch]
        chunk = _gc.chunk_size()
        use_res = dtype != "f32" and _gc.error_feedback()
        layout = self._flat_layout(chunk)
        opt = self.optimizer
        lr_val = self._begin_step()
        n = layout.n
        # ZeRO's buffer also takes the all-gather of the new weights, one
        # [shard + 1] row a rank, once the reduce-scatter has consumed it
        buf, loss = self._accumulate(batch, k, layout,
                                     layout.n_pad + layout.nrep if zero else n + 1)
        with torch.no_grad():
            if k > 1:
                buf[:n].div_(k)
            res = self._ensure_residual(n) if use_res else None
            if zero:
                self._zero_step(buf, layout, loss, dtype, chunk, res, lr_val)
                rs_b, ag_b = ((0, 0) if group is None else
                              _gc.zero_payload_bytes(n, nrep, dtype, chunk))
                _gc.RS_BYTES.increase(rs_b)
                _gc.AG_BYTES.increase(ag_b)
                comm_bytes = rs_b + ag_b
            else:
                red, self.last_loss = _gc.reduce_local(buf, n, loss, group, dtype,
                                                       chunk, res)
                grads = {nm: v.to(self.params[nm].dtype)
                         for nm, v in self._views(red, layout).items()}
                clipped = opt_funct.clip_grads(grads, opt._grad_clip)
                opt._apply(self.params, clipped, lr_val, self._step_count)
                for nm, p in self.params.items():
                    p.grad = grads[nm]
                comm_bytes = (0 if group is None else _gc.payload_bytes(n, dtype, chunk))
        _gc.STEPS.increase()
        _gc.MICROBATCHES.increase(k)
        _gc.BYTES_MOVED.increase(comm_bytes)
        if dtype != "f32":
            _gc.LOWP_STEPS.increase()
        return self.last_loss

    def _seed_dropout(self, i):
        """Over more than one rank: reseed the model's dropout generator for
        microbatch i from (seed, rank, step, i)."""
        gen = getattr(self.model, "generator", None)
        if gen is not None and self.group is not None and self.group.nranks > 1:
            gen.manual_seed(_fold_seed(self._seed, self.group.rank,
                                       self._step_count, i))

    def _accumulate(self, batch, k, layout, size):
        """Forward and backward of each of the k microbatches of ``batch``,
        their f32 gradients summed into a new flat f32 buffer of ``size``
        elements (``layout``'s offsets, zeros past n). Returns the buffer
        and the mean loss, and leaves every ``grad`` None.

        The buffer is allocated after the first backward, when the
        activations are freed, and each gradient is copied into it and
        released at once, so the step's peak memory is the plain step's.
        An f32 parameter's ``grad`` then becomes its view of the buffer, and
        autograd accumulates the later microbatches into it in place; a
        gradient of another dtype is added after each backward."""
        parts = [b.chunk(k) if b.dim() else [b] * k for b in batch]
        buf = views = None
        attached, losses = set(), []
        for i in range(k):
            self._seed_dropout(i)
            loss = self.model(*(p[i] for p in parts))
            loss.backward()
            losses.append(loss.detach())
            with torch.no_grad():
                if buf is None:
                    buf = torch.zeros(size, dtype=torch.float32, device=self.device)
                    views = self._views(buf, layout)
                for nm, p in self.params.items():
                    v, g = views[nm], p.grad
                    if nm in attached:
                        if g is not v:
                            raise RuntimeError(f"autograd replaced the gradient buffer "
                                               f"of {nm!r} instead of accumulating")
                        continue
                    if g is None:
                        continue
                    if i == 0:
                        v.copy_(g)
                    else:
                        v.add_(g.float())
                    if i + 1 < k and p.dtype == torch.float32 and p.device == v.device:
                        p.grad = v
                        attached.add(nm)
                    else:
                        p.grad = None
        for p in self.params.values():
            p.grad = None
        return buf, losses[0] if k == 1 else torch.stack(losses).mean()

    def _ensure_residual(self, n):
        if self._grad_residual is None:
            self._grad_residual = torch.zeros(n, dtype=torch.float32, device=self.device)
        return self._grad_residual

    # ---- ZeRO weight-update sharding ----
    def _zero_requested(self) -> bool:
        return bool(self.zero_update or _flags.flag("zero_update")
                    or getattr(self.strategy, "sharding", False)
                    or (self.hcg is not None and self.hcg.degrees["sharding"] > 1))

    def _zero_fallback_reason(self):
        """None when ZeRO can engage; else why not (cached: every input is
        fixed for the engine's life)."""
        if self._zero_reason != "unset":
            return self._zero_reason
        opt = self.optimizer
        names = list(self.params)
        reason = None
        if not names:
            reason = "no trainable parameters"
        elif opt._rule not in opt_funct.RULES:
            reason = f"optimizer rule {opt._rule!r} is not uniform-elementwise"
        elif any(opt._rule_kwargs(nm) != opt._rule_kwargs(names[0]) for nm in names):
            reason = ("per-parameter rule kwargs differ (e.g. weight-decay "
                      "exclusions): the flat shard update needs ONE uniform rule")
        elif not (opt._grad_clip is None or isinstance(
                opt._grad_clip, (ClipGradByGlobalNorm, ClipGradByValue))):
            reason = (f"grad clip {type(opt._grad_clip).__name__} needs "
                      "per-parameter norms")
        self._zero_reason = reason
        return reason

    def _zero_on(self) -> bool:
        """True when this step runs the ZeRO update (requested and
        possible); a request that cannot run warns once."""
        if not self._zero_requested():
            return False
        reason = self._zero_fallback_reason()
        if reason is None:
            return True
        if not self._zero_warned:
            warnings.warn("zero_update requested but falling back to the "
                          f"replicated update: {reason}")
            self._zero_warned = True
        return False

    def _zero_n_slots(self) -> int:
        return len(opt_funct.init_state(self.optimizer._rule, torch.zeros(1)))

    def _rank(self):
        return 0 if self.group is None else self.group.rank

    def _ensure_zero_opt(self, layout):
        """The rank's flat [shard] f32 state slots; built at the first ZeRO
        step from the optimizer's per-parameter state (zeros where it has
        none), which is then dropped from the optimizer."""
        if self._zero_opt is not None:
            if self._zero_opt and self._zero_opt[0].shape[0] != layout.shard:
                raise ValueError(
                    "the flat sharded optimizer state was built for another "
                    f"layout ({self._zero_opt[0].shape[0]} != {layout.shard} "
                    "elements): FLAGS_grad_comm_chunk changed after the first "
                    "ZeRO step; rebuild the engine")
            return self._zero_opt
        lo = self._rank() * layout.shard
        states = self.optimizer._states
        slots = []
        for j in range(self._zero_n_slots()):
            s = torch.zeros(layout.shard, dtype=torch.float32, device=self.device)
            for nm, a, b in layout.pieces(lo, lo + layout.shard):
                if nm in states:
                    o = layout.offsets[nm] - lo
                    s[o + a:o + b] = states[nm][j].reshape(-1)[a:b]
            slots.append(s)
        self._zero_opt = tuple(slots)
        states.clear()  # the flat shards are the state now
        return self._zero_opt

    def _zero_step(self, buf, layout, loss, dtype, chunk, res, lr_val):
        group, opt = self.group, self.optimizer
        lo = self._rank() * layout.shard
        g, loss_part = _gc.zero_scatter(buf, layout, loss, group, dtype, chunk, res)
        p_shard = torch.zeros(layout.shard, dtype=torch.float32, device=self.device)
        for nm, a, b in layout.pieces(lo, lo + layout.shard):
            o = layout.offsets[nm] - lo
            p_shard[o + a:o + b] = self.params[nm].detach().reshape(-1)[a:b]
        _gc.clip_shard(g, opt._grad_clip, group)
        update = opt_funct.make_flat_update(opt, next(iter(self.params)),
                                            block=_gc.BLOCK)
        update(p_shard, g, self._ensure_zero_opt(layout), lr_val, self._step_count)
        del g
        rows, self.last_loss = _gc.zero_gather(p_shard, loss_part, group, layout.nrep,
                                               dtype != "int8", out=buf)
        del p_shard
        for i in range(layout.nrep):
            base = i * layout.shard
            for nm, a, b in layout.pieces(base, base + layout.shard):
                o = layout.offsets[nm] - base
                self.params[nm].detach().view(-1)[a:b].copy_(rows[i, o + a:o + b])

    def _gather_zero_opt(self):
        """The optimizer state as {name: (slot, ...)} in each parameter's
        shape: gathered from every rank's flat shards under ZeRO (a
        collective: every rank must call it), else the optimizer's own."""
        if self._zero_opt is None:
            return dict(self.optimizer._states)
        layout = self._flat_layout(_gc.chunk_size())
        flats = []
        for s in self._zero_opt:
            full = torch.empty(layout.n_pad, dtype=torch.float32, device=s.device)
            collective.all_gather_into(full, s, group=self.group)
            flats.append(full)
        out = {}
        for nm in layout.names:
            off, shape = layout.offsets[nm], layout.shapes[nm]
            size = int(torch.Size(shape).numel())
            out[nm] = tuple(f[off:off + size].reshape(shape).clone() for f in flats)
        return out

    def state_dict(self):
        """{"model": the model's state dict, "optimizer": the optimizer's
        (``Optimizer.state_dict`` keys)}; under ZeRO the optimizer state is
        gathered from every rank's shards first."""
        states = self._gather_zero_opt() if self._zero_opt is not None else None
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(states=states)}

    def zero_memory_model(self):
        """Optimizer-state bytes a rank holds: replicated against ZeRO's
        flat shards (~1/N), the JAX engine's accounting."""
        layout = self._flat_layout(_gc.chunk_size())
        slots = self._zero_n_slots()
        return {
            "opt_slots": slots,
            "replicas": layout.nrep,
            "n_grad_elems": layout.n,
            "n_pad": layout.n_pad,
            "replicated_opt_bytes": slots * layout.n * 4,
            "sharded_opt_bytes_per_device": slots * layout.shard * 4,
        }
