"""Train step (counterpart of paddle_tpu/distributed/engine.py's
``TrainStepEngine``: ``step`` at engine.py:1853, the step body at
``_raw_step``, engine.py:824-871, the data-parallel step of ``_accum_step``,
engine.py:1497, and grad_comm's accumulation and ZeRO steps).

``step(ids, labels)`` advances the step count, reads the learning rate,
runs the model's forward (which returns the scalar loss) and backward under
whatever ``amp.auto_cast`` the caller holds, clips the gradients with the
optimizer's rule, and applies the optimizer's rule (any of the ten, with
its per-parameter kwargs) to the f32 parameters and f32 state in place. It
returns the loss. As in the JAX engine, an ``L1Decay`` is not applied here:
only the eager ``Optimizer.step`` adds it.

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
  the same numbers. ZeRO needs one elementwise rule
  (``functional.ELEMENTWISE_RULES``: not Lamb or Lars, whose norms are per
  parameter) with the same kwargs for every parameter and a clip that is
  None, ``ClipGradByGlobalNorm`` or ``ClipGradByValue``; otherwise it warns
  once and runs the replicated update, as the JAX engine does.
- **FSDP** (``fsdp=True``, ``FLAGS_fsdp``; ZeRO's eligibility gate, and
  it supersedes ZeRO): parameters and optimizer state live only as the
  rank's f32 shards of per-layer buckets (``grad_comm.fsdp_buckets``; the
  model's ``fsdp_layer_key`` groups them, one bucket a GPT block). A step
  all-gathers each bucket into the parameters' storage, asynchronously, up
  to ``FLAGS_fsdp_prefetch`` gathers ahead in the forward's order (each
  module's forward pre-hook waits for its own bucket), runs the K
  microbatches, releases the gathered storage, reduce-scatters the flat
  gradient once (bucket-shard-major rows that carry the loss;
  ``grad_comm.fsdp_pack`` / ``fsdp_scatter``), clips the shards
  (``clip_shard``) and updates them bucket by bucket. There is no trailing
  parameter gather: between steps a rank holds 1/N of the f32 parameters
  and of the optimizer state, and the model's parameters are empty.
  ``state_dict()`` and ``sync_to_model()`` gather them back (collectives:
  every rank calls them). The first FSDP step gathers every bucket before
  its forward and records the order in which the modules wait for them;
  later steps prefetch in that order. The conversion to shards is one-way,
  as in the reference: a step with fsdp turned off after it raises.
  Past 2 ranks each rank's loss is the replicas' sum in the order its
  reduce-scatter takes, so the losses may differ in the last bits between
  ranks; the weights do not.
- **strategy.amp** (JAX engine.py:778-790): the forward of every step runs
  under ``amp.amp_guard_from_configs(strategy.amp_configs,
  force_bf16=True)`` (float16 becomes bfloat16: the step has no loss
  scaling), inside whatever ``auto_cast`` the caller holds.
- **Offload** (the optimizer's ``_offload``, set by the group-sharded
  wrappers; JAX engine.py:167-185): the optimizer state stays in pinned
  host memory between steps and is moved to the card for the update, in
  the replicated update (``Optimizer._apply``) and in ZeRO's (the rank's
  flat shards). The numbers are those without it. FSDP with offload raises
  (ROADMAP.md Queue 1 item 3).
- **GroupShardedStage3's marks** (``dist_attr`` on the model's parameters)
  under ``sharding_degree > 1`` run the FSDP step below. The JAX engine
  shards only the marked parameters along their marked dim; FSDP shards
  every parameter in whole per-layer buckets. Both give the replicated
  step's numbers.
- **Checkpoints** (``enable_checkpointing``, ``FLAGS_ckpt_dir``): every step
  ends in the ``elastic.CheckpointManager``'s ``on_step`` (crash-safe saves
  in the JAX package's layout, newest-valid restore, rollback on a
  non-finite loss).
- **Observability** (reference engine.py:219-301, :702-727): telemetry
  (``enable_telemetry``, ``PADDLE_TPU_TELEMETRY_DIR``: one
  ``StepTelemetry`` record a step, with the grad_comm step's
  ``microbatches``, ``grad_comm_*``, ``zero_update`` and ``fsdp*`` fields),
  the health monitor (``enable_health``, ``FLAGS_health_monitor``,
  ``PADDLE_TPU_HEALTH_DIR``: observability/health.py's stats on interval
  steps, from the pre-clip gradients; under ZeRO and FSDP each rank's
  partial is summed over the replicas by one all_reduce on those steps,
  which every rank takes alike), the flight recorder's step records and
  its ``train_step_exception`` / ``run_steps_exception`` / ``train_loss``
  dumps, the metrics registry's ``train.step_ms``, ``train.h2d_ms`` and
  ``train.run_steps_ms`` histograms, and the tracer's ``engine.step``,
  ``engine.accum_step`` and ``engine.run_steps`` spans. Their wall time
  ends in a device read of the loss, taken only while telemetry, the
  flight recorder or the metrics registry is on: with all of them off a
  step launches and syncs nothing more than without them. An eager step
  compiles nothing, so ``compiled`` is always False.
- **run_steps** (reference :1716) takes K optimizer steps in one call on a
  batch with a leading [K] axis, or on one batch K times (``steps=K``): a
  loop over the K = 1 step (the plain step; under a group, the f32 reduce
  whatever ``microbatches`` and the payload flag say, as the reference's
  scan of its plain step), one telemetry record with ``steps_fused``, no
  health stats, one checkpoint hook with ``window=K``. It refuses ZeRO and
  FSDP. **prefetch** (reference :1940) stages the next batches on the card
  on a side stream (``prefetcher.DevicePrefetcher``); ``step`` records
  their ``h2d_ms`` and ``prefetch_depth``.
- **Tensor and sequence parallelism** (``hybrid_configs`` ``mp_degree`` and
  ``sep_degree``; the model built from the mp layers after ``fleet.init``,
  meta_parallel/mp_layers.py). Each rank takes its replica's rows (its
  ``dp x sharding`` index) and, under sp, its sp index's block of the
  sequence dim of every batch tensor with one; mp ranks take the same
  data. The forward runs inside ``sequence_parallel_scope`` (the
  strategy's ``sep_impl``, "ulysses" by default) when sp > 1. The loss is
  the global mean (the rank's mean over equal shards, averaged by the
  reduce), every gradient is reduced over ``hcg.replica_group()`` (the
  ranks with this rank's mp coordinate, dp x sharding x sp), and the
  global-norm clip sums the squares of mp-sharded gradients over the mp
  group and counts replicated ones once. ZeRO and microbatches compose
  with both. ``state_dict()`` gathers the mp shards into the logical
  tensors (an mp = 1 model's) and ``set_state_dict()`` slices them back,
  so an mp run's state resumes at mp = 1 and, through the checkpoints, in
  the JAX package. At mp > 1 or sp > 1 these raise ``NotImplementedError``
  (ROADMAP.md Queue 1 item 9): FSDP, the bf16 and int8 payloads, the
  health monitor, and at mp > 1 Lamb, Lars and ``ClipGradByNorm`` (norms of
  whole parameters).
- **Pipeline and expert parallelism** (``pp_degree``, ``ep_degree``; the
  model built after ``fleet.init``: ``GPTForPretrainingPipe`` holds the
  rank's stage, meta_parallel/moe.py's experts the rank's 1/ep). pp and ep
  ranks take the same rows, as mp ranks do; the pipeline itself runs
  inside the model's forward (distributed/pipeline_schedule.py). Every
  gradient is reduced over ``replica_group()`` (the ranks with this rank's
  pp, ep and mp coordinates); the global-norm clip sums the squares of each
  gradient over the groups of the axes that split it (a stage's over pp,
  an expert's over ep, a shard's over mp) and counts the rest once. ZeRO
  and microbatches compose with them as with mp; ``state_dict()``,
  ``set_state_dict()`` and the checkpoints move the logical tensors (a
  Pipe's ``[S, Lp, ...]`` whole), so a pp run resumes at pp = 1 and in the
  JAX engine. At pp or ep above one rank what item 9 refuses at mp is
  refused naming ROADMAP.md Queue 1 item 11.
- **loss_fn and state buffers.** With ``loss_fn`` (JAX engine.py:802-808)
  the model eats ``batch[:n_in]`` and ``loss_fn(*outputs, *batch[n_in:])``
  is the loss. The model's buffers (batch norm's ``_mean`` and
  ``_variance``) live in the model, are updated in place by each
  forward (every microbatch's, as the JAX package's eager op updates
  them), are carried across steps, ZeRO and FSDP, come back in
  ``state_dict()`` and go in with ``set_state_dict()``. The JAX engine's
  ``functional_call`` drops those updates and leaves the running
  statistics at their initial values (ROADMAP.md, "Deliberate
  differences"). Under a replica group of more than one rank the forward
  runs inside ``nn_functional.batch_group_scope``: the batch statistics
  and the valid-label denominators of a mean are the global batch's, as
  under the JAX engine's pjit of its K = 1 step, so every rank ends the
  step with the same running statistics. With K > 1 microbatches they are
  those of microbatch i of every rank together; the JAX engine's
  shard_map accumulation takes them per rank. The elastic checkpoints
  carry them too (distributed/elastic.py's ``buffers`` sections).
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
donate into. Not ported yet (ROADMAP.md): a world size changed in process
(``reform_mesh``), CUDA graphs around the step (under ``run_steps`` too),
and the overlap of the reduce with the backward.
"""
from __future__ import annotations

import contextlib
import math
import time
import warnings
import weakref

import torch

from ..core import flags as _flags
from ..core import monitor as _monitor
from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, _sq_norm
from ..observability import exporter as _obs_exporter
from ..observability import flight_recorder as _obs_flight
from ..observability import health as _obs_health
from ..observability import metrics as _obs_metrics
from ..observability import tracer as _obs_tracer
from ..observability.step_telemetry import JsonlSink, StepTelemetry
from ..optimizer import _to_host
from ..ops import nn_functional as F
from ..optimizer import functional as opt_funct
from . import collective
from . import elastic as _elastic
from . import grad_comm as _gc
from . import prefetcher as _pf
from .mesh import get_hybrid_communicate_group
from .meta_parallel import mp_layers as _mpl
from .meta_parallel import sequence_parallel as _sp

_ITEM9 = "ROADMAP.md Queue 1 item 9"
_ITEM11 = "ROADMAP.md Queue 1 item 11"
# the axes that split a parameter, in the order a logical tensor is sliced
_SPLIT_AXES = ("pp", "ep", "mp")

_M64 = (1 << 64) - 1
_NAN_LOSS_STEPS = _monitor.stat("engine.nan_loss_steps")


def model_input_count(n_batch_args, num_model_inputs=None):
    """How many leading batch tensors feed the model when a loss_fn is given
    (the rest go to loss_fn after the model's outputs): all but the last
    (at least 1) unless ``num_model_inputs`` says (the JAX engine's rule,
    paddle_tpu/distributed/engine.py ``model_input_count``)."""
    if num_model_inputs is not None:
        if not 1 <= num_model_inputs <= n_batch_args:
            raise ValueError(f"num_model_inputs={num_model_inputs} out of range for "
                             f"{n_batch_args} batch args")
        return num_model_inputs
    return max(1, n_batch_args - 1)


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
    scalar loss) with ``optimizer``, on the model's device. With ``loss_fn``
    the model eats the first ``model_input_count(len(batch),
    num_model_inputs)`` batch tensors (all but the last by default) and
    ``loss_fn(*outputs, *rest)`` gives the loss, the JAX engine's
    convention.

    Every trainable parameter of the model must be one of the optimizer's;
    its state and its weight-decay decision go by the optimizer's name for
    it. ``hcg``: the topology (default: the one ``fleet.init`` set, if any);
    ``strategy``: a ``fleet.DistributedStrategy``, whose ``sharding`` turns
    ZeRO on; ``microbatches`` (also a mutable attribute) is K, ``zero_update``
    turns ZeRO on and ``fsdp`` FSDP (module docstring)."""

    def __init__(self, model, optimizer, loss_fn=None, hcg=None, strategy=None,
                 num_model_inputs=None, microbatches: int = 1, zero_update: bool = False,
                 fsdp: bool = False):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.num_model_inputs = num_model_inputs
        self.microbatches = max(1, int(microbatches))
        self.hcg = hcg if hcg is not None else get_hybrid_communicate_group()
        self.strategy = strategy
        dist_on = self.hcg is not None and self.hcg.distributed
        self.group = self.hcg.replica_group() if dist_on else None
        # every rank (checkpoints write from its first rank and agree over it)
        self.world_group = self.hcg.get_check_parallel_group() if dist_on else None
        deg = self.hcg.degrees if self.hcg is not None else {}
        self._mp, self._spd = deg.get("mp", 1), deg.get("sp", 1)
        self._pp, self._ep = deg.get("pp", 1), deg.get("ep", 1)
        self._axis_groups = {}
        for axis, get in (("pp", "get_pipe_parallel_group"), ("ep", "get_expert_parallel_group"),
                          ("mp", "get_model_parallel_group")):
            if deg.get(axis, 1) > 1:
                self._axis_groups[axis] = getattr(self.hcg, get)()
        self._mp_group = self._axis_groups.get("mp")
        self._sp_group = self.hcg.get_sep_parallel_group() if self._spd > 1 else None
        self._sp_impl = getattr(strategy, "sep_impl", "ulysses") or "ulysses"
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
        self._offload = bool(getattr(optimizer, "_offload", False))
        self._stage3 = any(getattr(p, "dist_attr", None) is not None
                           for p in self.params.values())
        if hasattr(model, "sync_in_backward"):
            model.sync_in_backward = False  # GroupShardedStage3: the engine reduces
        amp_on = strategy is not None and getattr(strategy, "amp", False)
        self._amp_cfg = strategy.amp_configs if amp_on else None
        self.zero_update = bool(zero_update)
        self._zero_opt = None          # the rank's flat [shard] f32 state slots
        self._zero_warned = False
        self._zero_reason = "unset"    # cached fallback reason (None = ZeRO can run)
        self._grad_residual = None     # the rank's [n] f32 error-feedback buffer
        self._layouts = {}             # chunk -> grad_comm.FlatLayout
        self._shapes = {nm: tuple(p.shape) for nm, p in self.params.items()}
        # the split parameters: {name: [(axis, (dim, blocks)), ...]} in
        # _SPLIT_AXES order (mp_layers.mp_slice)
        self._splits = {}
        if self._axis_groups:
            self._check_split_model(model, opt_names)
        self._full_shapes = {nm: self._logical_shape(nm, shape)
                             for nm, shape in self._shapes.items()}
        self.fsdp = bool(fsdp)
        self._fsdp_params = None       # the rank's per-bucket [shard] f32 parameters
        self._fsdp_opt = None          # per slot, the rank's per-bucket [shard] f32 state
        self._fsdp_warned = False
        self._fsdp_cache = None        # ((nrep, chunk), buckets, FsdpRows)
        self._fsdp_order = None        # bucket indices in the order the forward waits
        self._fsdp_live = None         # the running step's _BucketGather
        self._fsdp_hooked = False
        gen = getattr(model, "generator", None)
        self._seed = gen.initial_seed() if gen is not None else 0
        self._pending_h2d = None       # (h2d_ms, depth) staged by prefetch()
        self.prefetcher = None         # the last DevicePrefetcher prefetch() built
        # PADDLE_TPU_TELEMETRY_DIR attaches a JSONL sink; otherwise telemetry
        # stays None and the step pays one None check for it
        self.telemetry = StepTelemetry.from_env(
            device=self.device if self.params else None)
        if self.telemetry is not None and self.telemetry.flops_per_token is None:
            self.telemetry.flops_per_token = 6 * self._n_params()
        # PADDLE_TPU_METRICS_PORT / PADDLE_TPU_FLIGHT_DIR: one getenv each
        _obs_exporter.ensure_started_from_env()
        _obs_flight.ensure_from_env()
        # FLAGS_health_monitor / PADDLE_TPU_HEALTH_DIR; None (the default)
        # leaves the step as it was
        self._health = _obs_health.from_env_or_flags(self._shapes)
        # FLAGS_ckpt_dir / PADDLE_TPU_CKPT_DIR: checkpoints (distributed/elastic.py);
        # None costs one flag read here and one None check a step
        self._ckpt = _elastic.from_flags()

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def _n_params(self) -> int:
        return sum(math.prod(shape) for shape in self._shapes.values())

    # ---- tensor, sequence, pipeline and expert parallelism ----
    @property
    def _tp(self) -> bool:
        """mp, sp, pp or ep above one rank."""
        return self._mp > 1 or self._spd > 1 or self._pp > 1 or self._ep > 1

    def _refusal(self, what):
        """What item 9 (mp, sp) or item 11 (pp, ep) still refuses."""
        item = _ITEM11 if self._pp > 1 or self._ep > 1 else _ITEM9
        return NotImplementedError(
            f"{what} at mp_degree={self._mp}, sep_degree={self._spd}, "
            f"pp_degree={self._pp}, ep_degree={self._ep} ({item})")

    def _check_split_model(self, model, opt_names):
        """The model's split layers must be this topology's shards; the
        rules and clips that need a whole parameter's norm raise."""
        if self._mp > 1 and getattr(model, "mp_size", self._mp) != self._mp:
            raise ValueError(f"the model was built over {model.mp_size} model-parallel "
                             f"ranks, the topology has mp_degree={self._mp}: build the "
                             "model after fleet.init")
        by_id = {id(p): nm for nm, p in model.named_parameters()}
        for axis in _SPLIT_AXES:
            if axis not in self._axis_groups:
                continue
            degree = self.hcg.degrees[axis]
            splits = _mpl.sharded_parameters(model, axis)
            for pid, opt_nm in opt_names.items():
                if pid in by_id and by_id[pid] in splits and opt_nm in self.params:
                    split, size = splits[by_id[pid]]
                    if size != degree:
                        raise ValueError(f"{by_id[pid]} is split over {size} ranks, the "
                                         f"topology's {axis}_degree is {degree}: build the "
                                         "model after fleet.init")
                    self._splits.setdefault(opt_nm, []).append((axis, split))
        opt = self.optimizer
        if opt._rule in ("lamb", "lars"):
            raise self._refusal(f"{opt._rule} (its trust ratio needs whole parameters' "
                                "norms)")
        if isinstance(opt._grad_clip, ClipGradByNorm):
            raise self._refusal("ClipGradByNorm (it needs whole parameters' norms)")

    def _logical_shape(self, nm, shape):
        for axis, split in self._splits.get(nm, ()):
            shape = _mpl.logical_shape(shape, split, self.hcg.degrees[axis])
        return tuple(shape)

    def _mp_full(self, nm, t):
        """The logical tensor of parameter ``nm``'s shard ``t`` (gathered
        over the groups of the axes that split it, a collective); ``t`` for
        a whole parameter."""
        for axis, split in reversed(self._splits.get(nm, ())):
            parts = collective.all_gather(None, t.contiguous(), group=self._axis_groups[axis])
            t = _mpl.mp_gather(parts, split)
        return t

    def _mp_shard(self, nm, t):
        """This rank's shard of parameter ``nm``'s logical tensor ``t``."""
        for axis, split in self._splits.get(nm, ()):
            g = self._axis_groups[axis]
            t = _mpl.mp_slice(t, split, g.rank, g.nranks)
        return t.contiguous() if nm in self._splits else t

    def _split_mask(self, nm) -> int:
        """Bit i set when axis _SPLIT_AXES[i] splits parameter ``nm``."""
        return sum(1 << _SPLIT_AXES.index(a) for a, _ in self._splits.get(nm, ()))

    def _sum_split_squares(self, sq):
        """``sq`` [8]: the squares of the gradients split by each subset of
        _SPLIT_AXES (index = its bit mask); each entry summed over the
        groups of its axes, in place."""
        for i, axis in enumerate(_SPLIT_AXES):
            if axis in self._axis_groups:
                idx = [m for m in range(8) if m >> i & 1]
                part = sq[idx].contiguous()
                collective.all_reduce(part, group=self._axis_groups[axis])
                sq[idx] = part
        return sq

    def _clip(self, grads):
        """The optimizer's clip over {name: grad}; with split parameters the
        global norm sums each gradient's squares over the groups of the
        axes that split it and counts the replicated ones once."""
        clip = self.optimizer._grad_clip
        if not self._splits or not isinstance(clip, ClipGradByGlobalNorm):
            return opt_funct.clip_grads(grads, clip)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        parts = [[] for _ in range(8)]
        for n, g in grads.items():
            parts[self._split_mask(n)].append(_sq_norm(g))
        sq = self._sum_split_squares(torch.stack([sum(p, zero) for p in parts]))
        scale = clip.clip_norm / torch.clamp(torch.sqrt(sq.sum()), min=clip.clip_norm)
        return {n: (g * scale).to(g.dtype) for n, g in grads.items()}

    # ---- observability (observability/) ----
    def enable_telemetry(self, sink=None, path=None, flops_per_token=None,
                         peak_flops=None, collect_live_buffers=False) -> StepTelemetry:
        """Attach per-step telemetry (reference engine.py:251). The default
        flop model is parameter-only (6*N per token); pass flops_per_token
        from observability.transformer_flops_per_token for the bench's
        accounting with the attention term. collect_live_buffers=True adds
        the caching allocator's live count and bytes to each record."""
        if sink is None and path is not None:
            sink = JsonlSink(path)
        self.telemetry = StepTelemetry(
            sink=sink,
            flops_per_token=(flops_per_token if flops_per_token is not None
                             else 6 * self._n_params()),
            peak_flops=peak_flops, collect_live_buffers=collect_live_buffers,
            device=self.device)
        return self.telemetry

    def disable_telemetry(self) -> None:
        if self.telemetry is not None:
            self.telemetry.close()
        self.telemetry = None

    def enable_health(self, interval=None, spike_factor=None, sink=None, path=None,
                      ring_capacity: int = 64):
        """Attach the TrainingHealthMonitor (reference engine.py:279): grad,
        weight and update norms and non-finite attribution, computed on
        steps that are a multiple of ``interval`` and fetched as ONE packed
        f32 [4P] copy (observability/health.py)."""
        if sink is None and path is not None:
            sink = JsonlSink(path)
        self._health = _obs_health.TrainingHealthMonitor(
            self._shapes, interval=interval, spike_factor=spike_factor, sink=sink,
            ring_capacity=ring_capacity)
        return self._health

    def disable_health(self) -> None:
        if self._health is not None:
            self._health.close()
        self._health = None

    def _health_due(self, health) -> bool:
        return health is not None and health.wants(self._step_count)

    def _health_begin(self, health, grads, weights):
        """The health stats' first half on an interval step, else None:
        ``grads`` (pre-clip) and ``weights`` (before the update), {name:
        tensor} of every parameter (health.begin_stats)."""
        if not self._health_due(health):
            return None
        return health.begin_stats([grads[n] for n in health.names],
                                  [weights[n] for n in health.names])

    def _health_end(self, health, begun):
        """The packed [4P] stats of a replicated step, after its update."""
        if begun is None:
            return None
        return health.end_stats(begun, [self.params[n] for n in health.names])

    def _health_sum(self, part):
        """A rank's partial [4P] summed over the replicas (interval steps
        only, which every rank takes alike)."""
        if self.group is not None:
            collective.all_reduce(part, group=self.group)
        return part

    @staticmethod
    def _batch_stats(batch, lead_axes=0):
        """(samples, tokens) per call from the first batch tensor: the
        leading dim is the sample axis. Tokens are counted only for integer
        id batches ([b, s] LM inputs): dim 1 of a float feature matrix is
        features, not sequence."""
        if not batch:
            return None, None
        shape = tuple(batch[0].shape)[lead_axes:]
        if not shape:
            return None, None
        samples = int(shape[0])
        dt = batch[0].dtype
        tokens = None
        if len(shape) >= 2 and not (dt.is_floating_point or dt.is_complex
                                    or dt == torch.bool):
            tokens = samples * int(shape[1])
        return samples, tokens

    def _obs_step_tail(self, fr, mreg, rec, t0, t1, h2d_ms, loss_val,
                       hist="train.step_ms"):
        """The shared tail of step and run_steps (reference engine.py:702):
        the metrics histograms, and the step record into the flight
        recorder's ring, whose non-finite loss counts
        ``engine.nan_loss_steps`` and dumps ``train_loss``."""
        if mreg is not None:
            mreg.histogram(hist).observe((t1 - t0) * 1e3)
            if h2d_ms:
                mreg.histogram("train.h2d_ms").observe(h2d_ms)
        if fr is not None:
            if rec is None:
                rec = {"event": "train_step", "step": self._step_count,
                       "wall_time_s": t1 - t0, "loss": loss_val,
                       "h2d_ms": h2d_ms, "compiled": False}
            fr.record(rec)
            lv = rec.get("loss")
            if lv is not None and not math.isfinite(lv):
                # a diverged step: the dump's ring tail ends with this record
                _NAN_LOSS_STEPS.increase()
                fr.on_nan_inf("train_loss", {"step": self._step_count})

    # ---- checkpoints (distributed/elastic.py) ----
    def enable_checkpointing(self, dirname, interval=None, keep=None, async_save=None,
                             rollback_on_nonfinite=None, resume=False):
        """Attach a CheckpointManager on ``dirname`` (reference engine.py:305):
        a save every ``interval`` steps, the newest ``keep`` kept; unset
        arguments take the FLAGS_ckpt_* values. ``resume`` restores the
        newest valid checkpoint now and starts fresh when there is none."""
        if self._ckpt is not None:
            self._ckpt.close()
        self._ckpt = _elastic.CheckpointManager(
            dirname,
            interval=_flags.flag("ckpt_interval") if interval is None else interval,
            keep=_flags.flag("ckpt_keep") if keep is None else keep,
            async_save=_flags.flag("ckpt_async") if async_save is None else async_save,
            rollback_on_nonfinite=(_flags.flag("ckpt_rollback")
                                   if rollback_on_nonfinite is None
                                   else rollback_on_nonfinite))
        if resume:
            try:
                self._ckpt.restore(self)
            except FileNotFoundError:
                pass  # nothing saved yet: a fresh run
        return self._ckpt

    def disable_checkpointing(self) -> None:
        if self._ckpt is not None:
            self._ckpt.close()
        self._ckpt = None

    def _end_step(self):
        if self._ckpt is not None:
            self._ckpt.on_step(self, self._step_count, self.last_loss)
        return self.last_loss

    def _to_device(self, x):
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def _place(self, batch, timed):
        """``batch`` on the model's device, and the copies' issue wall ms
        when ``timed``."""
        t0 = time.perf_counter() if timed else None
        batch = [None if b is None else self._to_device(b) for b in batch]
        return batch, ((time.perf_counter() - t0) * 1e3 if timed else None)

    def _check_not_sharded(self):
        if self._fsdp_params is not None:
            raise ValueError("fsdp was turned off after the first fsdp step, but the "
                             "conversion to shards is one-way: call sync_to_model() "
                             "and build a new engine on the model")

    def _row_blocks(self):
        """(this rank's row block, the number of row blocks): dp x sharding."""
        if self.group is None:
            return 0, 1
        return self.hcg.batch_index()

    def _check_batch(self, batch, k=1):
        """The batch dim must split into k microbatches on every replica, and
        under sp the sequence dim into sp blocks."""
        nrep = self._row_blocks()[1]
        for b in batch:
            if b is None:
                continue
            if b.dim() and b.shape[0] % (k * nrep):
                raise ValueError(
                    f"batch dim {b.shape[0]} is not divisible by microbatches = {k} "
                    f"x replicas = {nrep}; pad or resize the batch")
            if self._spd > 1 and b.dim() >= 2 and b.shape[1] % self._spd:
                raise ValueError(
                    f"sequence dim {b.shape[1]} is not divisible by sep_degree = "
                    f"{self._spd}; pad or resize the batch")

    def _local_batch(self, batch):
        """This rank's part of the global batch: its replica's rows, and
        under sp its block of the sequence dim."""
        r, nrep = self._row_blocks()
        out = []
        for b in batch:
            if b is None:
                out.append(b)
                continue
            if b.dim() and nrep > 1:
                b = b.chunk(nrep)[r]
            if self._spd > 1 and b.dim() >= 2:
                b = b.chunk(self._spd, dim=1)[self._sp_group.rank]
            out.append(b)
        return out

    def step(self, *batch):
        """One optimizer step on ``batch`` (tensors or arrays, moved to the
        model's device; under a group, the global batch; a None, such as an
        optional input the model skips, passes through as None). Returns the loss
        (a detached 0-dim tensor; under a group, the mean over ranks)."""
        tele = self.telemetry
        fr = _obs_flight.get()
        mreg = _obs_metrics.active_registry()
        # a batch staged by prefetch() is on the card already: its copy
        # stats were taken when it was issued
        staged, self._pending_h2d = self._pending_h2d, None
        batch, h2d_ms = self._place(batch, tele is not None and staged is None)
        prefetch_depth = None
        if staged is not None:
            h2d_ms, prefetch_depth = staged
        k = self.microbatches
        dtype = _gc.comm_dtype()
        fsdp, zero = self._fsdp_on(), self._zero_on()
        if not fsdp:
            self._check_not_sharded()
        health = self._health
        if self._tp and (health is not None or dtype != "f32"):
            raise self._refusal("the health monitor" if health is not None
                                else f"the {dtype} payload")
        t0 = time.perf_counter()
        try:
            if self.group is None and k == 1 and dtype == "f32" and not (zero or fsdp):
                hbuf, comm_bytes = self._plain_step(batch, health), None
            else:
                hbuf, comm_bytes = self._comm_step(batch, k, dtype, zero, fsdp, health)
            # an honest wall time ends in a device read, only when read
            loss_val = (self.last_loss.item()
                        if tele is not None or fr is not None or mreg is not None
                        else None)
        except Exception as e:
            if fr is not None:
                fr.dump("train_step_exception",
                        {"step": self._step_count, "error": repr(e)})
            raise
        t1 = time.perf_counter()
        # the reference's grad_comm step (its _accum_step), by its own test
        accum = k > 1 or dtype != "f32" or zero or fsdp
        tr = _obs_tracer.get_tracer()
        if tr.enabled:
            args = {"step": self._step_count, "compiled": False}
            if accum:
                args.update(microbatches=k, grad_comm_dtype=dtype, zero_update=zero,
                            fsdp=fsdp)
            tr.record_complete("engine.accum_step" if accum else "engine.step", t0, t1,
                               args)
        if hbuf is not None:
            health.on_step(self._step_count, hbuf)
        rec = None
        if tele is not None:
            samples, tokens = self._batch_stats(batch)
            comm = {}
            if accum:
                fsdp_pf = self._fsdp_prefetch() if fsdp else 0
                comm = dict(
                    microbatches=k, grad_comm_dtype=dtype,
                    grad_comm_bytes=comm_bytes or 0,
                    extra=({"fsdp": True, "fsdp_prefetch": fsdp_pf,
                            "fsdp_window_bytes": _gc.fsdp_window_bytes(
                                self._fsdp_layout()[0], fsdp_pf)} if fsdp
                           else {"zero_update": True} if zero else None))
            rec = tele.record_step(
                step=self._step_count, wall_time=t1 - t0, samples=samples,
                tokens=tokens, loss=loss_val, h2d_ms=h2d_ms,
                prefetch_depth=prefetch_depth, **comm)
        if fr is not None or mreg is not None:
            self._obs_step_tail(fr, mreg, rec, t0, t1, h2d_ms, loss_val)
        return self._end_step()

    train_batch = step

    def run_steps(self, *batch, steps=None):
        """K optimizer steps in one call (reference engine.py:1716); returns
        their losses [K] (a detached f32 tensor).

        Either pass batch tensors with a leading [K] step axis, or one
        step's batch and ``steps=K`` to reuse it every step (moved to the
        card once). Each step is the K = 1 step whatever ``microbatches``
        says, with its own learning rate read from the optimizer; under a
        group, the f32 reduce. One telemetry record (``steps_fused``), one
        ``train.run_steps_ms`` observation, one ``engine.run_steps`` span
        and one checkpoint hook covering the K steps (``window=K``: an
        interval that falls inside them saves at their end). The health
        monitor does not ride it; use step() for monitored runs. ZeRO and
        FSDP raise, as in the reference."""
        if self._fsdp_on():
            raise ValueError(
                "run_steps (the fused K-step scan lane) does not compose "
                "with fsdp: the scan carries the replicated params/opt-"
                "state dicts while the fsdp path owns per-layer flat 1/N "
                "shards per data replica. Use step() (one dispatch per "
                "optimizer step, L bucket all-gathers + one reduce-"
                "scatter) or disable fsdp for this engine.")
        if self._zero_on():
            raise ValueError(
                "run_steps (the fused K-step scan lane) does not compose "
                "with zero_update: the scan carries the replicated "
                "opt-state dict while the ZeRO path owns flat 1/N shards "
                "per data replica. Use step() (one dispatch per optimizer "
                "step, one reduce-scatter + one all-gather) or disable "
                "zero_update for this engine.")
        self._check_not_sharded()
        fixed = steps is not None
        tele = self.telemetry
        fr = _obs_flight.get()
        mreg = _obs_metrics.active_registry()
        batch, h2d_ms = self._place(batch, tele is not None)
        k = int(steps) if fixed else int(batch[0].shape[0])
        if k < 1:
            raise ValueError(f"run_steps needs at least one step, got K={k}")
        each = [batch] * k if fixed else [[b[i] for b in batch] for i in range(k)]
        self._check_batch(each[0])
        step0 = self._step_count + 1
        t0 = time.perf_counter()
        try:
            losses = []
            for b in each:
                if self.group is None:
                    self._plain_step(b)
                else:
                    self._comm_step(b, 1, "f32", False)
                losses.append(self.last_loss)
            losses = torch.stack(losses)
            loss_val = (losses[-1].item()
                        if tele is not None or fr is not None or mreg is not None
                        else None)
        except Exception as e:
            if fr is not None:
                fr.dump("run_steps_exception",
                        {"step0": step0, "steps": k, "error": repr(e)})
            raise
        t1 = time.perf_counter()
        tr = _obs_tracer.get_tracer()
        if tr.enabled:
            tr.record_complete("engine.run_steps", t0, t1,
                               {"steps": k, "step0": step0, "compiled": False})
        self.last_loss = losses[-1]
        rec = None
        if tele is not None:
            samples, tokens = self._batch_stats(batch, lead_axes=0 if fixed else 1)
            rec = tele.record_step(
                step=self._step_count, wall_time=t1 - t0,
                samples=samples * k if samples else None,
                tokens=tokens * k if tokens else None,
                loss=loss_val, h2d_ms=h2d_ms, extra={"steps_fused": k})
        if fr is not None or mreg is not None:
            self._obs_step_tail(fr, mreg, rec, t0, t1, h2d_ms, loss_val,
                                hist="train.run_steps_ms")
        if self._ckpt is not None:
            self._ckpt.on_step(self, self._step_count, self.last_loss, window=k)
        return losses

    def prefetch(self, loader, depth: int = 2):
        """Iterate ``loader`` as batches on the card (reference
        engine.py:1940): the copies of the next ``depth`` batches are issued
        on a side stream while the current step runs::

            for batch in engine.prefetch(loader):
                engine.step(*batch)

        step() takes the staged tensors as they are (one copy a batch) and
        records the prefetcher's ``h2d_ms`` / ``prefetch_depth``. The
        loader may yield tensors or arrays, laid out as step(*batch) takes
        them."""
        pf = _pf.DevicePrefetcher(self.device, depth=depth)
        self.prefetcher = pf

        def batches():
            for batch in loader:
                if not isinstance(batch, (tuple, list)):
                    batch = (batch,)
                self._check_batch([None if b is None else torch.as_tensor(b) for b in batch],
                                  self.microbatches)
                yield batch

        def placed():
            for batch in pf.iterate(batches()):
                self._pending_h2d = (pf.last_h2d_ms, pf.last_depth)
                yield batch

        return placed()

    def _begin_step(self):
        opt = self.optimizer
        self._step_count += 1
        opt._step_count = self._step_count  # keep checkpoints consistent
        for p in self.params.values():
            p.grad = None
        return opt.get_lr()

    def _forward(self, batch):
        """The model's loss on ``batch`` (through ``loss_fn`` when given),
        under the strategy's amp when it has one, and under the trace flag
        (jit.py): the JAX engine traces the model, so host-side state such
        as a QATLinear's activation scale stays frozen here too. Under a
        replica group, inside ``batch_group_scope``: batch norm's statistics
        and the losses' valid-label means are the global batch's."""
        from ..jit import _tracing

        with contextlib.ExitStack() as stack:
            if self._sp_group is not None:
                stack.enter_context(_sp.sequence_parallel_scope(self._sp_group,
                                                                self._sp_impl))
            if self._amp_cfg is not None:
                from ..amp import amp_guard_from_configs

                stack.enter_context(amp_guard_from_configs(self._amp_cfg,
                                                           force_bf16=True))
            stack.enter_context(_tracing())
            if self.group is not None:
                stack.enter_context(F.batch_group_scope(self.group))
            if self.loss_fn is None:
                return self.model(*batch)
            n_in = model_input_count(len(batch), self.num_model_inputs)
            out = self.model(*batch[:n_in])
            outs = out if isinstance(out, (tuple, list)) else (out,)
            loss = self.loss_fn(*outs, *batch[n_in:])
            return loss[0] if isinstance(loss, (tuple, list)) else loss

    def _plain_step(self, batch, health=None):
        """Sets last_loss; returns the packed health stats on an interval
        step of ``health``, else None."""
        opt = self.optimizer
        lr_val = self._begin_step()
        loss = self._forward(batch)
        loss.backward()
        with torch.no_grad():
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in self.params.items()}
            hb = self._health_begin(health, grads, self.params)
            grads = self._clip(grads)
            opt._apply(self.params, grads, lr_val, self._step_count)
            hbuf = self._health_end(health, hb)
        self.last_loss = loss.detach()
        return hbuf

    # ---- the grad_comm step ----
    def _flat_layout(self, chunk):
        lay = self._layouts.get(chunk)
        if lay is None:
            lay = self._layouts[chunk] = _gc.FlatLayout(
                self._shapes, _gc.replica_count(self.group), chunk)
        return lay

    def _n_grad_elems(self) -> int:
        return self._flat_layout(_gc.chunk_size()).n

    def _views(self, buf, layout):
        return {nm: buf[layout.offsets[nm]:layout.offsets[nm] + math.prod(shape)].view(shape)
                for nm, shape in self._shapes.items()}

    def _comm_step(self, batch, k, dtype, zero, fsdp=False, health=None):
        """Sets last_loss; returns (the packed health stats on an interval
        step of ``health``, else None; the bytes handed the collectives)."""
        group = self.group
        nrep = _gc.replica_count(group)
        self._check_batch(batch, k)
        batch = self._local_batch(batch)
        chunk = _gc.chunk_size()
        use_res = dtype != "f32" and _gc.error_feedback()
        layout = self._flat_layout(chunk)
        opt = self.optimizer
        lr_val = self._begin_step()
        n = layout.n
        if fsdp:
            hbuf = self._fsdp_step(batch, k, layout, dtype, chunk, use_res, lr_val, health)
            comm_bytes = 0
            if group is not None:
                rs_b, ag_b, _ = _gc.fsdp_payload_bytes(
                    [b["shard"] for b in self._fsdp_layout()[0]], nrep, dtype, chunk)
                _gc.RS_BYTES.increase(rs_b)
                _gc.AG_BYTES.increase(ag_b)
                comm_bytes = rs_b + ag_b
            self._count_step(k, dtype, comm_bytes)
            return hbuf, comm_bytes
        # ZeRO's buffer also takes the all-gather of the new weights, one
        # [shard + 1] row a rank, once the reduce-scatter has consumed it
        buf, loss = self._accumulate(batch, k, layout,
                                     layout.n_pad + layout.nrep if zero else n + 1)
        with torch.no_grad():
            if k > 1:
                buf[:n].div_(k)
            res = self._ensure_residual(n) if use_res else None
            if zero:
                hbuf = self._zero_step(buf, layout, loss, dtype, chunk, res, lr_val,
                                       health)
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
                hb = self._health_begin(health, grads, self.params)
                clipped = self._clip(grads)
                opt._apply(self.params, clipped, lr_val, self._step_count)
                hbuf = self._health_end(health, hb)
                for nm, p in self.params.items():
                    p.grad = grads[nm]
                comm_bytes = (0 if group is None else _gc.payload_bytes(n, dtype, chunk))
        self._count_step(k, dtype, comm_bytes)
        return hbuf, comm_bytes

    @staticmethod
    def _count_step(k, dtype, comm_bytes):
        _gc.STEPS.increase()
        _gc.MICROBATCHES.increase(k)
        _gc.BYTES_MOVED.increase(comm_bytes)
        if dtype != "f32":
            _gc.LOWP_STEPS.increase()

    def _seed_dropout(self, i):
        """Over more than one rank: reseed the model's dropout generator for
        microbatch i from (seed, rank, step, i)."""
        gen = getattr(self.model, "generator", None)
        if gen is not None and self.group is not None and self.group.nranks > 1:
            gen.manual_seed(_fold_seed(self._seed, self.group.rank,
                                       self._step_count, i))

    def _accumulate(self, batch, k, layout, size, after_backward=None):
        """Forward and backward of each of the k microbatches of ``batch``,
        their f32 gradients summed into a new flat f32 buffer of ``size``
        elements (``layout``'s offsets, zeros past n). Returns the buffer
        and the mean loss, and leaves every ``grad`` None. ``after_backward``
        is called after the last backward, before its gradients are summed
        (FSDP releases the gathered parameters there).

        The buffer is allocated after the first backward, when the
        activations are freed, and each gradient is copied into it and
        released at once, so the step's peak memory is the plain step's.
        An f32 parameter's ``grad`` then becomes its view of the buffer, and
        autograd accumulates the later microbatches into it in place; a
        gradient of another dtype is added after each backward."""
        parts = [b.chunk(k) if b is not None and b.dim() else [b] * k for b in batch]
        buf = views = None
        attached, losses = set(), []
        for i in range(k):
            self._seed_dropout(i)
            loss = self._forward([p[i] for p in parts])
            loss.backward()
            losses.append(loss.detach())
            del loss
            if i + 1 == k and after_backward is not None:
                after_backward()
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
        elif opt._rule not in opt_funct.ELEMENTWISE_RULES:
            reason = (f"optimizer rule {opt._rule!r} is not uniform-elementwise "
                      "(needs per-parameter norms)")
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
        """True when this step runs the ZeRO update (requested, possible,
        and not superseded by FSDP); a request that cannot run warns once."""
        if self._fsdp_on() or not self._zero_requested():
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
            slots.append(_to_host(s, s.is_cuda) if self._offload else s)
        self._zero_opt = tuple(slots)
        states.clear()  # the flat shards are the state now
        return self._zero_opt

    def _zero_step(self, buf, layout, loss, dtype, chunk, res, lr_val, health=None):
        """Returns the packed health stats on an interval step, else None."""
        group, opt = self.group, self.optimizer
        lo = self._rank() * layout.shard
        g, loss_part = _gc.zero_scatter(buf, layout, loss, group, dtype, chunk, res)
        p_shard = torch.zeros(layout.shard, dtype=torch.float32, device=self.device)
        spans = []   # (name, shard start, shard stop) of the rank's pieces
        for nm, a, b in layout.pieces(lo, lo + layout.shard):
            o = layout.offsets[nm] - lo
            p_shard[o + a:o + b] = self.params[nm].detach().reshape(-1)[a:b]
            spans.append((nm, o + a, o + b))
        hb = None
        if self._health_due(health):
            ordinal = {nm: i for i, nm in enumerate(layout.names)}
            hb = health.begin_stats([g[a:b] for _, a, b in spans],
                                    [p_shard[a:b] for _, a, b in spans],
                                    [ordinal[nm] for nm, _, _ in spans])
        split = None
        if self._splits:   # the shard's pieces of split parameters, by their axes
            split = ([(a, b, self._split_mask(nm)) for nm, a, b in spans],
                     self._sum_split_squares)
        _gc.clip_shard(g, opt._grad_clip, group, split)
        update = opt_funct.make_flat_update(opt, next(iter(self.params)),
                                            block=_gc.BLOCK)
        slots = self._ensure_zero_opt(layout)
        work = tuple(t.to(self.device, non_blocking=True) for t in slots)
        update(p_shard, g, work, lr_val, self._step_count)
        hbuf = None if hb is None else self._health_sum(
            health.end_stats(hb, [p_shard[a:b] for _, a, b in spans]))
        if self._offload:   # back to the host shards
            for t, w in zip(slots, work):
                t.copy_(w)
        del g, work
        rows, self.last_loss = _gc.zero_gather(p_shard, loss_part, group, layout.nrep,
                                               dtype != "int8", out=buf)
        del p_shard
        for i in range(layout.nrep):
            base = i * layout.shard
            for nm, a, b in layout.pieces(base, base + layout.shard):
                o = layout.offsets[nm] - base
                self.params[nm].detach().view(-1)[a:b].copy_(rows[i, o + a:o + b])
        return hbuf

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

    def state_dict(self):
        """{"model": the model's state dict, "optimizer": the optimizer's
        (``Optimizer.state_dict`` keys)}; under ZeRO the optimizer state,
        under FSDP also the parameters, are gathered from every rank's
        shards first, and at mp, pp or ep > 1 every split parameter and its
        state into the logical tensor, a one-rank model's (a collective:
        every rank must call it)."""
        sharded = (self._fsdp_params is not None or self._zero_opt is not None
                   or bool(self._splits))
        states = self._full_opt() if sharded else None
        model_sd = self.model.state_dict(keep_vars=True)
        if self._fsdp_params is not None or self._splits:
            full = self._full_params()
            by_id = {id(p): nm for nm, p in self.params.items()}
            model_sd = {key: full[by_id[id(v)]] if id(v) in by_id else v
                        for key, v in model_sd.items()}
        return {"model": {key: v.detach() for key, v in model_sd.items()},
                "optimizer": self.optimizer.state_dict(states=states)}

    def set_state_dict(self, state):
        """Install a ``state_dict()`` (logical tensors, from any mp, pp or ep
        degree and sharding): the rank's shards are sliced out, and ZeRO and FSDP
        re-shard at the next step; the model's buffers (batch norm's running
        statistics) are copied in. Every rank calls it."""
        model_sd, opt_sd = state["model"], state.get("optimizer", {})
        by_id = {id(p): nm for nm, p in self.params.items()}
        params = {by_id[id(p)]: model_sd[key]
                  for key, p in self.model.named_parameters() if id(p) in by_id}
        opt = {}
        for i, nm in enumerate(self.optimizer._param_names):
            slots = []
            while f"param{i}_state{len(slots)}" in opt_sd:
                slots.append(torch.as_tensor(opt_sd[f"param{i}_state{len(slots)}"]))
            if slots and nm in self.params:
                opt[nm] = tuple(slots)
        step = int(opt_sd.get("_step_count", 0))
        self._load_state(params, opt, step, step)
        with torch.no_grad():
            for key, buf in self.model.named_buffers():
                if key in model_sd:
                    buf.copy_(torch.as_tensor(model_sd[key]))

    def sync_to_model(self):
        """Write the engine's parameters back into the model (reference
        engine.py:1967): under FSDP, gathered from every rank's shards into
        new full storage (a collective: every rank must call it); otherwise
        the model already holds them. The shards stay the state: the next
        FSDP step gathers from them again. Returns the model."""
        if self._fsdp_params is not None:
            for nm, t in self._full_params().items():
                self.params[nm].data = t
        return self.model

    # ---- the full state (state_dict, sync_to_model, checkpoints) ----
    def _visit_params(self, visit):
        """``visit(name, tensor)`` for every parameter, in its shape. Under
        FSDP ``tensor`` is an f32 view of its bucket's gathered vector: one
        bucket is gathered at a time and freed after its visits (a
        collective: every rank calls it)."""
        if self._fsdp_params is None:
            for nm, p in self.params.items():
                visit(nm, self._mp_full(nm, p.detach()))
            return
        for bi, shard in enumerate(self._fsdp_params):
            self._visit_bucket(bi, shard, visit)

    def _visit_opt(self, visit):
        """``visit(name, slot, tensor)`` for every f32 optimizer slot, in its
        parameter's shape, slot by slot; zeros where the optimizer holds no
        state yet. Under FSDP one bucket, under ZeRO one slot's flat vector,
        is gathered at a time and freed after its visits (a collective)."""
        if self._fsdp_opt is not None:
            for j, col in enumerate(self._fsdp_opt):
                for bi, shard in enumerate(col):
                    self._visit_bucket(bi, shard, lambda nm, v: visit(nm, j, v))
            return
        if self._zero_opt is not None:
            layout = self._flat_layout(_gc.chunk_size())
            for j, s in enumerate(self._zero_opt):
                full = torch.empty(layout.n_pad, dtype=torch.float32, device=self.device)
                collective.all_gather_into(full, s.to(self.device), group=self.group)
                for nm in layout.names:
                    off, shape = layout.offsets[nm], layout.shapes[nm]
                    visit(nm, j, self._mp_full(nm, full[off:off + math.prod(shape)].view(
                        shape)))
                del full
            return
        states = self.optimizer._states
        for j in range(self._zero_n_slots()):
            for nm in self.params:
                visit(nm, j, self._mp_full(nm, states[nm][j] if nm in states else torch.zeros(
                    self._shapes[nm], dtype=torch.float32, device=self.device)))

    def _full_params(self):
        """{name: a copy of the parameter in its dtype} (a collective under
        FSDP)."""
        out = {}
        self._visit_params(lambda nm, t: out.__setitem__(
            nm, t.to(self.params[nm].dtype, copy=True)))
        return out

    def _full_opt(self):
        """{name: (slot, ...)}, copies in f32 (a collective under ZeRO and
        FSDP; zeros where the optimizer holds no state yet)."""
        out = {nm: [] for nm in self.params}
        self._visit_opt(lambda nm, _j, t: out[nm].append(t.clone()))
        return {nm: tuple(slots) for nm, slots in out.items()}

    def _load_state(self, params, opt, step, opt_step):
        """Install full parameters and optimizer state ({name: tensor} and
        {name: (slot, ...)}, the port's layout, logical tensors; a restored
        checkpoint): the rank's mp shards are sliced out, the ZeRO and FSDP
        shards are dropped, and the next sharded step re-encodes them from
        the model and the optimizer, bit for bit."""
        self._fsdp_params = self._fsdp_opt = self._zero_opt = None
        for nm, slots in opt.items():
            if any(tuple(s.shape) != self._full_shapes[nm] for s in slots):
                raise ValueError(f"{nm}: checkpoint optimizer state shapes "
                                 f"{[tuple(s.shape) for s in slots]} != "
                                 f"{self._full_shapes[nm]}")
        opt = {nm: tuple(self._mp_shard(nm, s) for s in slots) for nm, slots in opt.items()}
        with torch.no_grad():
            for nm, p in self.params.items():
                t = params[nm]
                if tuple(t.shape) != self._full_shapes[nm]:
                    raise ValueError(f"{nm}: checkpoint shape {tuple(t.shape)} != the "
                                     f"model's {self._full_shapes[nm]}")
                t = self._mp_shard(nm, t)
                if p.numel() == t.numel():
                    p.copy_(t)
                else:   # FSDP released its storage
                    p.data = t.to(device=p.device, dtype=p.dtype).clone()
        self.optimizer._states = {
            nm: tuple(s.to(device=self.device, dtype=torch.float32).clone()
                      for s in slots) for nm, slots in opt.items()}
        self._step_count = int(step)
        self.optimizer._step_count = int(opt_step)
        self.last_loss = None

    # ---- FSDP: fully sharded parameters ----
    def _fsdp_requested(self) -> bool:
        return bool(self.fsdp or _flags.flag("fsdp")
                    or (self._stage3 and self.hcg is not None
                        and self.hcg.degrees["sharding"] > 1))

    def _fsdp_on(self) -> bool:
        """True when this step runs FSDP (requested and possible: ZeRO's
        gate); a request that cannot run warns once and runs the replicated
        update."""
        if not self._fsdp_requested():
            return False
        if self._tp:
            raise self._refusal("FSDP")
        if self._offload:
            raise NotImplementedError("FSDP with an offloaded optimizer state is not "
                                      "ported (ROADMAP.md Queue 1 item 3)")
        reason = self._zero_fallback_reason()
        if reason is None:
            return True
        if not self._fsdp_warned:
            warnings.warn("fsdp requested but falling back to the "
                          f"replicated update: {reason}")
            self._fsdp_warned = True
        return False

    def _fsdp_layout(self):
        """(buckets, grad_comm.FsdpRows) for this group and chunk (cached):
        the model's ``fsdp_layer_key`` or grad_comm.default_layer_key."""
        nrep, chunk = _gc.replica_count(self.group), _gc.chunk_size()
        if self._fsdp_cache is None or self._fsdp_cache[0] != (nrep, chunk):
            buckets = _gc.fsdp_buckets(self._shapes, nrep, chunk,
                                       layer_key=getattr(self.model, "fsdp_layer_key", None))
            self._fsdp_cache = ((nrep, chunk), buckets, _gc.FsdpRows(buckets, nrep))
        return self._fsdp_cache[1], self._fsdp_cache[2]

    def _fsdp_prefetch(self) -> int:
        return _gc.fsdp_prefetch_depth(self._fsdp_layout()[0],
                                       int(_flags.flag("fsdp_prefetch")))

    def fsdp_memory_model(self):
        """Parameter and optimizer-state bytes a rank holds, replicated
        against FSDP's shards, and the step's collective bytes (the JAX
        engine's ``fsdp_memory_model``)."""
        buckets, _ = self._fsdp_layout()
        nrep = _gc.replica_count(self.group)
        slots = self._zero_n_slots()
        n = self._n_grad_elems()
        shard_elems = [b["shard"] for b in buckets]
        rs_b, ag_b, per_layer = _gc.fsdp_payload_bytes(
            shard_elems, nrep, _gc.comm_dtype(), _gc.chunk_size())
        depth = self._fsdp_prefetch()
        return {
            "prefetch": depth,
            "window_bytes": _gc.fsdp_window_bytes(buckets, depth),
            "window_bytes_jit": _gc.fsdp_window_bytes(buckets, 0),
            "ahead_bytes": _gc.fsdp_prefetch_ahead_bytes(buckets, depth),
            "replicas": nrep,
            "n_grad_elems": n,
            "opt_slots": slots,
            "buckets": [{"key": b["key"], "n": b["n"], "pad": b["pad"],
                         "shard": b["shard"], "ag_bytes": ab}
                        for b, ab in zip(buckets, per_layer)],
            "replicated_param_bytes": n * 4,
            "sharded_param_bytes_per_device": sum(shard_elems) * 4,
            "replicated_opt_bytes": slots * n * 4,
            "sharded_opt_bytes_per_device": slots * sum(shard_elems) * 4,
            "rs_bytes": rs_b,
            "ag_bytes": ag_b,
        }

    def _shard_of(self, b, values):
        """The rank's [shard] f32 slice of bucket ``b``'s padded vector of
        ``values`` ({name: tensor}, each in its parameter's shape; zeros for
        a name it lacks)."""
        out = torch.zeros(b["shard"], dtype=torch.float32, device=self.device)
        lo, off = self._rank() * b["shard"], 0
        for nm in b["names"]:
            size = math.prod(self._shapes[nm])
            a, e = max(lo, off), min(lo + b["shard"], off + size)
            if a < e and nm in values:
                out[a - lo:e - lo] = values[nm].reshape(-1)[a - off:e - off]
            off += size
        return out

    def _ensure_fsdp_state(self):
        """The rank's per-bucket parameter and state shards, built at the first
        FSDP step (one way; reference engine.py:1272) from the parameters
        and the optimizer's state (ZeRO's shards gathered first), whose full
        storage is then released."""
        buckets, _ = self._fsdp_layout()
        if self._fsdp_params is not None:
            if [f.numel() for f in self._fsdp_params] != [b["shard"] for b in buckets]:
                raise ValueError("the sharded parameters were built for another bucket "
                                 "layout: FLAGS_grad_comm_chunk or the group changed "
                                 "after the first fsdp step; rebuild the engine")
            return
        with torch.no_grad():
            params = {nm: p.detach() for nm, p in self.params.items()}
            self._fsdp_params = tuple(self._shard_of(b, params) for b in buckets)
            del params
            self._release_params()
            # ZeRO's shards gathered; no zeros made for a state not built yet
            states = (dict(self.optimizer._states) if self._zero_opt is None
                      else self._full_opt())
            self._fsdp_opt = tuple(
                tuple(self._shard_of(b, {nm: states[nm][j] for nm in b["names"]
                                         if nm in states}) for b in buckets)
                for j in range(self._zero_n_slots()))
        del states
        self._zero_opt = None
        self.optimizer._states.clear()

    def _release_params(self):
        for p in self.params.values():
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    def _gather_bucket(self, bi, shard):
        b = self._fsdp_layout()[0][bi]
        full = torch.empty(b["pad"], dtype=torch.float32, device=self.device)
        collective.all_gather_into(full, shard, group=self.group)
        return full

    def _visit_bucket(self, bi, shard, visit):
        """``visit(name, view)`` for each parameter of bucket ``bi``, a view
        of the bucket gathered from ``shard``; the gathered buffer is freed
        when this returns."""
        full, off = self._gather_bucket(bi, shard), 0
        for nm in self._fsdp_layout()[0][bi]["names"]:
            size = math.prod(self._shapes[nm])
            visit(nm, full[off:off + size].view(self._shapes[nm]))
            off += size

    def _hook_modules(self):
        """Forward pre-hooks on every module that owns a parameter: each waits
        for its parameters' buckets while an FSDP step runs."""
        if self._fsdp_hooked:
            return
        owner = {id(p): nm.rsplit(".", 1)[0] if "." in nm else ""
                 for nm, p in self.model.named_parameters()}
        bucket_of = {}
        for bi, b in enumerate(self._fsdp_layout()[0]):
            for nm in b["names"]:
                bucket_of[nm] = bi
        by_module = {}
        for nm, p in self.params.items():
            by_module.setdefault(owner[id(p)], set()).add(bucket_of[nm])
        ref = weakref.ref(self)
        for mod_name, bis in by_module.items():
            bis = sorted(bis)

            def hook(_module, _inputs, bis=bis):
                eng = ref()
                if eng is not None and eng._fsdp_live is not None:
                    for bi in bis:
                        eng._fsdp_live.wait(bi)

            self.model.get_submodule(mod_name).register_forward_pre_hook(hook)
        self._fsdp_hooked = True

    def _fsdp_step(self, batch, k, layout, dtype, chunk, use_res, lr_val, health=None):
        """One FSDP step (module docstring); sets last_loss. Returns the
        packed health stats on an interval step, else None."""
        opt = self.optimizer
        n = layout.n
        self._ensure_fsdp_state()
        self._hook_modules()
        buckets, rows = self._fsdp_layout()
        live = _BucketGather(self, buckets, self._fsdp_order, self._fsdp_prefetch())
        self._fsdp_live = live
        def release():
            self._fsdp_live = None
            live.close()
            self._release_params()

        try:
            # the gathered parameters go after the last backward, before the
            # flat gradient buffer is allocated
            buf, loss = self._accumulate(batch, k, layout, n, after_backward=release)
            if self._fsdp_order is None:
                self._fsdp_order = list(live.seen)
        finally:
            release()
        with torch.no_grad():
            if k > 1:
                buf.div_(k)
            res = self._ensure_residual(n) if use_res else None
            payload = _gc.fsdp_pack(buf, rows, loss, dtype, chunk, res)
            del buf
            g, self.last_loss = _gc.fsdp_scatter(payload, rows, self.group, dtype, chunk)
            del payload
            hb = None
            if self._health_due(health):
                spans = self._fsdp_spans(buckets)
                hb = health.begin_stats(
                    [g[rows.soffs[bi] + a:rows.soffs[bi] + b] for _, bi, a, b in spans],
                    [self._fsdp_params[bi][a:b] for _, bi, a, b in spans],
                    [o for o, _, _, _ in spans])
            _gc.clip_shard(g, opt._grad_clip, self.group)
            update = opt_funct.make_flat_update(opt, next(iter(self.params)),
                                                block=_gc.BLOCK)
            for bi, p_shard in enumerate(self._fsdp_params):
                sl = slice(rows.soffs[bi], rows.soffs[bi + 1])
                update(p_shard, g[sl], tuple(col[bi] for col in self._fsdp_opt),
                       lr_val, self._step_count)
            if hb is None:
                return None
            return self._health_sum(health.end_stats(
                hb, [self._fsdp_params[bi][a:b] for _, bi, a, b in spans]))

    def _fsdp_spans(self, buckets):
        """(ordinal in sorted-name order, bucket, start, stop) of every piece
        of a parameter in the rank's bucket shards (start, stop in the
        bucket's shard)."""
        ordinal = {nm: i for i, nm in enumerate(sorted(self._shapes))}
        r, out = self._rank(), []
        for bi, b in enumerate(buckets):
            lo, off = r * b["shard"], 0
            for nm in b["names"]:
                size = math.prod(self._shapes[nm])
                a, e = max(lo, off), min(lo + b["shard"], off + size)
                if a < e:
                    out.append((ordinal[nm], bi, a - lo, e - lo))
                off += size
        return out


class _BucketGather:
    """The gathers of one FSDP step. ``order`` None (the first step): every
    bucket is gathered before the forward, and ``seen`` records the order in
    which the modules wait for them. Otherwise the buckets no module waited
    for then are gathered first, and every other one when a module waits
    for it, with up to ``depth`` gathers in flight along ``order`` (depth 0
    and 1: just in time). A parameter's storage is its view of the bucket's
    gathered [pad] buffer from the wait on, so a read before its bucket's
    wait fails instead of reading an unfinished gather."""

    def __init__(self, engine, buckets, order, depth):
        self.engine, self.buckets = engine, buckets
        self.order, self.depth = order, depth
        self.pos = {bi: i for i, bi in enumerate(order or ())}
        self.full = [None] * len(buckets)
        self.work = [None] * len(buckets)
        self.bound = [False] * len(buckets)
        self.seen = []
        first = [bi for bi in range(len(buckets)) if bi not in self.pos]
        for bi in first:
            self.issue(bi)
        for bi in first:
            self._finish(bi)
        if order is not None and depth >= 2:
            for bi in order[:depth]:
                self.issue(bi)

    def issue(self, bi):
        if self.full[bi] is not None:
            return
        eng = self.engine
        full = torch.empty(self.buckets[bi]["pad"], dtype=torch.float32, device=eng.device)
        self.work[bi] = collective.all_gather_into(full, eng._fsdp_params[bi],
                                                   group=eng.group, sync_op=False)
        self.full[bi] = full

    def _finish(self, bi):
        if self.bound[bi]:
            return
        self.issue(bi)
        if self.work[bi] is not None:
            self.work[bi].wait()
            self.work[bi] = None
        eng, full, off = self.engine, self.full[bi], 0
        for nm in self.buckets[bi]["names"]:
            p = eng.params[nm]
            size = math.prod(eng._shapes[nm])
            v = full[off:off + size].view(eng._shapes[nm])
            p.data = v if p.dtype == torch.float32 else v.to(p.dtype)
            off += size
        self.bound[bi] = True

    def wait(self, bi):
        """A module's forward needs bucket ``bi``: issue the gathers of the
        window ahead of it, then wait for its own."""
        if bi not in self.seen:
            self.seen.append(bi)
        i = self.pos.get(bi)
        if i is not None and self.depth >= 2:
            for nxt in self.order[i + 1:i + self.depth]:
                self.issue(nxt)
        self._finish(bi)

    def close(self):
        """Wait for every gather still in flight (a step never leaves one
        behind) and drop the gathered buffers; a second call does nothing."""
        for w in self.work or ():
            if w is not None:
                w.wait()
        self.full = self.work = None
