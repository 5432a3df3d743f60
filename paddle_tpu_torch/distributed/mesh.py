"""Topology of the port (counterpart of paddle_tpu/distributed/mesh.py's
``HybridCommunicateGroup``).

The ranks of the process group form the reference's grid in its axis order
(pp, dp, sharding, sp, ep, mp; row-major), so a rank's coordinates are
``rank = ((((pp_i * dp + dp_i) * sharding + sh_i) * sp + sp_i) * ep + ep_i)
* mp + mp_i``. Each rank holds its pipeline stage's layers
(distributed/pipeline_schedule.py, models/gpt.py's
``GPTForPretrainingPipe``), its 1/ep of the experts
(meta_parallel/moe.py), its own 1/mp shard of the tensor-parallel layers
(meta_parallel/mp_layers.py) and its own 1/sp of the sequence
(meta_parallel/sequence_parallel.py); collectives run over the groups
built here, one process group a line of each axis above one rank (every
rank joins every ``new_group`` call, as torch.distributed asks). The data
replicas are the ranks that hold the same shards: ``dp x sharding x sp``,
the ranks with this rank's pp, ep and mp coordinates (``replica_group``).
Without a process group the topology is one rank and its groups carry no
process group: collectives over them are the identity.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch.distributed as dist

AXES_ORDER = ("pp", "dp", "sharding", "sp", "ep", "mp")
# the lines the port builds a group for: one axis each, and the replicas
_LINES = {"pp": ("pp",), "dp": ("dp",), "sharding": ("sharding",), "sp": ("sp",),
          "ep": ("ep",), "mp": ("mp",), "replica": ("dp", "sharding", "sp")}


class CommGroup:
    """A communicator: the global ranks it holds and their torch process
    group (None without torch.distributed; the world group's handle when
    the group is every rank)."""

    def __init__(self, axis: Optional[str], ranks: List[int], process_group=None,
                 id: int = 0):
        self.axis = axis
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.world_size = self.nranks
        self.process_group = process_group
        self.id = id

    @property
    def rank(self):
        g = dist.get_rank() if dist.is_initialized() else 0
        return self.ranks.index(g) if g in self.ranks else -1

    def get_group_rank(self, global_rank):
        return self.ranks.index(global_rank) if global_rank in self.ranks else -1

    def __repr__(self):
        return f"CommGroup(axis={self.axis}, ranks={self.ranks})"


class HybridCommunicateGroup:
    """Topology facade with the reference's accessor surface. ``dp_degree``
    -1 fills the world: world size / (pp x sharding x sp x ep x mp)."""

    def __init__(self, dp_degree=-1, mp_degree=1, pp_degree=1, sharding_degree=1,
                 sp_degree=1, ep_degree=1):
        self.distributed = dist.is_initialized()
        world = dist.get_world_size() if self.distributed else 1
        self.global_rank = dist.get_rank() if self.distributed else 0
        deg = {a: max(1, int(d or 1)) for a, d in (
            ("pp", pp_degree), ("sharding", sharding_degree), ("sp", sp_degree),
            ("ep", ep_degree), ("mp", mp_degree))}
        others = math.prod(deg.values())
        names = " x ".join(f"{a}_degree={d}"
                           for a, d in deg.items() if d > 1 or a in ("sharding", "sp", "mp"))
        if dp_degree is None or dp_degree <= 0:
            if world % others:
                raise ValueError(f"{names} does not divide the world of {world} ranks")
            dp_degree = world // others
        dp_degree = int(dp_degree)
        if dp_degree * others != world:
            raise ValueError(f"dp_degree={dp_degree} x {names} must equal the world "
                             f"of {world} ranks")
        self.degrees = {"pp": deg["pp"], "dp": dp_degree, "sharding": deg["sharding"],
                        "sp": deg["sp"], "ep": deg["ep"], "mp": deg["mp"]}
        self.nranks = world
        world_pg = dist.group.WORLD if self.distributed else None
        # row-major coordinates of this rank in AXES_ORDER
        shape = tuple(self.degrees[a] for a in AXES_ORDER)
        self._coord = dict(zip(AXES_ORDER, _unravel(self.global_rank, shape)))
        self._groups = {"data": CommGroup("data", range(world), world_pg)}
        for axis, axes in _LINES.items():
            dims = tuple(AXES_ORDER.index(a) for a in axes)
            size = math.prod(shape[d] for d in dims)
            if size == world:
                self._groups[axis] = CommGroup(axis, range(world), world_pg)
            elif size == 1:
                self._groups[axis] = CommGroup(axis, [self.global_rank])
            else:  # every rank joins the creation of every line's group
                mine = None
                for ranks in _lines(shape, dims):
                    pg = dist.new_group(ranks)
                    if self.global_rank in ranks:
                        mine = CommGroup(axis, ranks, pg)
                self._groups[axis] = mine
        c = self._coord
        self._dp_rank, self._sharding_rank, self._sp_rank = c["dp"], c["sharding"], c["sp"]
        self._mp_rank, self._pp_rank, self._ep_rank = c["mp"], c["pp"], c["ep"]

    # ---- reference accessor surface ----
    def get_parallel_mode(self):
        if self.degrees["pp"] > 1:
            return "pipeline"
        if self.degrees["sharding"] > 1:
            return "sharding_parallel"
        if self.degrees["mp"] > 1:
            return "tensor_parallel"
        return "data_parallel"

    def topology(self):
        return self.degrees

    def get_global_rank(self):
        return self.global_rank

    def get_data_parallel_world_size(self):
        return self.degrees["dp"]

    def get_data_parallel_rank(self):
        return self._dp_rank

    def get_data_parallel_group(self):
        return self._groups["dp"]

    def get_sharding_parallel_world_size(self):
        return self.degrees["sharding"]

    def get_sharding_parallel_rank(self):
        return self._sharding_rank

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_model_parallel_world_size(self):
        return self.degrees["mp"]

    def get_model_parallel_rank(self):
        return self._mp_rank

    def get_model_parallel_group(self):
        return self._groups["mp"]

    def get_pipe_parallel_world_size(self):
        return self.degrees["pp"]

    def get_stage_id(self):
        return self._pp_rank

    def get_pipe_parallel_group(self):
        return self._groups["pp"]

    def get_expert_parallel_world_size(self):
        return self.degrees["ep"]

    def get_expert_parallel_rank(self):
        return self._ep_rank

    def get_expert_parallel_group(self):
        return self._groups["ep"]

    def get_sep_parallel_world_size(self):
        return self.degrees["sp"]

    def get_sep_parallel_rank(self):
        return self._sp_rank

    def get_sep_parallel_group(self):
        return self._groups["sp"]

    def get_check_parallel_group(self):
        return self._groups["data"]

    # ---- the port's additions ----
    def replica_group(self) -> CommGroup:
        """The data replicas, dp x sharding x sp: the ranks with this rank's
        pp, ep and mp coordinates, which hold the same parameter shards. The
        group of the engine's gradient reduce (the JAX engine's batch axes,
        with sp, whose ranks each see their own positions)."""
        return self._groups["replica"]

    def batch_index(self):
        """(this rank's row block, the number of row blocks): its index in
        dp x sharding, where the JAX engine's batch sharding puts it."""
        return (self._dp_rank * self.degrees["sharding"] + self._sharding_rank,
                self.degrees["dp"] * self.degrees["sharding"])


def _unravel(rank, shape):
    coord = []
    for size in reversed(shape):
        rank, c = divmod(rank, size)
        coord.append(c)
    return tuple(reversed(coord))


def _lines(shape, dims):
    """The rank lists of the lines (or planes) of the grid ``shape`` along
    ``dims``, in rank order of their first member; each list in row-major
    order of its varying coordinates."""
    import itertools

    fixed = [d for d in range(len(shape)) if d not in dims]
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    out = []
    for base in itertools.product(*(range(shape[d]) for d in fixed)):
        start = sum(c * strides[d] for c, d in zip(base, fixed))
        ranks = [start + sum(c * strides[d] for c, d in zip(var, dims))
                 for var in itertools.product(*(range(shape[d]) for d in dims))]
        out.append(ranks)
    return out


_global_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg):
    global _global_hcg
    _global_hcg = hcg
    return hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _global_hcg
