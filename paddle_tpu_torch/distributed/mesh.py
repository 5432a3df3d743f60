"""Data-parallel topology of the port (counterpart of
paddle_tpu/distributed/mesh.py's ``HybridCommunicateGroup``).

The ranks of the process group form the reference's grid in its axis order
(pp, dp, sharding, sp, ep, mp; row-major). This slice runs pure data
parallelism: the data replicas are ``dp x sharding`` (every rank), and a
degree of mp, pp, sp or ep above 1 raises ``NotImplementedError``
(tensor and sequence parallelism, ROADMAP.md Queue 1 item 9; pipeline and
expert parallelism, item 11). Without a process group the topology is one
rank and its groups carry no process group: collectives over them are the
identity.
"""
from __future__ import annotations

from typing import List, Optional

import torch.distributed as dist

AXES_ORDER = ("pp", "dp", "sharding", "sp", "ep", "mp")
_NOT_PORTED = {"mp": "ROADMAP.md Queue 1 item 9 (tensor parallelism)",
               "sp": "ROADMAP.md Queue 1 item 9 (sequence parallelism)",
               "pp": "ROADMAP.md Queue 1 item 11 (pipeline parallelism)",
               "ep": "ROADMAP.md Queue 1 item 11 (expert parallelism)"}


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
    -1 fills the world: world size / sharding_degree."""

    def __init__(self, dp_degree=-1, mp_degree=1, pp_degree=1, sharding_degree=1,
                 sp_degree=1, ep_degree=1):
        for axis, d in (("mp", mp_degree), ("pp", pp_degree), ("sp", sp_degree),
                        ("ep", ep_degree)):
            if d is not None and d > 1:
                raise NotImplementedError(
                    f"{axis}_degree={d}: the port runs data parallelism only; "
                    f"{axis} needs {_NOT_PORTED[axis]}")
        self.distributed = dist.is_initialized()
        world = dist.get_world_size() if self.distributed else 1
        self.global_rank = dist.get_rank() if self.distributed else 0
        sharding = max(1, int(sharding_degree))
        if dp_degree is None or dp_degree <= 0:
            if world % sharding:
                raise ValueError(f"sharding_degree={sharding} does not divide the "
                                 f"world of {world} ranks")
            dp_degree = world // sharding
        if dp_degree * sharding != world:
            raise ValueError(f"dp_degree={dp_degree} x sharding_degree={sharding} "
                             f"must equal the world of {world} ranks")
        self.degrees = {"pp": 1, "dp": int(dp_degree), "sharding": sharding,
                        "sp": 1, "ep": 1, "mp": 1}
        self.nranks = world
        world_pg = dist.group.WORLD if self.distributed else None
        # rank = dp_index * sharding + sharding_index (row-major)
        dp_i, sh_i = divmod(self.global_rank, sharding)
        self._groups = {"data": CommGroup("data", range(world), world_pg)}
        for axis, ranks_of in (("dp", lambda j: [j + sharding * i for i in range(dp_degree)]),
                               ("sharding", lambda i: [i * sharding + j for j in range(sharding)])):
            deg = self.degrees[axis]
            if deg == world:
                self._groups[axis] = CommGroup(axis, range(world), world_pg)
            elif deg == 1:
                self._groups[axis] = CommGroup(axis, [self.global_rank])
            else:  # every rank joins the creation of every subgroup
                mine = None
                for idx in range(world // deg):
                    ranks = ranks_of(idx)
                    pg = dist.new_group(ranks)
                    if self.global_rank in ranks:
                        mine = CommGroup(axis, ranks, pg)
                self._groups[axis] = mine
        self._dp_rank, self._sharding_rank = dp_i, sh_i

    # ---- reference accessor surface ----
    def get_parallel_mode(self):
        return "sharding_parallel" if self.degrees["sharding"] > 1 else "data_parallel"

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

    def get_check_parallel_group(self):
        return self._groups["data"]

    # ---- the port's addition ----
    def replica_group(self) -> CommGroup:
        """The data replicas, dp x sharding (every rank): the group of the
        engine's gradient reduce (the JAX engine's ``_batch_axes``)."""
        return self._groups["data"]


_global_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg):
    global _global_hcg
    _global_hcg = hcg
    return hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _global_hcg
