"""The parameter server of the port (counterpart of
paddle_tpu/distributed/ps/): the Python surface over the native ps_table
library's tables and TCP service.

Reference: paddle/fluid/distributed/ps/ + python TheOnePSRuntime
(python/paddle/distributed/ps/the_one_ps.py:816). Sparse and dense tables
with server-side optimizers live in host RAM behind the C++ service
(core/native/ps_table.cc); the trainers' dense compute runs on the card and
pulls and pushes rows around it. Ids shard across servers by
``id % num_servers``, the reference's key-hash partitioning.
"""
from .service import (PSClient, PSServer, SparseTableConfig,
                      DenseTableConfig, GraphTableConfig)
from .runtime import (TheOnePSRuntime, DenseSync, GeoSync, GraphClient)
from .layers import DistributedEmbedding, distributed_lookup_table

__all__ = ["PSClient", "PSServer", "SparseTableConfig", "DenseTableConfig",
           "GraphTableConfig", "TheOnePSRuntime", "DenseSync", "GeoSync",
           "GraphClient", "DistributedEmbedding", "distributed_lookup_table"]
