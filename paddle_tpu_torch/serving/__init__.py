"""Serving (counterpart of paddle_tpu/serving/): bucketed prefill, slot or
paged KV cache with a radix prefix cache, continuous batching, speculative
decoding with a draft model, drain and SIGTERM handling, the
``ReplicaRouter`` over K engines, and the ``loadgen`` traffic scenarios.

core.monitor counters: serving.prefill_dispatches, serving.prefix_lookups,
serving.prefix_hits, serving.prefill_skips (the paged layout's full hits),
serving.steps, serving.tokens, serving.requests and
serving.outcome.<outcome>; speculative decoding's
serving.draft_prefill_dispatches, serving.verify_dispatches and
serving.spec.proposed / .accepted / .bonus. The metrics registry (when
enabled) gets the engines' serve.* and the router's route.* series.
"""
from .bucketing import DEFAULT_LADDER, bucket_for, clip_ladder, resolve_bucket
from .engine import Request, ServingEngine
from .kv_pages import PagePool, PoolExhausted
from .loadgen import LoadGenerator, Scenario, spike_scenario, zipf_tenants
from .prefix_cache import RadixPrefixCache
from .router import ReplicaRouter
from .sampling import filter_topk_topp, gumbel_noise, sample_tokens, stream_seed

__all__ = ["DEFAULT_LADDER", "LoadGenerator", "PagePool", "PoolExhausted",
           "RadixPrefixCache", "ReplicaRouter", "Request", "Scenario",
           "ServingEngine", "bucket_for", "clip_ladder", "filter_topk_topp",
           "gumbel_noise", "resolve_bucket", "sample_tokens", "spike_scenario",
           "stream_seed", "zipf_tenants"]
