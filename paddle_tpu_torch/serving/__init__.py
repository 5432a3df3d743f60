"""Serving (counterpart of paddle_tpu/serving/): bucketed prefill, slot or
paged KV cache with a radix prefix cache, continuous batching, speculative
decoding with a draft model.

core.monitor counters: serving.prefill_dispatches, serving.prefix_lookups,
serving.prefix_hits, serving.prefill_skips (the paged layout's full hits),
serving.steps, serving.tokens, serving.requests; speculative decoding's
serving.draft_prefill_dispatches, serving.verify_dispatches and
serving.spec.proposed / .accepted / .bonus.
"""
from .bucketing import DEFAULT_LADDER, bucket_for, clip_ladder, resolve_bucket
from .engine import Request, ServingEngine
from .kv_pages import PagePool, PoolExhausted
from .prefix_cache import RadixPrefixCache
from .sampling import filter_topk_topp, gumbel_noise, sample_tokens, stream_seed

__all__ = ["DEFAULT_LADDER", "PagePool", "PoolExhausted", "RadixPrefixCache",
           "Request", "ServingEngine", "bucket_for", "clip_ladder",
           "filter_topk_topp", "gumbel_noise", "resolve_bucket",
           "sample_tokens", "stream_seed"]
