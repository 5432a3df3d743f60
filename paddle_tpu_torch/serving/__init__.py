"""Serving (counterpart of paddle_tpu/serving/): bucketed prefill, slot KV
cache, continuous batching."""
from .bucketing import DEFAULT_LADDER, bucket_for, clip_ladder, resolve_bucket
from .engine import Request, ServingEngine
from .sampling import filter_topk_topp, gumbel_noise, sample_tokens, stream_seed

__all__ = ["DEFAULT_LADDER", "Request", "ServingEngine", "bucket_for",
           "clip_ladder", "filter_topk_topp", "gumbel_noise", "resolve_bucket",
           "sample_tokens", "stream_seed"]
