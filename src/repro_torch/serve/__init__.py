from repro_torch.serve.batching import (BatchingScorer, bucket_for,
                                       model_score_fn, pad_buckets)
from repro_torch.serve.lm import GenerationResult, LMServer

__all__ = ["BatchingScorer", "GenerationResult", "LMServer", "bucket_for",
           "model_score_fn", "pad_buckets"]
