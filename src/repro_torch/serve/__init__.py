from repro_torch.serve.batching import (BatchingScorer, bucket_for,
                                       model_score_fn, pad_buckets)

__all__ = ["BatchingScorer", "bucket_for", "model_score_fn", "pad_buckets"]
