"""Optimizers and sparse pool gradients (port of ``repro.optim``)."""
from repro_torch.optim.compression import (EFState, ef_init, int8_compress,
                                           int8_decompress, topk_compress)
from repro_torch.optim.optimizers import (AdamState, Optimizer, adagrad,
                                          adam, adamw, apply_updates, chain,
                                          clip_by_global_norm, constant,
                                          multi_transform, scale,
                                          scale_by_schedule, sgd,
                                          warmup_cosine)
from repro_torch.optim.sparse import (SparseGrad, from_locations, is_sparse,
                                      sparse_adagrad, sparse_enabled,
                                      sparse_rowwise_adam, sparse_sgd)
