"""repro_torch.tier: the tiered memory store, HBM-hot / host-cold pools
(port of ``repro.tier``).

See :mod:`repro_torch.tier.store` for the storage layer (compact device
pool, host mirror, staging through pinned buffers on a side stream, EMA
re-tiering) and :mod:`repro_torch.tier.training` for the training-loop
controller.
"""
from repro_torch.tier.store import (  # noqa: F401
    BLOCK_DEFAULT,
    StageTransferError,
    TieredStore,
    budget_slots,
    needs_tiering,
    remap_locations,
    tier_budget_mb,
    tier_split,
)
from repro_torch.tier.training import (  # noqa: F401
    TIER_KEYS,
    TierController,
    pool_leaf_paths,
    split_batch,
    tiered_active,
)
