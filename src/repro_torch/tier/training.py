"""TierController: drives a :class:`~repro_torch.tier.store.TieredStore`
through the training loop (port of ``repro.tier.training``).

The controller owns the per-step protocol (writeback -> retier -> plan ->
stage -> install) and the two seams that make tiering invisible to the rest
of the stack:

  * **batch transport**: the remap buffers (``tier_hot_ids`` /
    ``tier_stage_ids`` / ``tier_block``) change every step, so
    :meth:`TierController.batch_fn` rides them inside the batch dict, and
    the loss function peels them back out with :func:`split_batch` and
    merges them into the embedding buffers;
  * **pool leaves by name**: the compact pool is the parameter whose name
    ends in ``memory`` (``embedding.memory``), and its optimizer moments
    are the optimizer-state leaves of the same size under that name
    (Adagrad's accumulator, Adam's ``#1/...`` and ``#2/...``), found by
    :func:`pool_leaf_paths` the way the checkpoint's integrity scan finds
    pool leaves.  The store names them ``"memory"`` and ``"opt:<path>"``.

The compact leaves never change size, so the store writes into them in
place: ``pre_step`` returns the trees it was given.  The controller plans
the stage set from the same location math the step uses (``plan_fn``,
normally ``scheme.locations`` of the batch's global ids), which is what
guarantees every location the step touches has a compact image.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.embed.backends import tiered_active  # noqa: F401
from repro_torch.resilience.integrity import is_memory
from repro_torch.tier.store import StageTransferError

TIER_KEYS = ("tier_hot_ids", "tier_stage_ids", "tier_block")
RETIER_EVERY_DEFAULT = 8


def split_batch(batch: dict) -> tuple[dict, dict]:
    """Peel the per-step tier remap buffers out of a batch dict.
    -> ``(model_batch, tier_buffers)``; an untiered batch passes through
    unchanged (empty dict)."""
    tier = {k: batch[k] for k in TIER_KEYS if k in batch}
    clean = {k: v for k, v in batch.items() if k not in TIER_KEYS}
    return clean, tier


def _walk(tree, prefix: str = ""):
    """``(path, leaf)`` for every tensor or numpy leaf of ``tree`` (dicts,
    tuples, NamedTuples), paths as the checkpoint's integrity scan names
    them: dict keys and ``#i`` tuple indices joined by '/'."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/#{i}")
    elif isinstance(tree, (torch.Tensor, np.ndarray)):
        yield prefix.lstrip("/"), tree


def _floating(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.issubdtype(x.dtype, np.floating)


def pool_leaf_paths(tree, slots: int) -> list:
    """``[(path, leaf)]`` for every leaf mirroring a ``slots``-long pool:
    1-D, floating, under a ``memory`` name (``embedding.memory``; in an
    optimizer state ``embedding.memory`` or ``#1/embedding.memory``), in
    ``params`` or any optimizer state; tensors, or the numpy arrays of a
    restored checkpoint."""
    return [(path, leaf) for path, leaf in _walk(tree)
            if is_memory(path) and leaf.ndim == 1
            and int(leaf.shape[0]) == slots and _floating(leaf)]


def _replace(tree, mapping: dict, prefix: str = ""):
    """``tree`` with the leaves at ``mapping``'s paths (as
    :func:`pool_leaf_paths` names them) replaced."""
    if isinstance(tree, dict):
        return {k: _replace(v, mapping, f"{prefix}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [_replace(v, mapping, f"{prefix}/#{i}")
                 for i, v in enumerate(tree)]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    return mapping.get(prefix.lstrip("/"), tree)


class TierController:
    """Between-steps driver for one tiered pool.

    ``batch_fn``: the raw step -> batch function (the controller wraps it).
    ``plan_fn``: batch -> the global pool locations (any shape, a tensor on
    the store's device, or numpy) the step will touch.
    ``retier_every``: promote/demote cadence in steps (0 disables).
    """

    def __init__(self, store, batch_fn, plan_fn,
                 retier_every: int = RETIER_EVERY_DEFAULT,
                 max_swaps: int | None = None, hysteresis: float = 1.0):
        self.store = store
        self._raw_batch_fn = batch_fn
        self.plan_fn = plan_fn
        self.retier_every = int(retier_every)
        self.max_swaps = max_swaps
        self.hysteresis = float(hysteresis)
        self._cache_step = None
        self._cache_batch = None

    # ------------------------------------------------------------ batches
    def _peek(self, step: int):
        if self._cache_step != step:
            self._cache_batch = self._raw_batch_fn(step)
            self._cache_step = step
        return self._cache_batch

    def batch_fn(self, step: int) -> dict:
        """The trainer-facing batch function: the raw batch plus this step's
        tier remap buffers (the trainer calls :meth:`pre_step` first)."""
        return {**self._peek(step), **self.store.batch_tier_buffers()}

    # --------------------------------------------------------- pool leaves
    @staticmethod
    def _leaves(params, opt_state, slots: int) -> tuple:
        """(the pool parameter's path, the parameter, [(path, moment)]) for
        the ``slots``-long pool leaves of ``params`` and ``opt_state``; the
        store names them ``"memory"`` and ``"opt:<path>"``."""
        p_hits = pool_leaf_paths(params, slots)
        if len(p_hits) != 1:
            raise ValueError(f"expected exactly one {slots}-slot pool leaf "
                             f"in params, got {[k for k, _ in p_hits]}")
        return (*p_hits[0], pool_leaf_paths(opt_state, slots))

    def _collect(self, params, opt_state) -> dict:
        """{store name: live compact leaf}."""
        _, leaf, moments = self._leaves(params, opt_state,
                                        self.store.compact_slots)
        return {"memory": leaf, **{f"opt:{k}": x for k, x in moments}}

    # ------------------------------------------------------------ the hook
    def pre_step(self, step: int, params, opt_state):
        """Run between steps, before the trainer asks for the batch: write
        back the previous stage, re-tier on cadence, plan and stage this
        step's cold blocks, install them.  -> ``(params, opt_state, info)``,
        the trees updated in place; ``info["touched_slots"]`` holds the
        step's global pool locations (the delta checkpoints' dirty set)."""
        st = self.store
        tree = self._collect(params, opt_state)
        st.writeback(tree)
        info = {"promoted": 0, "demoted": 0}
        if self.retier_every and step > 0 and step % self.retier_every == 0:
            tree, info = st.retier(tree, max_swaps=self.max_swaps,
                                   hysteresis=self.hysteresis)
        loc = self.plan_fn(self._peek(step))
        blocks, counts = st.touched_blocks(loc)
        st.observe(blocks, counts)
        try:
            info.update(st.stage(blocks))
        except StageTransferError:
            # staging has no side effect until install() consumes it, so a
            # failed transfer is retried once; a transient fault never
            # perturbs training
            st.stats["stage_retries"] += 1
            info.update(st.stage(blocks))
        st.install(tree)
        info["touched_slots"] = loc.reshape(-1)
        return params, opt_state, info

    def on_restore(self, params=None, opt_state=None, meta=None):
        """A checkpoint restore replaced the pool.

        Without arguments (a checkpoint of compact pools): drop the staged
        rows, which belong to the abandoned timeline, and keep the mirror.

        Full form: ``params`` / ``opt_state`` carry the checkpoint's full
        [m] pool leaves (tensors or numpy) and ``meta`` its ``{hot_ids,
        ema}``.  The mirror adopts the checkpointed bytes, the hot set and
        EMA are restored (re-derived from the EMA when the geometry
        changed), and each full leaf is replaced by a fresh compact one
        (``initial_compact``); staging replans on the next
        :meth:`pre_step`.  -> the compact ``(params, opt_state)``, for the
        trainer to copy into its live tensors."""
        st = self.store
        st.drop_stage()
        self._cache_step = None
        self._cache_batch = None
        if params is None:
            return None
        if meta:
            st.restore_meta(meta.get("hot_ids"), meta.get("ema"))
        p_key, leaf, moments = self._leaves(params, opt_state, st.m)
        st.set_host_full("memory", leaf)
        for k, x in moments:
            st.set_host_full(f"opt:{k}", x)
        return (_replace(params, {p_key: st.initial_compact("memory")}),
                _replace(opt_state, {k: st.initial_compact(f"opt:{k}")
                                     for k, _ in moments}))

    # ------------------------------------------------------------- export
    def export_full(self, params, opt_state):
        """``(params, opt_state)`` with every compact pool leaf replaced by
        its full [m] pool as a numpy array: the durable image a checkpoint
        persists (bit-exact row copies through the host mirror).  Unseen
        moment leaves are registered first, so a fresh run's first save
        already covers the whole cold tier."""
        st = self.store
        p_key, leaf, moments = self._leaves(params, opt_state,
                                            st.compact_slots)
        st._register_tree({f"opt:{k}": x for k, x in moments})
        return (_replace(params, {p_key: st.full_pool(leaf, "memory")}),
                _replace(opt_state, {k: st.full_pool(x, f"opt:{k}")
                                     for k, x in moments}))

    def tier_meta(self) -> dict:
        return self.store.tier_meta()

    def export_params(self, params) -> dict:
        """Params with the compact pool replaced by the full [m] pool on the
        store's device: what eval should see (eval batches are unplanned,
        so they may touch blocks no stage covered).  Bit-exact."""
        hits = pool_leaf_paths(params, self.store.compact_slots)
        if len(hits) != 1:
            raise ValueError([k for k, _ in hits])
        key, leaf = hits[0]
        full = torch.from_numpy(self.store.full_pool(leaf, "memory"))
        return _replace(params, {key: full.to(self.store.device)})

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        s = dict(self.store.stats)
        s["hot_rows"] = self.store.hot_slots
        s["cold_rows"] = self.store.m - self.store.hot_slots
        return s

