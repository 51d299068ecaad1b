"""Row-split rules for the arrays sharded over 'model', and the
reference's axis-set templates and rule tables (port of
``repro.dist.sharding``).

The pool, its optimizer states and the D' store are row-sharded: rank r of
P holds rows ``[r * n / P, (r + 1) * n / P)``, the same on every data
index.  The reference pads the store to a multiple of 512 rows so that
every mesh axis divides it (``repro/launch/steps.py:store_rows``); the pad
rows have length 0 and are never looked up.  Of the buffers only the D'
store shards (the reference's ``buffer_rules``); a CSR store is re-based
per rank (``sharded_memory.shard_csr_buffers``).  A checkpoint holds whole
arrays; ``slab_shardings`` cuts a rank's slabs out of them on restore.

Templates (``ALL``, ``DP``, ``EP``; ``resolve_template``, ``spec_for_path``)
resolve as the reference's, against the port's ``Mesh`` (axes 'data' and
'model'; 'pod' is in no mesh and ``_expand`` filters it).  PyTorch has no
``PartitionSpec``: a spec is a tuple with one entry per resolved dim,
``None``, an axis name or a tuple of axis names, which is
``tuple(PartitionSpec(...))`` of the reference.  ``lm_rules`` and
``LM_CACHE_RULES`` are the LM's tables; ``rank_share`` cuts this rank's
block of an array by its rule.
"""
from __future__ import annotations

import re

import numpy as np
import torch

STORE_ROW_MULTIPLE = 512


def store_rows(total_vocab: int) -> int:
    """Dense-store rows padded so that every mesh axis divides them."""
    return -(-total_vocab // STORE_ROW_MULTIPLE) * STORE_ROW_MULTIPLE


def pad_rows(x: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """``x`` with its leading axis padded to ``rows`` with ``fill``."""
    if rows < x.shape[0]:
        raise ValueError(f"cannot pad {x.shape[0]} rows to {rows}")
    pad = torch.full((rows - x.shape[0],) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def row_slab(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous slab of the leading axis of ``x`` (a copy, so
    the whole array can be freed); ``x`` itself with no mesh or a 'model'
    axis of 1.  Raises unless P divides the rows: the reference then falls
    back to an unsharded lookup, which a rank that holds only its slab
    cannot do."""
    if mesh is None or mesh.model <= 1:
        return x
    n, P = x.shape[0], mesh.model
    if n % P:
        raise ValueError(
            f"{n} rows do not divide over a 'model' axis of {P}; pad them "
            f"(a store to store_rows(n) = {store_rows(n)} rows, with empty "
            "sets and length 0)")
    c = n // P
    return x[mesh.rank * c:(mesh.rank + 1) * c].clone()


def shard_buffers(bufs: dict, mesh) -> dict:
    """This rank's share of a scheme's buffers: the dense store's rows
    (``row_slab``), the CSR store's re-based part; the others whole."""
    if mesh is None or mesh.model <= 1:
        return bufs
    if "store_flat" in bufs:
        from repro_torch.dist.sharded_memory import shard_csr_buffers
        return shard_csr_buffers(bufs, mesh)
    return {k: row_slab(v, mesh) if k in ("store_sets", "store_lengths")
            else v for k, v in bufs.items()}


def is_pool_path(path: str) -> bool:
    """Is a checkpoint leaf at ``path`` a pool slab's (any component named
    ``memory``: the pool, its optimizer moments)?"""
    return "memory" in path.split("/")


def slab_shardings(mesh):
    """The ``shardings`` of ``CheckpointManager.restore`` for ``mesh``:
    ``(path, array) -> array``, this rank's 'model' slab of a pool leaf
    (axis 0 of an array with one), every other leaf whole."""
    def cut(path: str, a):
        if mesh is None or mesh.model <= 1 or not is_pool_path(path) \
                or np.ndim(a) == 0:
            return a
        c = a.shape[0] // mesh.model
        if c * mesh.model != a.shape[0]:
            raise ValueError(f"{path}: {a.shape[0]} rows do not divide over "
                             f"a 'model' axis of {mesh.model}")
        return a[mesh.rank * c:(mesh.rank + 1) * c]
    return cut


# ------------------------------------------------------------ templates

class _AxisSet:
    """Named axis-set placeholder, expanded against a concrete mesh."""

    def __init__(self, name: str, members: tuple[str, ...]):
        self.name = name
        self.members = members

    def __repr__(self) -> str:
        return self.name


# ALL: every mesh axis (mesh order).  DP: the data-parallel set.  EP: the
# expert/row-parallel set, ('data', 'model').
ALL = _AxisSet("ALL", ())
DP = _AxisSet("DP", ("pod", "data"))
EP = _AxisSet("EP", ("data", "model"))


def _expand(cand, mesh) -> tuple[str, ...] | None:
    """Candidate -> ordered axis tuple (None means explicit replicate)."""
    if cand is None:
        return None
    if cand is ALL:
        return tuple(mesh.axis_names)
    if isinstance(cand, _AxisSet):
        return tuple(a for a in cand.members if a in mesh.axis_names)
    if isinstance(cand, str):
        return (cand,)
    return tuple(cand)


def resolve_dim(entry, dim: int, mesh, used: set[str]):
    """One template entry -> spec entry (claims axes into ``used``): the
    first candidate whose unclaimed mesh axes have a product above 1 that
    divides ``dim``."""
    if entry is None:
        return None
    sizes = dict(mesh.shape)
    for cand in entry:
        axes = _expand(cand, mesh)
        if axes is None:
            return None
        axes = tuple(a for a in axes if a in sizes and a not in used)
        if not axes:
            continue
        prod = int(np.prod([sizes[a] for a in axes]))
        if prod > 1 and dim % prod == 0:
            used.update(axes)
            return axes if len(axes) > 1 else axes[0]
    return None


def resolve_template(template, shape, mesh) -> tuple:
    """Template + concrete shape + mesh -> spec (never fails: dims whose
    candidates don't fit replicate)."""
    used: set[str] = set()
    return tuple(resolve_dim(e, int(d), mesh, used)
                 for d, e in zip(shape, template))


def spec_for_path(path: str, shape, rules, mesh) -> tuple:
    """The first rule whose regex matches ``path``, resolved; ``()``
    (replicated) when none does."""
    for pat, template in rules:
        if re.search(pat, path):
            return resolve_template(template, shape, mesh)
    return ()


def spec_axes(spec: tuple, i: int) -> tuple[str, ...]:
    """Mesh axes of spec dim i (specs may omit trailing unsharded dims)."""
    entry = spec[i] if i < len(spec) else None
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def axis_index(mesh, axes: tuple[str, ...]) -> int:
    """This rank's block index over ``axes`` (the first axis major, as a
    dim sharded over an axis tuple is laid out)."""
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + (mesh.data_rank if a == "data"
                                     else mesh.rank)
    return idx


def axes_size(mesh, axes) -> int:
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


def block_bounds(mesh, axes, n: int) -> tuple[int, int]:
    """[lo, hi) of this rank's block of ``n`` rows sharded over ``axes``."""
    c = n // axes_size(mesh, axes)
    lo = axis_index(mesh, axes) * c
    return lo, lo + c


def block(x, mesh, spec: tuple):
    """This rank's block of ``x`` (a tensor or numpy array) under
    ``spec``: a view (slices), ``x`` itself when nothing shards."""
    idx = []
    for i in range(len(spec)):
        axes = spec_axes(spec, i)
        n = axes_size(mesh, axes)
        if n == 1:
            idx.append(slice(None))
            continue
        c = x.shape[i] // n
        j = axis_index(mesh, axes)
        idx.append(slice(j * c, (j + 1) * c))
    return x[tuple(idx)] if idx else x


def rank_share(path: str, x, mesh, rules):
    """This rank's block of the leaf at ``path`` by the first matching
    rule of ``rules`` (the whole leaf with no mesh or no match)."""
    if mesh is None:
        return x
    return block(x, mesh, spec_for_path(path, tuple(x.shape), rules, mesh))


# ------------------------------------------------------------ rule tables

def lm_rules():
    """Transformer parameters (the reference's table, leading entry the
    stacked layer axis): Megatron tensor parallelism over 'model' for the
    per-layer matmuls, ZeRO-3 storage over the dp axes for the other big
    dim, experts and vocab rows over EP.  A model built for training under
    a mesh (``transformer.init(..., mesh=, train=True)``) stores every
    leaf by this table (``lm_spec``, ``store_blocks``); a model built to
    serve under a mesh stores by it only the expert stacks (``nn.moe``'s
    storage blocks) and the LMA pool's 'model' slab, its dense leaves
    whole on every rank (a decode step that gathered its weights would
    pay a staged gather a leaf)."""
    return [
        (r"/moe/w_(gate|up)$", [None, [EP, "model", "data"],
                                [DP, "pod", "data"], None]),
        (r"/moe/w_down$", [None, [EP, "model", "data"], None,
                           [DP, "pod", "data"]]),
        (r"/moe/router/", [None, None, None]),
        (r"/attn/w(q|k|v)/kernel$", [None, [DP, "pod", "data"], ["model"]]),
        (r"/attn/w(q|k|v)/bias$", [None, ["model"]]),
        (r"/attn/wo/kernel$", [None, ["model"], [DP, "pod", "data"]]),
        (r"/attn/w(q_a|kv_a)/kernel$", [None, [DP, "pod", "data"], None]),
        (r"/attn/w(q_b|kv_b)/kernel$", [None, None, ["model"]]),
        (r"/(ffn|shared)/(gate|up)/kernel$",
         [None, [DP, "pod", "data"], ["model"]]),
        (r"/(ffn|shared)/down/kernel$",
         [None, ["model"], [DP, "pod", "data"]]),
        (r"/embed/table_0$", [["model"], [DP, "pod", "data"]]),
        (r"/embed/memory$", [["model"]]),
        (r"/lm_head/kernel$", [[DP, "pod", "data"], ["model"]]),
    ]


# The decode cache [count, B, L, (KV, hd | r + rd)]: the batch over the dp
# axes, the LENGTH over 'model' plus every dp axis the batch leaves idle
# (the reference's ``repro/launch/steps.py:81``; ``dist.flash_decode``).
LM_CACHE_RULES = [
    (r"/(k|v)$", [None, [DP, "data", None], [ALL, EP, "model"], None, None]),
    (r"/ckv$", [None, [DP, "data", None], [ALL, EP, "model"], None]),
    (r"/(k|v)_scale$", [None, [DP, "data", None], [ALL, EP, "model"], None]),
    (r"/ckv_scale$", [None, [DP, "data", None], [ALL, EP, "model"]]),
]


# ------------------------------------------------------------ the LM's blocks
#
# A port parameter name is the reference's leaf path with '.' for '/', the
# layer index of a stacked group spelled out (``layers_0.3.attn.wq``: the
# reference's ``/layers_0/attn/wq`` at index 3 of its leading axis), and a
# dense layer's ``weight [out, in]`` for its ``kernel [in, out]``.

def lm_leaf(name: str) -> tuple[str, bool, bool]:
    """A port parameter name -> (the reference's leaf path, whether it is
    a layer of a stacked group, whether the port's leaf is the reference's
    transposed)."""
    parts = name.split(".")
    layer = parts[0].startswith("layers_")
    if layer:
        parts = parts[:1] + parts[2:]
    transposed = parts[-1] == "weight"
    if transposed:
        parts[-1] = "kernel"
    return "/" + "/".join(parts), layer, transposed


def lm_spec(name: str, shape, mesh) -> tuple:
    """The spec, in the port's layout (one entry a dim), by which
    ``lm_rules`` stores the whole port leaf ``name`` of ``shape``: the
    reference's spec of its leaf (the stacked layer axis dropped), reversed
    for a transposed ``weight``."""
    path, layer, transposed = lm_leaf(name)
    shape = tuple(int(s) for s in shape)
    ref = shape[::-1] if transposed else shape
    if layer:
        spec = spec_for_path(path, (1,) + ref, lm_rules(), mesh)[1:]
    else:
        spec = spec_for_path(path, ref, lm_rules(), mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return spec[::-1] if transposed else spec


class StoredBlock(torch.nn.Parameter):
    """A parameter of a model built for training under a mesh: this rank's
    block of the whole leaf, stored by ``spec`` (``lm_spec``) over
    ``mesh``.  The mesh is held here, not read from the installed one: a
    recompute under ``torch.utils.checkpoint`` runs in the autograd
    engine's device thread, where the thread-local installation is not
    seen.  A deep copy keeps both (the same mesh: its process groups are
    this rank's), and so does a conversion that replaces the parameter
    (``Transformer._apply``: ``keep_blocks``)."""

    def __new__(cls, data, spec, mesh, requires_grad: bool = True):
        p = super().__new__(cls, data, requires_grad)
        p.spec, p.mesh = tuple(spec), mesh
        return p

    def __deepcopy__(self, memo):
        if id(self) not in memo:
            memo[id(self)] = StoredBlock(
                self.data.clone(memory_format=torch.preserve_format),
                self.spec, self.mesh, self.requires_grad)
        return memo[id(self)]


def stored_spec(p) -> tuple | None:
    """The spec a ``StoredBlock`` is stored by; None for a leaf held whole
    or as ``nn.moe`` / the LMA pool store it for serving."""
    return p.spec if isinstance(p, StoredBlock) else None


def stored_mesh(p):
    """The mesh a ``StoredBlock`` belongs to, else None."""
    return p.mesh if isinstance(p, StoredBlock) else None


def _put(model, name: str, p) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(owner) if owner else model, leaf, p)


def store_blocks(model, cfg, mesh) -> None:
    """Make every parameter of ``model`` a ``StoredBlock``: this rank's
    block by ``lm_rules`` (a leaf built whole is cut and its copy kept; an
    expert stack or LMA pool built as its block stays).  The whole shapes
    come from ``cfg``'s model on the meta device."""
    from repro_torch.models.transformer import Transformer
    with torch.device("meta"):
        whole = dict(Transformer(cfg, torch.Generator(),
                                 torch.device("meta")).named_parameters())
    for name, p in list(model.named_parameters()):
        full = tuple(whole[name].shape)
        spec = lm_spec(name, full, mesh)
        data = p.data
        if tuple(data.shape) == full:
            data = block(data, mesh, spec).clone()
        want = tuple(block(torch.empty(full, device="meta"), mesh,
                           spec).shape)
        if tuple(data.shape) != want:
            raise ValueError(f"{name}: {tuple(p.shape)} is neither the whole "
                             f"{full} nor this rank's block {want}")
        _put(model, name, StoredBlock(data, spec, mesh, p.requires_grad))


def keep_blocks(model, convert):
    """``convert()`` (``Module._apply``), then every ``StoredBlock`` of
    ``model`` that it replaced by a plain parameter (``torch.__future__``'s
    overwrite or swap on conversion) made one again with its spec and
    mesh; -> what ``convert`` returned."""
    kept = {k: (p.spec, p.mesh) for k, p in model.named_parameters()
            if isinstance(p, StoredBlock)}
    out = convert()
    for name, p in list(model.named_parameters()):
        if name in kept and not isinstance(p, StoredBlock):
            _put(model, name, StoredBlock(p.data, *kept[name],
                                          p.requires_grad))
    return out


def whole_shape(shape, spec, sizes: dict) -> tuple:
    """A block's whole leaf shape under ``spec`` over a mesh of axis
    ``sizes``."""
    return tuple(int(n) * int(np.prod([sizes[a] for a in spec_axes(spec, i)]))
                 for i, n in enumerate(shape))


def mesh_at(mesh_shape: tuple, world_rank: int):
    """The ``Mesh`` of world rank ``world_rank`` of a ``(data, model)``
    mesh (no process groups: for cutting and placing blocks)."""
    from repro_torch.dist.context import Mesh
    D, M = mesh_shape
    return Mesh(model=M, rank=world_rank % M, data=D,
                data_rank=world_rank // M)


def assemble(blocks: list, spec: tuple, mesh_shape: tuple):
    """The whole leaf from every world rank's block (by world rank,
    data-major) under ``spec``: numpy arrays give an array, tensors a
    tensor on the host; replicas write the same place (the last one's bits
    stay)."""
    D, M = mesh_shape
    first = blocks[0]
    shape = whole_shape(first.shape, spec, {"data": D, "model": M})
    if isinstance(first, torch.Tensor):
        out = torch.empty(shape, dtype=first.dtype)
    else:
        out = np.empty(shape, np.asarray(first).dtype)
    for r, b in enumerate(blocks):
        block(out, mesh_at(mesh_shape, r), spec)[...] = b
    return out
