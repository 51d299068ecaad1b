"""The forward pieces of an LM stored for training under a mesh (the
reference's ``lm_rules`` layout, run as its ``shard_map`` transposes run
it).

A parameter of such a model is a ``sharding.StoredBlock``: its block of
the whole leaf, with the spec it is stored by and its mesh
(``sharding.store_blocks``).  Each layer has one forward body, run through
a ``Layout`` read off one of its weights (``layout``): on one card every
step of it is the plain op (the weight itself, every head, the identity);
on a rank of the training layout it is the following.  Before a
matmul a weight is gathered over the dp axes its storage dims are split
over (ZeRO-3: ``dp_gathered``), down to its compute layout: whole, or
split over 'model' on its output dim (column-parallel: ``wq``, ``wk``,
``wv``, ``wq_b``, ``wkv_b``, the FFN's ``gate`` and ``up``) or on its
input dim (row-parallel: ``wo``, ``down``).  A replicated activation
enters a column-parallel matmul through ``collectives.enter_model`` (its
gradient summed over 'model') and a row-parallel matmul's partial sums
leave through ``collectives.leave_model`` (a ``psum``).  Every gather's
backward reduce-scatters, so a block's gradient arrives summed over the
'data' ranks that gathered it: the step folds over 'data' only the leaves
replicated over 'data' (``guard._data_reduce``).  Activations outside the
tensor-parallel regions are replicated over 'model', and so are their
gradients, which is what lets every leaf replicated over 'model' take its
gradient from its own rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import spec_axes, stored_mesh, stored_spec


def train_mesh(p: torch.Tensor):
    """The mesh ``p`` is a block of, for a model stored for training under
    one, else None (``sharding.stored_mesh``: a recompute in the backward
    runs where the installed mesh is not seen)."""
    return stored_mesh(p) if stored_spec(p) is not None else None


def model_dim(p: torch.Tensor) -> int | None:
    """The dim of ``p`` split over 'model', or None."""
    spec = stored_spec(p)
    for i in range(len(spec)):
        if "model" in spec_axes(spec, i):
            return i
    return None


def _gathered(p: torch.Tensor, mesh, keep: tuple[str, ...]) -> torch.Tensor:
    w = p
    spec = stored_spec(p)
    for i in range(len(spec)):
        axes = tuple(a for a in spec_axes(spec, i) if a not in keep)
        if not axes:
            continue
        if len(axes) != len(spec_axes(spec, i)):
            raise ValueError(f"a dim stored over {spec_axes(spec, i)} "
                             f"cannot keep {keep}")
        w = col.gather_t(w, mesh, axes if len(axes) > 1 else axes[0], i)
    return w


def dp_gathered(p: torch.Tensor, mesh) -> torch.Tensor:
    """``p``'s block gathered over every axis of its spec but 'model' (its
    compute layout); the gradient comes back reduce-scattered."""
    return _gathered(p, mesh, ("model",))


def whole(p: torch.Tensor, mesh) -> torch.Tensor:
    """``p``'s block gathered whole over every axis of its spec."""
    return _gathered(p, mesh, ())


class Layout:
    """How a layer's forward body fetches its weights and crosses 'model':
    with no mesh (``PLAIN``) each step is the plain op; on a rank of the
    training layout the weights are gathered over the dp axes and, where
    the layer is ``split`` over 'model' (its deciding weight's output dim,
    dim 0, is: column-parallel heads or FFN columns, or vocab rows), the
    activations enter and leave the tensor-parallel region through
    ``collectives.enter_model`` / ``leave_model``."""

    def __init__(self, mesh=None, split: bool = False):
        self.mesh, self.split = mesh, split

    def weight(self, p: torch.Tensor) -> torch.Tensor:
        """``p`` in its compute layout (``dp_gathered``)."""
        return p if self.mesh is None else dp_gathered(p, self.mesh)

    def heads(self, H: int) -> tuple[int, int]:
        """(first, count) of the H heads this rank computes: its 'model'
        share where the layer is split, else all."""
        if not self.split:
            return 0, H
        if H % self.mesh.model:
            raise NotImplementedError(f"{H} heads over a 'model' axis of "
                                      f"{self.mesh.model}")
        n = H // self.mesh.model
        return self.mesh.rank * n, n

    def first(self, n: int) -> int:
        """The first of this rank's n vocab rows (0 unless split)."""
        return self.mesh.rank * n if self.split else 0

    def enter(self, *ts: torch.Tensor):
        """Replicated activations into the split region: the identity,
        whose backward sums the cotangent over 'model' (several tensors in
        one collective, concatenated on their last dim)."""
        if self.split and len(ts) > 1:
            cat = col.enter_model(torch.cat(ts, dim=-1), self.mesh)
            ts = torch.split(cat, [t.shape[-1] for t in ts], dim=-1)
        elif self.split:
            ts = (col.enter_model(ts[0], self.mesh),)
        return ts[0] if len(ts) == 1 else tuple(ts)

    def leave(self, t: torch.Tensor) -> torch.Tensor:
        """A split region's partial sums summed over 'model'."""
        return col.leave_model(t, self.mesh) if self.split else t

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over 'model' (no gradient)."""
        return col.pmax(t, self.mesh) if self.split else t

    def lin(self, x: torch.Tensor, layer, rows=None) -> torch.Tensor:
        """``layer`` on x (column-parallel where its weight is stored so);
        with ``rows``, its weight and bias gathered whole and cut to those
        output rows."""
        if rows is not None:
            w, b = layer.weight, layer.bias
            if self.mesh is not None:
                w = whole(w, self.mesh)
                b = None if b is None else whole(b, self.mesh)
            return F.linear(x, w[rows], None if b is None else b[rows])
        if self.mesh is None:
            return layer(x)
        return F.linear(x, self.weight(layer.weight), layer.bias)

    def out(self, h: torch.Tensor, layer) -> torch.Tensor:
        """``layer`` on h, row-parallel where split: the partial sums leave
        over 'model' before the bias is added."""
        if self.mesh is None:
            return layer(h)
        y = self.leave(F.linear(h, self.weight(layer.weight)))
        return y if layer.bias is None else y + layer.bias

    def rows(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """``table[ids]``; vocab-parallel where split: this rank's [V / M]
        rows give the ids in their range, zero rows the others, and the
        sum over 'model' gives every id's row on every rank."""
        table = self.weight(table)
        if not self.split:
            return table[ids.long()]
        n = table.shape[0]
        local = ids.long() - self.first(n)
        mine = (local >= 0) & (local < n)
        got = table[local.clamp(0, n - 1)]
        got = torch.where(mine[..., None], got,
                          torch.zeros((), dtype=got.dtype, device=got.device))
        return self.leave(got)

    def pick(self, lg: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """``lg[..., ids]``; where split, lg holds this rank's [V / M]
        columns and an id of another rank's range gives 0."""
        n = lg.shape[-1]
        local = ids.long() - self.first(n)
        if not self.split:
            return torch.gather(lg, -1, local[..., None])[..., 0]
        mine = (local >= 0) & (local < n)
        got = torch.gather(lg, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(mine, got, torch.zeros((), dtype=got.dtype,
                                                  device=got.device))


PLAIN = Layout()


def layout(p: torch.Tensor) -> Layout:
    """The ``Layout`` of the layer whose deciding weight is ``p``:
    ``PLAIN`` unless ``p`` is a block of a model stored for training under
    a mesh, split where ``p``'s dim 0 is stored over 'model'."""
    mesh = train_mesh(p)
    return PLAIN if mesh is None else Layout(mesh, model_dim(p) == 0)
