"""Collectives over one mesh axis, as Functions that ``torch.func`` takes.

In the JAX package these are ``jax.lax`` primitives inside ``shard_map``
bodies, and XLA transposes them. ``torch.distributed.nn.functional``'s
collectives are old-style autograd Functions (no ``setup_context``), which
``torch.func`` refuses, so the port has its own. Each Function here

  - uses the ``setup_context`` style;
  - has a vmap rule that moves the vmapped axis next to the collective's
    row axis (dim 1), so one collective carries every vmapped column (the
    KFAC pullback vmaps over the output columns);
  - has a forward-mode rule: every collective is linear, so the tangent
    goes through the same collective;
  - has a backward that is the transposed collective as another such
    Function, so double backward (the marglik hyperstep) works.

Values are of two kinds. A *whole* value is the same on every rank of the
axis and stands for one global value (the parameters, the selected output
rows, the loss, the KFAC factors). A *rank* value differs per rank: the
rank's block of rows (the features and every activation of a model on a
sharded graph), or what a collective received. :func:`replicate` carries
a whole value into rank computation (its transpose sums the ranks'
cotangents, :func:`sum_replicated`): a model on a sharded graph passes
each whole parameter through it once, at the entry of its ``apply``.
:func:`sum_replicated` turns a sum of rank partials into a whole value (a
KFAC factor, a 'dcn' sum of partial blocks that every slice then uses
alike), and :func:`gather_rows` / :func:`gather_selected` turn rows into a
whole value (their transposes take each rank's rows of the cotangent).
Between rank values, :func:`all_gather` / :func:`reduce_scatter`,
:func:`all_to_all`, :func:`ppermute` and :func:`all_reduce` move data (a
BatchNorm's statistics are an ``all_reduce``: each rank uses them on its
own rows). With these types a replicated loss gets the global gradient on
every rank: no factor of the axis size appears.

A body that has work independent of an exchange issues the exchange into
a :class:`Pending` (``all_to_all`` and ``ppermute`` take one), runs that
work, and then waits: on NCCL the wait only orders the compute stream
after the communication stream, so the exchange overlaps the work. Their
backwards wait at once.

The port never routes a CUDA tensor through a Gloo group: every call
checks the group's backend against the tensor's device. A ``fake`` group
(``torch.testing._internal.distributed.fake_pg``, which moves nothing)
is taken only where the caller asked for it (``make_mesh(...,
allow_fake=True)``): it runs one rank alone at its real shapes, to
measure its memory; the buffers it "receives" are zeros.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

# the names of newer torch releases, where the older ones are deprecated
_all_gather_rows = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_rows = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


@dataclass(frozen=True, eq=False)
class Axis:
    """One axis of a mesh as this rank sees it: its process group, the
    group's backend, its size and this rank's place along it."""
    name: str
    group: object
    backend: str
    size: int
    index: int


def mesh_axis(mesh, name: str = "graph") -> Axis:
    """The :class:`Axis` ``name`` of a ``DeviceMesh``, made once per mesh
    and kept on it: a sharded step asks for it at every body and checks
    its backend at every collective."""
    axes = mesh.__dict__.setdefault("_laplace_gnn_axes", {})
    if name not in axes:
        group = mesh.get_group(name)
        axes[name] = Axis(name=name, group=group,
                          backend=str(dist.get_backend(group)),
                          size=int(mesh.size(mesh.mesh_dim_names.index(name))),
                          index=int(mesh.get_local_rank(name)))
    return axes[name]


class Pending:
    """Collectives issued and not yet awaited. Their outputs may be read
    only after :meth:`wait`."""

    def __init__(self):
        self.works = []

    def wait(self) -> None:
        for work in self.works:
            work.wait()
        self.works.clear()


def _finish(works, pending) -> None:
    """Wait for ``works`` now, or leave them to ``pending``."""
    if pending is None:
        for work in works:
            work.wait()
    else:
        pending.works.extend(works)


def check_backend(x: torch.Tensor, ax: Axis) -> None:
    """Raise when ``x`` would cross a group whose backend cannot carry it:
    Gloo takes CPU tensors only, and the port never stages a card's tensor
    through the host to use it."""
    if x.device.type != "cpu" and ax.backend == "gloo":
        raise RuntimeError(
            f"a {x.device.type} tensor on the Gloo group of axis "
            f"{ax.name!r}: the port routes only CPU tensors through Gloo "
            f"(join an NCCL group for the GPU)")


# -- the raw collectives (no autograd) ----------------------------------------

def _received(x: torch.Tensor, shape, ax: Axis) -> torch.Tensor:
    """A buffer for what a collective receives: zeros on a fake group,
    which writes nothing into it."""
    if ax.backend == "fake":
        return x.new_zeros(shape)
    return x.new_empty(shape)


def _all_gather(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The ranks' (n, ...) blocks stacked along rows: (size * n, ...)."""
    check_backend(x, ax)
    x = x.contiguous()
    out = _received(x, (ax.size * x.shape[0],) + tuple(x.shape[1:]), ax)
    _all_gather_rows(out, x, group=ax.group)
    return out


def _reduce_scatter(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum over ranks of (size * n, ...), this rank's n rows of it."""
    check_backend(x, ax)
    x = x.contiguous()
    n = x.shape[0] // ax.size
    if ax.backend == "gloo":            # Gloo has no reduce-scatter
        total = x.clone()
        dist.all_reduce(total, group=ax.group)
        return total[ax.index * n:(ax.index + 1) * n].clone()
    out = _received(x, (n,) + tuple(x.shape[1:]), ax)
    _reduce_scatter_rows(out, x, group=ax.group)
    return out


def _all_to_all(x: torch.Tensor, ax: Axis, pending=None) -> torch.Tensor:
    """(size, ...): chunk q goes to rank q; chunk q of the result came from
    rank q."""
    check_backend(x, ax)
    x = x.contiguous()
    out = _received(x, x.shape, ax)
    _finish([dist.all_to_all_single(out, x, group=ax.group, async_op=True)],
            pending)
    return out


def _ppermute(x: torch.Tensor, ax: Axis, shift: int,
              pending=None) -> torch.Tensor:
    """Send to the rank ``shift`` places on, receive from the rank
    ``shift`` places back."""
    check_backend(x, ax)
    to = (ax.index + shift) % ax.size
    frm = (ax.index - shift) % ax.size
    if to == ax.index:
        return x.clone()
    x = x.contiguous()
    out = _received(x, x.shape, ax)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(ax.group, to),
                      group=ax.group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(ax.group, frm),
                      group=ax.group)]
    _finish(dist.batch_isend_irecv(ops), pending)
    return out


def _all_reduce(x: torch.Tensor, ax: Axis, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    check_backend(x, ax)
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=ax.group)
    return out


def _rows_vmap(fn, x, bdim, *args):
    """Apply a row collective to a vmapped ``x`` with its batch axis moved
    to dim 1; the result keeps it there."""
    return fn(x.movedim(bdim, 1), *args), 1


# -- the Functions ------------------------------------------------------------

class _ShardRows(torch.autograd.Function):
    """whole (size * n, ...) -> this rank's n rows. Transpose: gather."""

    @staticmethod
    def forward(x, ax):
        n = x.shape[0] // ax.size
        return x[ax.index * n:(ax.index + 1) * n].clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ax = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _GatherRows.apply(g, ctx.ax), None

    @staticmethod
    def jvp(ctx, t, _):
        return _ShardRows.apply(t, ctx.ax)

    @staticmethod
    def vmap(info, in_dims, x, ax):
        return _rows_vmap(_ShardRows.apply, x, in_dims[0], ax)


class _GatherRows(torch.autograd.Function):
    """the ranks' rows -> whole. Transpose: each rank's rows of the
    (whole) cotangent."""

    @staticmethod
    def forward(x, ax):
        return _all_gather(x, ax)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ax = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ShardRows.apply(g, ctx.ax), None

    @staticmethod
    def jvp(ctx, t, _):
        return _GatherRows.apply(t, ctx.ax)

    @staticmethod
    def vmap(info, in_dims, x, ax):
        return _rows_vmap(_GatherRows.apply, x, in_dims[0], ax)


class _AllGather(torch.autograd.Function):
    """rank rows -> every rank's rows stacked, a rank value. Transpose:
    reduce-scatter."""

    @staticmethod
    def forward(x, ax):
        return _all_gather(x, ax)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ax = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.ax), None

    @staticmethod
    def jvp(ctx, t, _):
        return _AllGather.apply(t, ctx.ax)

    @staticmethod
    def vmap(info, in_dims, x, ax):
        return _rows_vmap(_AllGather.apply, x, in_dims[0], ax)


class _ReduceScatter(torch.autograd.Function):
    """rank (size * n, ...) -> this rank's n rows of the sum over ranks.
    Transpose: all-gather."""

    @staticmethod
    def forward(x, ax):
        return _reduce_scatter(x, ax)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ax = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.ax), None

    @staticmethod
    def jvp(ctx, t, _):
        return _ReduceScatter.apply(t, ctx.ax)

    @staticmethod
    def vmap(info, in_dims, x, ax):
        return _rows_vmap(_ReduceScatter.apply, x, in_dims[0], ax)


class _AllToAll(torch.autograd.Function):
    """(size, ...) chunks exchanged; the exchange is its own transpose."""

    @staticmethod
    def forward(x, ax, pending):
        return _all_to_all(x, ax, pending)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ax = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.ax, None), None, None

    @staticmethod
    def jvp(ctx, t, _ax, _pending):
        return _AllToAll.apply(t, ctx.ax, None)

    @staticmethod
    def vmap(info, in_dims, x, ax, pending):
        return _rows_vmap(_AllToAll.apply, x, in_dims[0], ax, pending)


class _PPermute(torch.autograd.Function):
    """A ring hop of ``shift`` places; its transpose is the hop back."""

    @staticmethod
    def forward(x, ax, shift, pending):
        return _ppermute(x, ax, shift, pending)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ax, ctx.shift = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _PPermute.apply(g, ctx.ax, -ctx.shift, None), None, None, None

    @staticmethod
    def jvp(ctx, t, _ax, _shift, _pending):
        return _PPermute.apply(t, ctx.ax, ctx.shift, None)

    @staticmethod
    def vmap(info, in_dims, x, ax, shift, pending):
        return _PPermute.apply(x, ax, shift, pending), in_dims[0]


class _AllReduce(torch.autograd.Function):
    """rank -> the sum over ranks, used as a rank value (inside a body);
    its transpose is the same sum."""

    @staticmethod
    def forward(x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ax = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.ax), None

    @staticmethod
    def jvp(ctx, t, _):
        return _AllReduce.apply(t, ctx.ax)

    @staticmethod
    def vmap(info, in_dims, x, ax):
        return _AllReduce.apply(x, ax), in_dims[0]


class _Replicate(torch.autograd.Function):
    """whole -> the same value as a rank value (JAX's replicated in_spec
    of a shard_map body). Transpose: the sum of the ranks' cotangents."""

    @staticmethod
    def forward(x, ax):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ax = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _SumReplicated.apply(g, ctx.ax), None

    @staticmethod
    def jvp(ctx, t, _):
        return _Replicate.apply(t, ctx.ax)

    @staticmethod
    def vmap(info, in_dims, x, ax):
        return _Replicate.apply(x, ax), in_dims[0]


class _SumReplicated(torch.autograd.Function):
    """rank -> whole: the sum over ranks. Transpose: :class:`_Replicate`."""

    @staticmethod
    def forward(x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ax = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Replicate.apply(g, ctx.ax), None

    @staticmethod
    def jvp(ctx, t, _):
        return _SumReplicated.apply(t, ctx.ax)

    @staticmethod
    def vmap(info, in_dims, x, ax):
        return _SumReplicated.apply(x, ax), in_dims[0]


class _PMaxShift(torch.autograd.Function):
    """The maximum over ranks, taken as a constant: its derivative is
    zero. For a softmax's shift only, which cancels in the value."""

    @staticmethod
    def forward(x, ax):
        return _all_reduce(x, ax, dist.ReduceOp.MAX)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g), None

    @staticmethod
    def jvp(ctx, t, _):
        return torch.zeros_like(t)

    @staticmethod
    def vmap(info, in_dims, x, ax):
        return _PMaxShift.apply(x, ax), in_dims[0]


def gather_rows(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The whole value whose rows the ranks hold in order."""
    return _GatherRows.apply(x, ax)


def all_gather(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """JAX's ``all_gather(x, axis, axis=0, tiled=True)`` in a body."""
    return _AllGather.apply(x, ax)


def reduce_scatter(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """JAX's ``psum_scatter(x, axis, tiled=True)`` in a body."""
    return _ReduceScatter.apply(x, ax)


def all_to_all(x: torch.Tensor, ax: Axis,
               pending: Optional[Pending] = None) -> torch.Tensor:
    """JAX's ``all_to_all(x, axis, 0, 0, tiled=False)`` for (size, ...);
    with ``pending`` the result may be read after ``pending.wait()``."""
    return _AllToAll.apply(x, ax, pending)


def ppermute(x: torch.Tensor, ax: Axis, shift: int,
             pending: Optional[Pending] = None) -> torch.Tensor:
    """JAX's ``ppermute`` with perm ``[(q, (q + shift) % size)]``; with
    ``pending`` the result may be read after ``pending.wait()``."""
    return _PPermute.apply(x, ax, shift, pending)


def all_reduce(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """JAX's ``psum`` in a body, the result used per rank."""
    return _AllReduce.apply(x, ax)


def replicate(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """A whole value entering a body (JAX's ``P()`` in_spec)."""
    return _Replicate.apply(x, ax)


def sum_replicated(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum over ranks of a rank value, as a whole value."""
    return _SumReplicated.apply(x, ax)


def pmax_shift(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """JAX's ``pmax(stop_gradient(x), axis)``: the maximum over ranks as a
    constant (a softmax's shift)."""
    return _PMaxShift.apply(x, ax)


def _selection_plan(idx: torch.Tensor, block: int, ax: Axis):
    """Where each of the whole rows ``idx`` lies: (this rank's local rows
    of ``idx``, the common padded count K, the position of each ``idx``
    entry in the ranks' stacked (size * K) selections). ``idx`` is the
    same on every rank."""
    idx = idx.reshape(-1).to(torch.int64)
    owner = torch.div(idx, block, rounding_mode="floor")
    counts = torch.bincount(owner, minlength=ax.size)
    k = max(1, int(counts.max()))
    order = torch.argsort(owner, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(idx)
    pos[order] = torch.arange(idx.numel(), device=idx.device) - starts[
        owner[order]]
    local = idx[owner == ax.index] - ax.index * block
    return local, k, owner * k + pos


def gather_selected(x_blk: torch.Tensor, idx, ax: Axis) -> torch.Tensor:
    """The whole rows ``x[idx]`` of a value whose row blocks the ranks
    hold: each rank takes its own rows of ``idx``, pads them to the common
    count, and one all-gather of (K, ...) per rank, reordered, gives every
    rank the same (len(idx), ...) value. Its transpose gives each rank the
    cotangent of its own rows (no sum)."""
    idx = torch.as_tensor(idx, device=x_blk.device)
    local, k, where = _selection_plan(idx, x_blk.shape[0], ax)
    mine = x_blk[local]
    pad = k - mine.shape[0]
    if pad:
        mine = torch.cat([mine, mine.new_zeros((pad,) + tuple(
            mine.shape[1:]))])
    return gather_rows(mine, ax)[where].reshape(
        tuple(idx.shape) + tuple(x_blk.shape[1:]))
