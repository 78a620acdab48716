"""Device meshes over ``torch.distributed`` ranks (the port of
``repro.launch.mesh``).

A :class:`DeviceMesh` lays the ranks of the default process group out as
a named grid, row-major: on a ``(data, model)`` mesh of shape (2, 2) rank
``d * 2 + m`` sits at data index d and model index m, as device ``(d, m)``
of the reference's ``make_mesh`` does.  It holds a process group for
every slice along every subset of its axes (every rank creates every
group, in the same order), its coordinates, and the collectives the
port's sharded code runs: ``all_reduce``, ``all_gather``,
``all_to_all_single``, ``send``/``recv``, ``exchange`` and
``broadcast``, each over a named axis or tuple of axes.

Backends.  ``nccl``: a card a rank, collectives on the card (a serving
step captures them in its CUDA graph).  ``gloo``: CPU tensors (the
tests), or card tensors staged through pinned host memory, exempt from
the serving engine's debug guard as its own sampled-token copy is; two
ranks sharing one card run over gloo (NCCL refuses two ranks on one
device), which proves the path and the kernels at the sharded shapes but
measures nothing of a collective between cards.  The serving engine's
(pp, tp) mesh (:class:`repro_torch.serving.sharded.EngineMesh`) is a
view of one.

The collectives that training differentiates through are autograd
functions: :func:`all_to_all` (its backward is the reverse exchange),
:func:`gather_slices` (an all-gather whose backward keeps the rank's own
slice of an identical cotangent, unsummed), and Megatron's ``f``
(:func:`copy_in`: identity forward, all-reduce backward) and ``g``
(:func:`reduce_out`: all-reduce forward, identity backward).

A mesh of one rank needs no process group.  A mesh built with an
explicit ``rank`` and no process group is a layout only (a rank's part is
built or loaded, never run): its collectives raise.

The reference's shapes: one pod of 256 chips as (data=16, model=16), two
pods as (pod=2, data=16, model=16) (:func:`production_mesh_shape`).
"""

from __future__ import annotations

import contextlib
import itertools
import math
import time
from collections import Counter
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device, sync_mode

__all__ = ["AxisComm", "DeviceMesh", "Placement", "all_to_all",
           "copy_in", "gather_slices", "make_host_mesh", "make_mesh",
           "make_production_mesh", "production_mesh_shape", "reduce_out"]

Axes = str | tuple[str, ...]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The reference's production mesh: (shape, axis names)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


@dataclass(frozen=True)
class Placement:
    """Where a rank's tensor lies in the full one: dimension ``dim`` split
    into ``parts`` equal slices over mesh axes ``axes``, of which the rank
    holds slice ``index``; ``dim`` None: the rank holds the whole tensor
    (replicated)."""
    dim: int | None = None
    axes: tuple[str, ...] = ()
    parts: int = 1
    index: int = 0

    @property
    def sharded(self) -> bool:
        return self.dim is not None and self.parts > 1

    def full_shape(self, local_shape) -> tuple[int, ...]:
        shape = list(local_shape)
        if self.sharded:
            shape[self.dim] *= self.parts
        return tuple(shape)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full tensor."""
        if not self.sharded:
            return full
        size = full.shape[self.dim] // self.parts
        return full.narrow(self.dim, self.index * size, size)


class DeviceMesh:
    """This rank's place in a named grid of ranks over the default process
    group, and the grid's collectives.  ``stats`` counts each collective
    by tag (``calls``, ``bytes`` sent by this rank and host ``seconds``,
    staging included)."""

    def __init__(self, shape, axes, device: str | torch.device = "cpu", *,
                 rank: int | None = None):
        shape = tuple(int(s) for s in shape)
        axes = tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                             "length")
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.n_ranks = math.prod(shape)
        self.device = torch.device(device)
        world = dist.get_world_size() if _initialized() else 1
        if rank is None:
            if world != self.n_ranks:
                raise ValueError(
                    f"a mesh of shape {shape} needs a process group of "
                    f"{self.n_ranks} ranks, not {world}; launch them with "
                    "repro_torch.serving.sharded.spawn or torchrun")
            rank = dist.get_rank() if _initialized() else 0
            self.connected = True
        else:
            self.connected = self.n_ranks == 1 or (
                _initialized() and world == self.n_ranks
                and dist.get_rank() == rank)
        self.rank = rank
        coords, r = [], rank
        for size in reversed(shape):
            coords.append(r % size)
            r //= size
        self.coords = dict(zip(axes, reversed(coords)))
        self.backend = dist.get_backend() if _initialized() else None
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.stats: dict[str, Counter] = {"calls": Counter(),
                                          "bytes": Counter(),
                                          "seconds": Counter()}
        self._groups: dict[tuple[str, ...], tuple] = {}
        if self.connected and self.n_ranks > 1:
            self._make_groups()

    # -- geometry ---------------------------------------------------------
    def _axes(self, axes: Axes) -> tuple[str, ...]:
        """``axes`` as a tuple of this mesh's axes, in mesh order (names
        the mesh lacks are dropped, as the sharding rules drop them)."""
        want = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in want)

    def size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes: Axes) -> int:
        """This rank's index in its slice along ``axes`` (row-major)."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def _rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def group_ranks(self, axes: Axes) -> list[int]:
        """The global ranks of this rank's slice along ``axes``, in index
        order."""
        axes = self._axes(axes)
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            out.append(self._rank_of({**self.coords, **dict(zip(axes, idx))}))
        return out

    def _make_groups(self) -> None:
        """A process group for every slice along every non-empty subset of
        the axes whose size exceeds 1; every rank creates every group in
        the same order and keeps the ones it belongs to."""
        world = self.n_ranks
        names = [a for a in self.axis_names if self.shape[a] > 1]
        for n in range(1, len(names) + 1):
            for subset in itertools.combinations(names, n):
                rest = [a for a in self.axis_names if a not in subset]
                mine = None
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    base = dict(zip(rest, fixed))
                    ranks = [self._rank_of({**base, **dict(zip(subset, i))})
                             for i in itertools.product(
                                 *(range(self.shape[a]) for a in subset))]
                    g = (dist.group.WORLD if len(ranks) == world
                         else dist.new_group(ranks))
                    if self.rank in ranks:
                        mine = (g, ranks)
                self._groups[subset] = mine

    def _group(self, axes: Axes):
        """(process group, ranks) of this rank's slice along ``axes``, or
        None when the slice is this rank alone."""
        axes = tuple(a for a in self._axes(axes) if self.shape[a] > 1)
        if not axes:
            return None
        if not self.connected:
            raise RuntimeError("this DeviceMesh is a layout only (built with "
                               "an explicit rank outside its process "
                               "group): it runs no collective")
        return self._groups[axes]

    # -- staging and accounting ---------------------------------------------
    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """A pinned host copy of card tensor ``t`` (a synchronous copy)."""
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    @contextlib.contextmanager
    def _count(self, tag: str, t: torch.Tensor):
        """Account one collective; a staged one runs exempt from the debug
        guard's synchronisation trap (an explicit host round trip)."""
        t0 = time.perf_counter()
        with (sync_mode(self.device, 0) if self.staged
              else contextlib.nullcontext()):
            yield
        self.stats["calls"][tag] += 1
        self.stats["bytes"][tag] += t.numel() * t.element_size()
        self.stats["seconds"][tag] += time.perf_counter() - t0

    def reset_stats(self) -> None:
        for c in self.stats.values():
            c.clear()

    def _run(self, t: torch.Tensor, op, tag: str) -> torch.Tensor:
        """Run collective ``op`` on ``t`` in place (staged over gloo for a
        card tensor) and return ``t``."""
        with self._count(tag, t):
            if not self.staged or t.device.type != "cuda":
                op(t)
                return t
            h = self._host(t)
            op(h)
            t.copy_(h)
            return t

    # -- collectives ------------------------------------------------------
    def all_reduce_(self, t: torch.Tensor, axes: Axes,
                    tag: str = "all_reduce") -> torch.Tensor:
        """Sum ``t`` over the slice along ``axes``, in place (every rank
        gets the same bits)."""
        g = self._group(axes)
        if g is None:
            return t
        return self._run(t, lambda x: dist.all_reduce(x, group=g[0]), tag)

    def all_reduce(self, t: torch.Tensor, axes: Axes,
                   tag: str = "all_reduce") -> torch.Tensor:
        """The sum of ``t`` over the slice along ``axes``, a new tensor."""
        if self._group(axes) is None:
            return t
        return self.all_reduce_(t.clone(memory_format=torch.contiguous_format),
                                axes, tag)

    def all_gather(self, t: torch.Tensor, axes: Axes, dim: int = 0,
                   tag: str = "all_gather") -> torch.Tensor:
        """Every slice rank's ``t`` concatenated along ``dim`` in index
        order."""
        g = self._group(axes)
        if g is None:
            return t
        with self._count(tag, t):
            staged = self.staged and t.device.type == "cuda"
            src = self._host(t) if staged else t.contiguous()
            parts = [torch.empty_like(src) for _ in g[1]]
            dist.all_gather(parts, src, group=g[0])
            out = torch.cat(parts, dim=dim)
            return out.to(t.device) if staged else out

    def all_to_all_single(self, t: torch.Tensor, axes: Axes,
                          tag: str = "all_to_all") -> torch.Tensor:
        """``t``'s first axis in equal chunks, chunk j to slice rank j; the
        result's chunk i is what slice rank i sent to this one."""
        g = self._group(axes)
        if g is None:
            return t
        if t.shape[0] % len(g[1]):
            raise ValueError(f"all_to_all: first axis {t.shape[0]} does not "
                             f"split over {len(g[1])} ranks")
        with self._count(tag, t):
            staged = self.staged and t.device.type == "cuda"
            src = self._host(t) if staged else t.contiguous()
            out = torch.empty_like(src)
            dist.all_to_all_single(out, src, group=g[0])
            return out.to(t.device) if staged else out

    def broadcast_(self, t: torch.Tensor, src_index: int, axes: Axes,
                   tag: str = "broadcast") -> torch.Tensor:
        """``t`` of slice rank ``src_index`` on every rank of the slice, in
        place."""
        g = self._group(axes)
        if g is None:
            return t
        src = g[1][src_index]
        return self._run(t, lambda x: dist.broadcast(x, src=src, group=g[0]),
                         tag)

    def exchange(self, t: torch.Tensor, to_index: int, from_index: int,
                 axes: Axes, tag: str = "send_recv") -> torch.Tensor:
        """Send ``t`` to slice rank ``to_index`` and receive a tensor of its
        shape from ``from_index`` (a ring hop: both posted before either
        waits)."""
        g = self._group(axes)
        if g is None:
            return t
        with self._count(tag, t):
            staged = self.staged and t.device.type == "cuda"
            src = self._host(t) if staged else t.contiguous()
            out = torch.empty_like(src)
            reqs = [dist.isend(src, g[1][to_index], group=g[0]),
                    dist.irecv(out, g[1][from_index], group=g[0])]
            for r in reqs:
                r.wait()
            return out.to(t.device) if staged else out

    def send(self, t: torch.Tensor, to_index: int, axes: Axes,
             tag: str = "send") -> None:
        g = self._group(axes)
        with self._count(tag, t):
            staged = self.staged and t.device.type == "cuda"
            dist.send(self._host(t) if staged else t.contiguous(),
                      g[1][to_index], group=g[0])

    def recv(self, like: torch.Tensor, from_index: int, axes: Axes,
             tag: str = "recv") -> torch.Tensor:
        g = self._group(axes)
        out = torch.empty_like(like)
        return self._run(out, lambda x: dist.recv(x, g[1][from_index],
                                                  group=g[0]), tag)

    def barrier(self) -> None:
        if self.connected and self.n_ranks > 1:
            dist.barrier()

    def gather_full(self, t: torch.Tensor, p: Placement) -> torch.Tensor:
        """The full tensor of which ``t`` is this rank's ``p`` slice."""
        if not p.sharded:
            return t
        return self.all_gather(t.contiguous(), p.axes, dim=p.dim,
                               tag="checkpoint")

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords}, backend={self.backend})")


# ---------------------------------------------------------------------------
# constructors (every rank calls them, in the same order)
# ---------------------------------------------------------------------------

def _default_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if _initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", dist.get_rank()
                            % torch.cuda.device_count())
    return resolve_device(None)


def make_mesh(shape, axes, device: str | torch.device | None = None
              ) -> DeviceMesh:
    """A mesh of ``shape`` over the default process group, whose world size
    must be the product of ``shape`` (a mesh of one rank needs none).
    ``device`` defaults to the card (``cuda:rank % count`` under nccl)."""
    return DeviceMesh(shape, axes, _default_device(device))


def make_host_mesh(model: int | None = None,
                   device: str | torch.device | None = None) -> DeviceMesh:
    """(data, model) over every rank of the process group."""
    n = dist.get_world_size() if _initialized() else 1
    model = model or 1
    return make_mesh((n // model, model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = None
                         ) -> DeviceMesh:
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return make_mesh(shape, axes, device)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_to_all_single(x, axes, tag="all_to_all")

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_to_all_single(g.contiguous(), ctx.axes,
                                           tag="all_to_all_bwd"),
                None, None)


class _GatherSlices(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n, ctx.i = x.shape[0], mesh.index(axes)
        return mesh.all_gather(x, axes, dim=0, tag="gather_slices")

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.i * ctx.n, ctx.n), None, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axes, tag="copy_in_bwd"), None, \
            None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x, axes, tag="reduce_out")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axes: Axes
               ) -> torch.Tensor:
    """Differentiable :meth:`DeviceMesh.all_to_all_single`: the backward
    sends each cotangent chunk back where its row came from."""
    return _AllToAll.apply(x, mesh, axes)


def gather_slices(x: torch.Tensor, mesh: DeviceMesh, axes: Axes
                  ) -> torch.Tensor:
    """The slice ranks' ``x`` concatenated along dim 0; the backward takes
    this rank's rows of the cotangent, which every rank holds alike, and
    sums nothing."""
    return _GatherSlices.apply(x, mesh, axes)


def _differentiated(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_in(x: torch.Tensor, mesh: DeviceMesh, axes: Axes) -> torch.Tensor:
    """Megatron's f: identity forward, the cotangent summed over the slice
    in the backward (a replicated input of a split computation)."""
    if mesh.size(axes) == 1 or not _differentiated(x):
        return x
    return _CopyIn.apply(x, mesh, axes)


def reduce_out(x: torch.Tensor, mesh: DeviceMesh, axes: Axes
               ) -> torch.Tensor:
    """Megatron's g: the partial results summed over the slice forward,
    the cotangent passed through unchanged.  With no gradient to take
    (a serving step) ``x`` is summed in place."""
    if mesh.size(axes) == 1:
        return x
    if not _differentiated(x) and x.is_contiguous():
        return mesh.all_reduce_(x, axes, tag="reduce_out")
    return _ReduceOut.apply(x, mesh, axes)


class AxisComm:
    """A tensor-parallel split over mesh axes ``axes``, as the attention and
    MLP blocks call it: ``enter`` (f) on the normed input of the
    column-parallel products, ``exit`` (g) on the row-parallel product."""

    def __init__(self, mesh: DeviceMesh, axes: Axes):
        self.mesh, self.axes = mesh, axes

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        return copy_in(h, self.mesh, self.axes)

    def exit(self, out: torch.Tensor) -> torch.Tensor:
        return reduce_out(out, self.mesh, self.axes)
