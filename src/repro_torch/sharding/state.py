"""A train state sharded over a (data, model) mesh, with explicit
collectives where the reference lets XLA's partitioner place them.

Between steps a rank holds only its shards of every parameter and
optimizer moment, split by ``sharding.specs`` (the reference's
per-device shapes).  A step (``train.train_step.make_train_step(...,
mesh=)``) runs the forward and backward on the rank's rows of the
batch inside a :class:`LayerGather` scope: each layer's parameters are
gathered just before the layer runs (``models.common.gather_layer``)
and freed after it, gathered again in the backward where it needs them
(remat's recomputation, or a saved weight unpacked), and each gathered
leaf's gradient leaves the backward as this rank's fp32 shard, summed
over the ``data`` ranks (a reduce-scatter where the leaf splits on the
data axis, else an all-reduce) and over the microbatches.  The global
norm is the one-device norm where every rank holds whole gradients (a
``1xM`` mesh, one microbatch: a step is then bit for bit the
one-device step), else summed from the shards; the update writes the
local shards.

A leaf's :class:`Placement` is its spec over its own dims and, where the
reference splits a stacked layer axis, the coordinate that owns it:
ranks at other coordinates hold an empty tensor, and the owner sends
the leaf out when it is gathered.

Collectives are ``all_gather`` (list form), ``all_reduce``,
``reduce_scatter`` and ``broadcast`` on the mesh's groups, all through
the grid's communicator: :class:`DistComm` calls ``torch.distributed``
(gloo takes them on CPU and CUDA tensors, NCCL on CUDA tensors);
:class:`CountingComm` only records each call's kind, bytes and group, so
that a :meth:`Grid.counting` grid, which needs no process group, runs
the step's own code on the meta device (``launch.dryrun``).  The bytes a
rank holds are :func:`shard_bytes` of :func:`train_placements`, a
function of the axis sizes and the rank's coordinates alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import weakref

import torch
import torch.distributed as dist
from torch import nn

from .specs import (DATA, axes_of, axis_sizes, opt_specs, param_specs,
                    split_name, stack_extents)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A leaf on the mesh: ``shape`` its full shape, ``spec`` one entry
    per dim of it, ``owner`` the ((axis, coordinate), ...) that alone
    hold it (empty: every coordinate)."""
    shape: tuple
    spec: tuple
    owner: tuple = ()


def _combined(sizes: dict, coords: dict, axes) -> int:
    """A rank's block index on a dim split over ``axes`` (row-major, the
    first axis the major)."""
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx


def local_shape(sizes: dict, coords: dict, pl: Placement) -> tuple:
    """The shard shape of ``pl`` at ``coords`` (zeros where those
    coordinates do not own it)."""
    if not all(coords[a] == c for a, c in pl.owner):
        return (0,) * len(pl.shape)
    return tuple(d // math.prod(sizes[a] for a in axes_of(s))
                 for d, s in zip(pl.shape, pl.spec))


def shard_bytes(sizes: dict, coords: dict, placed: dict) -> int:
    """The bytes of the shards at ``coords`` of ``placed``, a mapping of
    state paths to (:class:`Placement`, dtype)."""
    return sum(math.prod(local_shape(sizes, coords, pl)) * dt.itemsize
               for pl, dt in placed.values())


def coordinates(sizes: dict):
    """Every rank's coordinates on a mesh of ``sizes``, rank order
    (row-major: the last axis the minor)."""
    names = list(sizes)
    for flat in range(math.prod(sizes.values())):
        c, rest = {}, flat
        for a in reversed(names):
            c[a] = rest % sizes[a]
            rest //= sizes[a]
        yield {a: c[a] for a in names}


def placement(sizes: dict, name: str, shape, spec, extents) -> Placement:
    """The :class:`Placement` of leaf ``name`` (its full ``shape``) under
    a spec from ``specs.param_specs``/``opt_specs``: leading entries past
    the leaf's rank split its stacked layer axes, whose ``extents`` are
    given, and become its owner."""
    shape = tuple(shape)
    lead = len(spec) - len(shape)
    if lead == 0:
        return Placement(shape, tuple(spec))
    _, layers = split_name(name)
    owner = []
    for ix, ext, entry in zip(layers, extents, spec[:lead]):
        axes = axes_of(entry)
        if not axes:
            continue
        c = ix // (ext // math.prod(sizes[a] for a in axes))
        for a in reversed(axes):
            owner.append((a, c % sizes[a]))
            c //= sizes[a]
    return Placement(shape, tuple(spec[lead:]), tuple(owner))


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class DistComm:
    """The grid's collectives on ``torch.distributed`` process groups.
    ``seconds``: None, or the seconds summed over the calls since it was
    set to a number, each call between two device synchronises (the
    mesh step's ``timed``)."""

    seconds: float | None = None

    def _run(self, fn, x: torch.Tensor, *args, **kw) -> None:
        if self.seconds is None:
            fn(*args, **kw)
            return
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        fn(*args, **kw)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        self.seconds += time.perf_counter() - t0

    def all_gather(self, parts: list, x: torch.Tensor, group) -> None:
        self._run(dist.all_gather, x, parts, x, group=group)

    def all_reduce(self, x: torch.Tensor, group, op: str = "sum") -> None:
        self._run(dist.all_reduce, x, x, op=_OPS[op], group=group)

    def reduce_scatter(self, out: torch.Tensor, x: torch.Tensor,
                       group) -> None:
        """``out`` the group member's block of ``x`` (split on dim 0),
        summed over the group."""
        self._run(dist.reduce_scatter_tensor, x, out, x, group=group)

    def broadcast(self, x: torch.Tensor, owner: int, group) -> None:
        """``x`` from the group's member at coordinate ``owner``."""
        self._run(dist.broadcast, x, x, src=dist.get_global_rank(group, owner),
                  group=group)


@dataclasses.dataclass(frozen=True)
class Collective:
    """One recorded call: ``kind`` (``all_gather``, ``all_reduce``,
    ``reduce_scatter``, ``broadcast``), ``nbytes`` the tensor the rank
    hands in (a reduce-scatter's input), ``axes`` the group's mesh axes
    and ``size`` its rank count."""
    kind: str
    nbytes: int
    axes: tuple
    size: int


class CountingComm:
    """Records each call (:class:`Collective`) and moves nothing: a
    group is the tuple of its mesh axes.  Outputs keep what they held
    (on the meta device, nothing)."""

    def __init__(self, sizes: dict):
        self.sizes = dict(sizes)
        self.calls: list[Collective] = []

    def _record(self, kind: str, x: torch.Tensor, group) -> None:
        self.calls.append(Collective(
            kind, x.numel() * x.element_size(), tuple(group),
            math.prod(self.sizes[a] for a in group)))

    def all_gather(self, parts: list, x: torch.Tensor, group) -> None:
        self._record("all_gather", x, group)

    def all_reduce(self, x: torch.Tensor, group, op: str = "sum") -> None:
        self._record("all_reduce", x, group)

    def reduce_scatter(self, out: torch.Tensor, x: torch.Tensor,
                       group) -> None:
        self._record("reduce_scatter", x, group)

    def broadcast(self, x: torch.Tensor, owner: int, group) -> None:
        self._record("broadcast", x, group)


def param_placements(cfg, mesh, work) -> dict:
    """{``params/<name>``: (:class:`Placement`, dtype)} of ``work``'s
    parameters (a model, on the meta device or not) on a mesh."""
    sizes = axis_sizes(mesh)
    shapes = {n: tuple(p.shape) for n, p in work.named_parameters()}
    ext = stack_extents(shapes)
    pspecs = param_specs(cfg, sizes, work)
    return {f"params/{n}": (placement(sizes, n, s, pspecs[n],
                                      ext[split_name(n)[0]]),
                            work.get_parameter(n).dtype)
            for n, s in shapes.items()}


def train_placements(cfg, opt_cfg, mesh, work=None) -> dict:
    """{state path: (:class:`Placement`, dtype)} of a train state on a
    mesh (anything ``specs.axis_sizes`` reads: no process group is
    needed): ``params/<name>``, ``opt/m/<name>`` and ``opt/v/<name>``
    (``.../q`` and ``.../s`` for int8 moments) and ``opt/step``, named
    as the one-device state.  ``work`` is the model on the meta device
    (built where not given)."""
    from ..models import registry
    from ..train.optimizer import init_opt_state

    sizes = axis_sizes(mesh)
    if work is None:
        work = registry.init(cfg, device="meta")
    out = param_placements(cfg, sizes, work)
    ext = stack_extents(n for n, _ in work.named_parameters())
    opt_meta = init_opt_state(opt_cfg, work)
    ospecs = opt_specs(cfg, sizes, opt_meta)
    for part in ("m", "v"):
        for n, mom in opt_meta[part].items():
            ex = ext[split_name(n)[0]]
            if isinstance(mom, dict):
                for k, a in mom.items():
                    out[f"opt/{part}/{n}/{k}"] = (placement(
                        sizes, n, a.shape, ospecs[part][n][k], ex), a.dtype)
            else:
                out[f"opt/{part}/{n}"] = (placement(
                    sizes, n, mom.shape, ospecs[part][n], ex), mom.dtype)
    out["opt/step"] = (Placement((), ()), torch.int32)
    return out


class Grid:
    """This rank's place on a ``DeviceMesh``: axis sizes, its coordinate
    on each axis, each axis's group, the joint group of the batch axes
    (``("pod", "data")`` where both are present), the world's group and
    the communicator that runs the collectives (:class:`DistComm`)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.comm = DistComm()
        self.sizes = axis_sizes(mesh)
        names = tuple(mesh.mesh_dim_names)
        self.coords = dict(zip(names, mesh.get_coordinate()))
        self.groups = {a: mesh.get_group(a) for a in names}
        self._batch_axes()
        if len(self.data_axes) == 1:
            self.data_group = self.groups[self.data_axes[0]]
        else:
            self.data_group = self._joint_group(self.data_axes)
        self.world = dist.group.WORLD

    @classmethod
    def counting(cls, sizes: dict, coords: dict) -> "Grid":
        """The grid of the rank at ``coords`` on a mesh of ``sizes`` with
        no process group: its collectives are recorded
        (:class:`CountingComm`, ``grid.comm.calls``), not run."""
        grid = cls.__new__(cls)
        grid.mesh = None
        grid.sizes, grid.coords = dict(sizes), dict(coords)
        grid.comm = CountingComm(grid.sizes)
        grid.groups = {a: (a,) for a in grid.sizes}
        grid._batch_axes()
        grid.data_group = grid.data_axes
        grid.world = tuple(grid.sizes)
        return grid

    def _batch_axes(self) -> None:
        self.data_axes = tuple(a for a in DATA if a in self.sizes)
        self.data_size = math.prod(self.sizes[a] for a in self.data_axes)
        self.data_index = _combined(self.sizes, self.coords, self.data_axes)

    def _joint_group(self, axes):
        """The group of the ranks that differ only on ``axes`` (every
        rank makes every such group, in one order)."""
        ranks = self.mesh.mesh
        names = tuple(self.mesh.mesh_dim_names)
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in keep]
        grouped = ranks.permute(*rest, *keep).reshape(
            -1, math.prod(ranks.shape[i] for i in keep))
        mine = None
        for row in grouped.tolist():
            g = dist.new_group(row)
            if dist.get_rank() in row:
                mine = g
        return mine

    # ------------------------------------------------------------------ #
    def holds(self, pl: Placement) -> bool:
        return all(self.coords[a] == c for a, c in pl.owner)

    def local_shape(self, pl: Placement) -> tuple:
        return local_shape(self.sizes, self.coords, pl)

    def shard(self, pl: Placement, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``full``, a tensor of its own."""
        if not self.holds(pl):
            return full.new_empty((0,) * full.ndim)
        x = full
        for d, entry in enumerate(pl.spec):
            axes = axes_of(entry)
            if axes:
                n = x.shape[d] // math.prod(self.sizes[a] for a in axes)
                x = x.narrow(d, _combined(self.sizes, self.coords, axes) * n,
                             n)
        return x.clone(memory_format=torch.contiguous_format)

    def gather(self, pl: Placement, local: torch.Tensor) -> torch.Tensor:
        """The full leaf from every rank's shard (a collective over the
        leaf's axes: every rank calls it)."""
        if self.holds(pl):
            x = local
            for d, entry in enumerate(pl.spec):
                for a in reversed(axes_of(entry)):
                    if self.sizes[a] > 1:
                        parts = [torch.empty_like(x)
                                 for _ in range(self.sizes[a])]
                        self.comm.all_gather(parts, x.contiguous(),
                                             self.groups[a])
                        x = torch.cat(parts, dim=d)
        else:
            x = local.new_empty(pl.shape)
        for a, c in pl.owner:
            if self.sizes[a] > 1:
                self.comm.broadcast(x, c, self.groups[a])
        return x

    def moves(self, pl: Placement) -> bool:
        """Whether gathering ``pl`` runs a collective (an axis of size > 1
        splits or owns it)."""
        axes = [a for e in pl.spec for a in axes_of(e)] + [a for a, _ in
                                                          pl.owner]
        return any(self.sizes[a] > 1 for a in axes)

    def grad_shard(self, pl: Placement, g: torch.Tensor) -> torch.Tensor:
        """This rank's fp32 shard of a leaf's gradient summed over the
        batch ranks, from ``g``, the whole gradient of this rank's rows:
        narrowed on the dims no batch axis splits, then reduce-scattered
        over the batch axis that splits a dim and all-reduced over any
        other batch axis of size > 1 (collectives over the batch groups,
        which a rank that does not hold the leaf skips with its whole
        group: owners never sit on a batch axis)."""
        batch = [a for a in self.data_axes if self.sizes[a] > 1]
        if any(a in batch for a, _ in pl.owner):
            raise NotImplementedError(f"a leaf owned on a batch axis "
                                      f"({pl.owner})")
        if not self.holds(pl):
            return g.new_empty((0,) * g.ndim, dtype=torch.float32)
        x, scatter = g, {}
        for d, entry in enumerate(pl.spec):
            axes = axes_of(entry)
            split = [a for a in axes if a in batch]
            if split:
                if axes != (split[0],) or scatter:
                    raise NotImplementedError(
                        f"a gradient split over {axes} beside a batch axis")
                scatter[split[0]] = d
            elif math.prod(self.sizes[a] for a in axes) > 1:
                n = x.shape[d] // math.prod(self.sizes[a] for a in axes)
                x = x.narrow(d, _combined(self.sizes, self.coords, axes) * n,
                             n)
        # the scattered dim first, as ``reduce_scatter`` splits dim 0
        dim = next(iter(scatter.values()), 0)
        x = x.movedim(dim, 0) if dim else x
        x = x.to(torch.float32, memory_format=torch.contiguous_format,
                 copy=True)
        for a in batch:
            if a in scatter:
                out = x.new_empty((x.shape[0] // self.sizes[a],
                                   *x.shape[1:]))
                self.comm.reduce_scatter(out, x, self.groups[a])
                x = out
        for a in batch:
            if a not in scatter:
                self.comm.all_reduce(x, self.groups[a])
        return x.movedim(0, dim).contiguous() if dim else x

    def counts_once(self, pl: Placement) -> bool:
        """Whether this rank's shard of ``pl`` is the copy of its block
        that a sum over the world counts: it holds the leaf at coordinate
        0 of every axis of size > 1 that neither splits nor owns it."""
        used = {a for e in pl.spec for a in axes_of(e)} | {
            a for a, _ in pl.owner}
        return self.holds(pl) and all(
            self.coords[a] == 0 for a in self.sizes if a not in used)

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the batch ranks, in place."""
        if self.data_size > 1:
            self.comm.all_reduce(x, self.data_group)
        return x

    # the batch split over the data ranks, as the loss and the MoE
    # dispatch read it (``models.layers.ffn.data_parallel``)
    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (no gradient) summed over the batch ranks, a new
        tensor."""
        return self.data_sum(x.detach().clone())

    def sum_with_grad(self, x: torch.Tensor) -> torch.Tensor:
        return _SumIdentityGrad.apply(x, self)

    def exclusive_prefix(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the batch ranks below this one."""
        parts = [torch.empty_like(x) for _ in range(self.data_size)]
        self.comm.all_gather(parts, x.contiguous(), self.data_group)
        out = torch.zeros_like(x)
        for p in parts[:self.data_index]:
            out = out + p
        return out

    def rows(self, batch: dict) -> dict:
        """This rank's contiguous rows of a global batch: rows
        [i·B/D, (i+1)·B/D) at batch coordinate i of D; (3, B, S) M-RoPE
        positions on axis 1."""
        n, i = self.data_size, self.data_index
        if n == 1:
            return batch
        out = {}
        for key, x in batch.items():
            ax = 1 if (key == "positions" and x.ndim == 3
                       and x.shape[0] == 3) else 0
            if x.shape[ax] % n:
                raise ValueError(f"{key}: batch {x.shape[ax]} does not "
                                 f"split over {n} data ranks")
            per = x.shape[ax] // n
            out[key] = x.narrow(ax, i * per, per)
        return out


class _SumIdentityGrad(torch.autograd.Function):
    """Sum over the batch ranks forward; the gradient passes through.
    Each rank's loss holds the summed term once and the parameter
    gradients are summed over the ranks after, so the identity is the
    term's exact gradient."""

    @staticmethod
    def forward(ctx, x, grid):
        return grid.data_sum(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def _set_param(root: nn.Module, name: str, value: nn.Parameter) -> None:
    mod, _, leaf = name.rpartition(".")
    setattr(root.get_submodule(mod) if mod else root, leaf, value)


def _meta(p: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(torch.empty(p.shape, dtype=p.dtype, device="meta"),
                        requires_grad=False)


class ShardedTrain:
    """A model's train state on a mesh: each leaf's :class:`Placement`,
    the shards, the step's layer-wise scope (:meth:`layerwise`), and
    the int8 blocks' place on each shard.  ``cfg``'s parameters are read from a model on the meta
    device; the state is ``{"params": module of local shards, "opt":
    {"m", "v", "step"} of local shards}``, named as the one-device
    state, so a checkpoint path is the same on both."""

    def __init__(self, cfg, opt_cfg, mesh, grid: Grid | None = None):
        from ..models import registry

        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.grid = Grid(mesh) if grid is None else grid
        self.placed = train_placements(cfg, opt_cfg, self.grid.sizes,
                                       registry.init(cfg, device="meta"))
        self.paths = {path: pl for path, (pl, _) in self.placed.items()}
        self.params = {path[len("params/"):]: pl
                       for path, pl in self.paths.items()
                       if path.startswith("params/")}
        self.blocks = (self._block_slices() if opt_cfg.moment_dtype == "int8"
                       else None)
        # the step's batch split, None where the data ranks are one
        self.dp = self.grid if self.grid.data_size > 1 else None

    # ------------------------------------------------------------------ #
    def _block_slices(self) -> dict:
        """Each held parameter's :class:`train.optimizer.BlockSlice`."""
        from ..train.optimizer import BlockSlice, block_of

        out = {}
        for n, pl in self.params.items():
            if not self.grid.holds(pl) or not pl.shape:
                continue
            last, entry = pl.shape[-1], pl.spec[-1]
            axes = axes_of(entry)
            parts = math.prod(self.grid.sizes[a] for a in axes)
            width = last // parts
            start = _combined(self.grid.sizes, self.grid.coords, axes) * width
            blk = block_of(pl.shape)
            aligned = width % blk == 0
            scale_split = math.prod(
                self.grid.sizes[a] for a in
                axes_of(self.paths[f"opt/m/{n}/s"].spec[-1])) > 1
            if scale_split != (aligned and parts > 1):
                raise AssertionError(f"{n}: int8 scales split {scale_split} "
                                     f"where blocks align {aligned}")
            group = None
            if not aligned:
                if len(axes) != 1:
                    raise NotImplementedError(
                        f"{n}: int8 blocks across a last axis split over "
                        f"{axes}")
                group = self.grid.groups[axes[0]]
            out[n] = BlockSlice(last=last, start=start,
                                scale_start=start // blk if scale_split
                                else 0, group=group, comm=self.grid.comm)
        return out

    def local_shape(self, path: str) -> tuple:
        return self.grid.local_shape(self.paths[path])

    def state_bytes(self, state) -> int:
        """The bytes of ``state``'s local leaves."""
        from ..train.checkpoint import flatten

        return sum(t.numel() * t.element_size() for _, t in flatten(state))

    def predicted_bytes(self) -> int:
        """The bytes of this rank's shards by the specs."""
        return shard_bytes(self.grid.sizes, self.grid.coords, self.placed)

    def _dtype(self, path: str) -> torch.dtype:
        return self.placed[path][1]

    # ------------------------------------------------------------------ #
    def shard_params(self, full: nn.Module) -> nn.Module:
        """A module of this rank's parameter shards (gradients on), named
        as ``full``'s; ``full``'s own tensors are released."""
        from ..models import registry

        local = registry.init(self.cfg, device="meta")
        for n, p in list(full.named_parameters()):
            _set_param(local, n, nn.Parameter(
                self.grid.shard(self.params[n], p.detach()),
                requires_grad=True))
            _set_param(full, n, _meta(p))
        return local

    def init_state(self, seed: int = 0, device=None) -> dict:
        """The one-device state's initial values (``registry.init(cfg,
        seed)`` on ``device``, zero moments), as this rank's shards."""
        from ..models import registry

        params = self.shard_params(registry.init(self.cfg, seed, device))
        dev = torch.device(device) if device is not None else None

        def zeros(path):
            return torch.zeros(self.local_shape(path), dtype=self._dtype(path),
                               device=dev)

        opt = {}
        for part in ("m", "v"):
            opt[part] = {}
            for n, _ in params.named_parameters():
                if self.opt_cfg.moment_dtype == "int8":
                    opt[part][n] = {k: zeros(f"opt/{part}/{n}/{k}")
                                    for k in ("q", "s")}
                else:
                    opt[part][n] = zeros(f"opt/{part}/{n}")
        opt["step"] = torch.zeros((), dtype=torch.int32, device=dev)
        return {"params": params, "opt": opt}

    @contextlib.contextmanager
    def layerwise(self, params: nn.Module, grad_accum: int = 1):
        """The scope of one step's forwards and backwards on the shards
        ``params``: yields its :class:`LayerGather`, which
        ``models.common.gather_layer`` hands each block to, and whose
        pack hooks keep no gathered weight for the backward."""
        from ..models.common import gathering

        scope = LayerGather(self, params, grad_accum)
        try:
            with gathering(scope), torch.autograd.graph.saved_tensors_hooks(
                    scope.pack, scope.unpack):
                yield scope
        finally:
            scope.whole.clear()

    def full_leaf(self, path: str, local: torch.Tensor) -> torch.Tensor:
        """A state leaf gathered to its full shape (a collective)."""
        return self.grid.gather(self.paths[path], local)

    def local_leaf(self, path: str, full: torch.Tensor) -> torch.Tensor:
        return self.grid.shard(self.paths[path], full)

    @property
    def writer(self) -> bool:
        """Rank 0 writes what every rank gathers."""
        return dist.get_rank() == 0


class _Saved:
    """A gathered weight that ops saved for the backward, kept as its
    shard: the first unpack gathers it again and the last lets it go
    (``packed`` counts the saves not yet unpacked), so a weight that a
    recurrence saves at every step is gathered once in the backward."""
    __slots__ = ("name", "shard", "packed", "full")

    def __init__(self, name, shard):
        self.name, self.shard, self.packed, self.full = name, shard, 0, None


class _View:
    """One save of a :class:`_Saved` weight: the view the op saved
    (``as_strided`` restores it)."""
    __slots__ = ("saved", "size", "stride", "offset")

    def __init__(self, saved: _Saved, t: torch.Tensor):
        self.saved = saved
        self.size, self.stride, self.offset = (t.shape, t.stride(),
                                               t.storage_offset())


class _Whole:
    """A module's tree with its parameters gathered whole: attributes
    as the module's (a ``ModuleList`` a list), a leaf left out None,
    anything else read from the module."""

    def __init__(self, mod: nn.Module):
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, name)


class _GatherLeaf(torch.autograd.Function):
    """A leaf gathered whole from this rank's shard.  Its gradient goes
    to the scope's fp32 shards (:meth:`LayerGather.take_grad`) and none
    to the shard: autograd would cast a returned gradient to the shard's
    dtype and round the fp32 sum."""

    @staticmethod
    def forward(ctx, shard, scope, name):
        ctx.scope, ctx.name = scope, name
        return scope.grid.gather(scope.sharded.params[name], shard.detach())

    @staticmethod
    def backward(ctx, g):
        ctx.scope.take_grad(ctx.name, g)
        return None, None, None


class LayerGather:
    """One mesh step's layer-wise gathering (:meth:`ShardedTrain.
    layerwise`).  :meth:`module` gathers a block's leaves whole just
    before it runs; nothing else keeps them, so a layer's weights are
    freed when its forward ends.  An op that saves a gathered weight for
    the backward saves its shard instead (:meth:`pack`) and the backward
    gathers it again (:meth:`unpack`, once for all the ops that saved
    it), as remat's recomputation does, so no gathered layer outlives
    its use with remat or without.  Each leaf's whole gradient becomes
    this rank's fp32 shard, summed over the batch ranks
    (``Grid.grad_shard``) and the microbatches; where every rank holds
    whole gradients of the step's one microbatch (a ``1xM`` mesh) each
    leaf's fp32 sum of squares is taken whole first, as one device takes
    the norm.  Every rank issues the same collectives in the same order:
    each gathered leaf's, in the forward, the recomputation and the
    backward, decided by its placement alone."""

    def __init__(self, sharded: ShardedTrain, params: nn.Module,
                 grad_accum: int):
        self.sharded, self.grid, self.accum = sharded, sharded.grid, \
            grad_accum
        self.prefix = {id(m): f"{n}." if n else ""
                       for n, m in params.named_modules()}
        self.whole_norm = self.grid.data_size == 1 and grad_accum == 1
        self.grads: dict = {}
        self.squares: dict = {}
        # id of a gathered leaf whose gather moves data → (a weak
        # reference to it, its :class:`_Saved`)
        self.whole: dict = {}

    def module(self, mod: nn.Module, only=None, skip=()) -> _Whole:
        """``mod``'s leaves gathered whole; ``only`` / ``skip``: the
        leaves (dotted names under ``mod``) to gather / to leave out."""
        return self._mirror(mod, self.prefix[id(mod)], "", only, skip)

    def _mirror(self, mod, base, rel, only, skip):
        out = _Whole(mod)
        for n, t in mod._parameters.items():
            r = rel + n
            keep = t is not None and (only is None or r in only) and \
                r not in skip
            setattr(out, n, self._leaf(base + r, t) if keep else None)
        for n, c in mod._modules.items():
            if c is None or (only is not None and not any(
                    o.startswith(f"{rel}{n}.") for o in only)):
                kid = None
            elif isinstance(c, nn.ModuleList):
                kid = [self._mirror(m, base, f"{rel}{n}.{i}.", only, skip)
                       for i, m in enumerate(c)]
            else:
                kid = self._mirror(c, base, f"{rel}{n}.", only, skip)
            setattr(out, n, kid)
        return out

    def _leaf(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        full = _GatherLeaf.apply(shard, self, name)
        if self.grid.moves(self.sharded.params[name]):
            self.whole[id(full)] = (weakref.ref(full), _Saved(name, shard))
        return full

    # saved-tensor hooks: a gathered weight is saved as its shard
    def pack(self, t: torch.Tensor):
        base = t if t._base is None else t._base
        hit = self.whole.get(id(base))
        if hit is None or hit[0]() is not base or t.dtype != base.dtype:
            return t
        hit[1].packed += 1
        return _View(hit[1], t)

    def unpack(self, view):
        if not isinstance(view, _View):
            return view
        saved = view.saved
        full = saved.full
        if full is None:
            with torch.no_grad():
                full = self.grid.gather(self.sharded.params[saved.name],
                                        saved.shard.detach())
        saved.packed -= 1
        saved.full = full if saved.packed > 0 else None
        return full.as_strided(view.size, view.stride, view.offset)

    def take_grad(self, name: str, g: torch.Tensor) -> None:
        """A gathered leaf's whole gradient, from the backward."""
        from ..train.optimizer import square_sum

        if self.whole_norm:
            if name in self.squares:
                raise AssertionError(f"{name}: gathered twice in a step")
            self.squares[name] = square_sum(g)
        piece = self.grid.grad_shard(self.sharded.params[name], g)
        have = self.grads.get(name)
        self.grads[name] = piece if have is None else have + piece

    def finish(self) -> tuple[dict, torch.Tensor]:
        """(each parameter's gradient, this rank's fp32 shard, the
        microbatches' mean, handed over: the scope keeps none; the
        global norm: one device's where :attr:`whole_norm`, else the
        shards' sums of squares summed over the world, each block
        counted once)."""
        from ..train.optimizer import norm_of, square_sum

        names = list(self.sharded.params)
        missing = [n for n in names if n not in self.grads]
        if missing:
            raise AssertionError(f"no gradient reached {missing[:4]}")
        grads, self.grads = self.grads, {}
        if self.accum > 1:
            for n in names:
                grads[n] = grads[n] / self.accum
        if self.whole_norm:
            return grads, norm_of([self.squares[n] for n in names])
        sq = torch.stack([
            square_sum(grads[n]) if self.grid.counts_once(pl)
            else grads[n].new_zeros(())
            for n, pl in self.sharded.params.items()])
        self.grid.comm.all_reduce(sq, self.grid.world)
        return grads, torch.sqrt(torch.sum(sq))
