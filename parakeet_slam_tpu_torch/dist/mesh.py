"""Process mesh, its sub-groups, collectives and row sharding (port of
`parakeet_slam_tpu.dist.mesh`).

The reference lays its devices out as a 2-D mesh (`dcn` = map axis, `ici` =
particle axis) and runs one program over all of them under `shard_map`,
whose arrays are global. Here every rank is a process of one
`torch.distributed` group and holds only its own rows, so every read across
ranks is an explicit collective of this module:

- the particle axis (`ici`): particles are independent except for
  resampling; each rank holds P / S_ici of them;
- the map axis (`dcn`): point blocks of the distributed BA; the particle
  state is replicated along it.

`make_mesh(map_axis)` lays the first n ranks of the default group out as
[map_axis, n // map_axis]: rank r sits at (dcn = r // S_ici, ici = r % S_ici).
It makes the sub-groups of each axis with `dist.new_group`: the `ici`
groups share a `dcn` index, the `dcn` groups share an `ici` index. Every
rank of the default group must call `make_mesh` with the same arguments, in
the same order as its other collectives (`new_group` is itself collective).
With no process group initialized the mesh is 1 x 1 and every collective is
the identity, with no launch.

NCCL has no `bool` reduction and wants one message rather than one per
leaf: payloads of several leaves travel as one flat byte buffer
(`pack_bytes` / `unpack_bytes`).

With the program's tracer on, the counter `dist.gather_bytes` adds the
bytes each all-gather delivers to this rank (the gathered tensor, every
rank's rows; inside a captured program once a replay, `utils/trace.py`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as tdist

from parakeet_slam_tpu_torch.utils import trace

PARTICLE_AXIS = "ici"
MAP_AXIS = "dcn"
BOTH_AXES = (MAP_AXIS, PARTICLE_AXIS)


def is_distributed() -> bool:
    return tdist.is_available() and tdist.is_initialized()


@dataclass(frozen=True, eq=False)
class Mesh:
    """A [dcn, ici] layout of global ranks and this rank's place in it.

    `shape` maps each axis to its size; `ranks` lists the mesh's global
    ranks row-major; `rank` is this process's global rank, None when it is
    not in the mesh (a mesh carved from part of the group). `groups` holds
    this rank's process group along `dcn`, along `ici` and over the whole
    mesh (`all`), each None when no process group is initialized.
    `programs` holds the captured programs that run over this mesh's groups
    (the ring match's, the distributed BA's), by key: they live and die
    with the mesh, so that no graph outlives the communicators it holds
    (drop the mesh and collect it before the process group is destroyed)."""

    shape: dict
    ranks: tuple
    rank: int | None
    groups: dict
    programs: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def is_member(self) -> bool:
        return self.rank is not None

    def _coords(self):
        i = self.ranks.index(self.rank)
        S = self.shape[PARTICLE_AXIS]
        return {MAP_AXIS: i // S, PARTICLE_AXIS: i % S}

    def axis_size(self, axis) -> int:
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= self.shape[a]
            return n
        return self.shape[axis]

    def axis_index(self, axis) -> int:
        """This rank's index along `axis` (both axes: row-major)."""
        c = self._coords()
        if isinstance(axis, tuple):
            return c[MAP_AXIS] * self.shape[PARTICLE_AXIS] + c[PARTICLE_AXIS]
        return c[axis]

    def axis_group(self, axis):
        return self.groups["all" if isinstance(axis, tuple) else axis]

    def axis_ranks(self, axis) -> list[int]:
        """Global ranks of this rank's line along `axis`, in axis order."""
        c = self._coords()
        S, D = self.shape[PARTICLE_AXIS], self.shape[MAP_AXIS]
        if isinstance(axis, tuple):
            return list(self.ranks)
        if axis == PARTICLE_AXIS:
            return [self.ranks[c[MAP_AXIS] * S + i] for i in range(S)]
        return [self.ranks[d * S + c[PARTICLE_AXIS]] for d in range(D)]


def make_mesh(n_devices: int | None = None, map_axis: int = 1) -> Mesh:
    """A (dcn = map_axis, ici = n / map_axis) mesh over the first n ranks of
    the default process group (all of them by default; n is cut to the world
    size, as the reference cuts `jax.devices()`). Collective: every rank
    calls it with the same arguments."""
    if not is_distributed():
        world, me = 1, 0
    else:
        world, me = tdist.get_world_size(), tdist.get_rank()
    n = world if n_devices is None else min(n_devices, world)
    if n < 1 or n % map_axis != 0:
        raise ValueError(f"{n} ranks not divisible by map_axis={map_axis}")
    S = n // map_axis
    ranks = tuple(range(n))
    rank = me if me < n else None
    if not is_distributed():
        groups = {MAP_AXIS: None, PARTICLE_AXIS: None, "all": None}
    else:
        groups = {}
        # every rank creates every group, in one order
        for d in range(map_axis):
            g = tdist.new_group([d * S + i for i in range(S)])
            if rank is not None and rank // S == d:
                groups[PARTICLE_AXIS] = g
        for i in range(S):
            g = tdist.new_group([d * S + i for d in range(map_axis)])
            if rank is not None and rank % S == i:
                groups[MAP_AXIS] = g
        g = tdist.group.WORLD if n == world else tdist.new_group(list(ranks))
        if rank is not None:
            groups["all"] = g
    return Mesh(shape={MAP_AXIS: map_axis, PARTICLE_AXIS: S}, ranks=ranks, rank=rank,
                groups=groups)


# -- row sharding (the reference's NamedSharding specs, rank-local) ---------


@dataclass(frozen=True)
class RowSharding:
    """This rank's block of rows of an array sharded along `axis` of `mesh`
    (None: replicated, every row)."""

    mesh: Mesh
    axis: str | None

    def rows(self, n: int) -> slice:
        if self.axis is None:
            return slice(None)
        S = self.mesh.axis_size(self.axis)
        if n % S:
            raise ValueError(f"{n} rows not divisible by the {self.axis} axis size {S}")
        i = self.mesh.axis_index(self.axis)
        return slice(i * (n // S), (i + 1) * (n // S))

    def take(self, a: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global array (a copy)."""
        return a[self.rows(a.shape[0])].clone()


def particle_sharding(mesh: Mesh) -> RowSharding:
    """Leading (particle) axis sharded over `ici`; replicated along `dcn`."""
    return RowSharding(mesh, PARTICLE_AXIS)


def replicated(mesh: Mesh) -> RowSharding:
    return RowSharding(mesh, None)


def landmark_block_sharding(mesh: Mesh) -> RowSharding:
    """A landmark-major array's leading axis sharded over `dcn` (the point
    blocks of the distributed BA)."""
    return RowSharding(mesh, MAP_AXIS)


def shard_particle_state(state, mesh: Mesh):
    """This rank's rows of a global ParticleState (every leaf leads with P)."""
    sh = particle_sharding(mesh)
    return state.replace(**{f.name: sh.take(getattr(state, f.name))
                            for f in dataclasses.fields(state)})


# -- byte packing ------------------------------------------------------------


def pack_bytes(tensors) -> tuple[torch.Tensor, list]:
    """One flat uint8 buffer holding `tensors` back to back, each segment
    starting at a multiple of 16 bytes, and the layout `unpack_bytes` needs."""
    layout, off = [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        layout.append((off, nb, t.dtype, tuple(t.shape)))
        off += -(-nb // 16) * 16
    dev = tensors[0].device
    buf = torch.empty(off, dtype=torch.uint8, device=dev)
    for t, (o, nb, _, _) in zip(tensors, layout):
        if nb:
            buf[o:o + nb] = t.contiguous().reshape(-1).view(torch.uint8)
    return buf, layout


def unpack_bytes(buf: torch.Tensor, layout) -> list[torch.Tensor]:
    """The tensors of a `pack_bytes` buffer (or of another rank's buffer of
    the same layout), as views into it."""
    out = []
    for o, nb, dtype, shape in layout:
        seg = buf[o:o + nb]
        out.append(seg.view(dtype).reshape(shape) if nb else
                   torch.empty(shape, dtype=dtype, device=buf.device))
    return out


# -- collectives (identity on a mesh with no process group) ------------------


def all_gather_rows(t: torch.Tensor, mesh: Mesh, axis=PARTICLE_AXIS) -> torch.Tensor:
    """The rows of every rank along `axis`, concatenated in axis order."""
    g = mesh.axis_group(axis)
    if g is None:
        return t
    S = mesh.axis_size(axis)
    flat = t.contiguous()
    if flat.dtype == torch.bool:
        return all_gather_rows(flat.view(torch.uint8), mesh, axis).view(torch.bool)
    out = torch.empty((S * flat.shape[0],) + tuple(flat.shape[1:]), dtype=flat.dtype,
                      device=flat.device)
    gather = getattr(tdist, "all_gather_single", None) or tdist.all_gather_into_tensor
    gather(out, flat, group=g)
    trace.count("dist.gather_bytes", out.numel() * out.element_size())
    return out


def all_gather_packed(tensors, mesh: Mesh, axis=PARTICLE_AXIS) -> list[torch.Tensor]:
    """`all_gather_rows` of several tensors with equal leading sizes, in one
    message: every leaf's rows of all ranks, concatenated in axis order."""
    if mesh.axis_group(axis) is None:
        return list(tensors)
    S = mesh.axis_size(axis)
    rows = tensors[0].shape[0]
    buf, layout = pack_bytes(tensors)
    got = all_gather_rows(buf, mesh, axis).reshape(S, -1)
    blocks = [unpack_bytes(got[s], layout) for s in range(S)]
    return [torch.cat([b[k] for b in blocks]) if rows else tensors[k]
            for k in range(len(tensors))]


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """The sum of `t` over the ranks along `axis` (a tuple: both axes), the
    same bits on every rank."""
    g = mesh.axis_group(axis)
    if g is None:
        return t
    out = t.clone()
    tdist.all_reduce(out, group=g)
    return out


def broadcast_packed(tensors, mesh: Mesh, axis, src_index: int) -> list[torch.Tensor]:
    """The tensors of the rank at `src_index` along `axis`, on every rank
    of that line (shapes and dtypes equal on all of them), in one message."""
    g = mesh.axis_group(axis)
    if g is None:
        return list(tensors)
    buf, layout = pack_bytes(tensors)
    tdist.broadcast(buf, src=mesh.axis_ranks(axis)[src_index], group=g)
    return unpack_bytes(buf, layout)


def barrier(mesh: Mesh) -> None:
    g = mesh.axis_group(BOTH_AXES)
    if g is not None:
        tdist.barrier(group=g)
