"""Domain decomposition over a `torch.distributed` process group (port of
`tenstream_tpu/parallel/mesh.py`).

As in the reference and the JAX package, the horizontal (x, y) plane is
decomposed and z stays whole: one process per GPU, and each rank owns one
(x, y) block of the global grid (the reference's `nxproc/nyproc` layout,
`init_pprts`).  Rank r sits at mesh position (r // nyproc, r % nyproc), as
the JAX package's `reshape(nxproc, nyproc)` places devices.  The group is
NCCL on CUDA tensors and gloo on the CPU (or an explicit backend).

JAX gets its halos from GSPMD (`jnp.roll` lowers to collective permutes).
Here they are written out: every periodic shift across x or y of a
decomposed field is a halo exchange with the neighbouring ranks
(`Mesh.roll`, `Mesh.roll_many`, `Mesh.pad`), every global flip an exchange
with the mirror rank (`Mesh.flip`), and every sum that a decision of the
solver reads an `all_reduce`.  A rank that is its own neighbour (one rank
along an axis) copies locally, through the same functions.

Unstructured (ICON) meshes decompose their flat cell axis instead:
contiguous ranges in rank order (`cell_partition`, the JAX package's
`P(("x", "y"))` placement), and a `GhostExchange` built once from the
mesh's neighbour tables sends each neighbouring rank the values it reads,
the reference's PetscSF.  Every rank holds the whole topology, so every
rank knows every rank's send and receive lists without a handshake.

gloo's point-to-point calls and `all_gather` take CPU tensors only
(`torch.distributed`'s backend table), so with gloo every exchange of a
CUDA tensor is staged through host memory: a property of the backend the
caller chose.  The compute stays where the tensors are.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
    backend: Optional[str] = None,
) -> Tuple[int, int]:
    """Join (or find) the process group: the reference's `MPI_Init`.

    Without arguments the rank, world size and address come from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT);
    otherwise pass `coordinator_address` ("host:port"), `num_processes`
    and `process_id` like `mpirun` ranks.  The backend is "nccl" for
    `device="cuda"` and "gloo" for "cpu" unless given.  On CUDA the rank's
    device is set (LOCAL_RANK, else the rank modulo the visible cards).
    A no-op when the group exists already.  Returns (rank, world size)."""
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if device == "cuda" else "gloo"
        if coordinator_address is None:
            init_method = "env://"
            rank = int(os.environ["RANK"]) if process_id is None else process_id
            world = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
        else:
            init_method = f"tcp://{coordinator_address}"
            if num_processes is None or process_id is None:
                raise ValueError("init_distributed(coordinator_address) needs num_processes "
                                 "and process_id")
            rank, world = process_id, num_processes
        if device == "cuda":
            _set_rank_device(rank)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    elif device == "cuda":
        _set_rank_device(dist.get_rank())
    return dist.get_rank(), dist.get_world_size()


def _set_rank_device(rank: int) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("init_distributed(device='cuda') without a CUDA device")
    local = os.environ.get("LOCAL_RANK")
    torch.cuda.set_device(int(local) if local is not None else rank % torch.cuda.device_count())


class Mesh:
    """An (nxproc, nyproc) layout of the group's ranks with this rank's
    position, neighbours and halo exchanges.  Built by `make_mesh`."""

    def __init__(self, nxproc: int, nyproc: int):
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs a torch.distributed process group "
                               "(init_distributed)")
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        if nxproc * nyproc != self.world:
            raise ValueError(f"mesh {nxproc} x {nyproc} != world size {self.world}")
        self.nxproc, self.nyproc = nxproc, nyproc
        self.backend = dist.get_backend()
        self.stats = dict.fromkeys(("exchanges", "messages", "reductions"), 0)
        self.px, self.py = divmod(self.rank, nyproc)
        # row and column sub-groups, created in the same order on every rank:
        # the ranks along x that share this py, and those along y sharing px
        self._groups = [None, None]
        self._members = [None, None]
        for py in range(nyproc):
            ranks = [px * nyproc + py for px in range(nxproc)]
            g = dist.new_group(ranks) if nxproc > 1 else None
            if py == self.py:
                self._groups[0], self._members[0] = g, ranks
        for px in range(nxproc):
            ranks = [px * nyproc + py for py in range(nyproc)]
            g = dist.new_group(ranks) if nyproc > 1 else None
            if px == self.px:
                self._groups[1], self._members[1] = g, ranks

    def __repr__(self):
        return (f"Mesh({self.nxproc} x {self.nyproc}, rank {self.rank} at ({self.px}, "
                f"{self.py}), {self.backend})")

    # -- layout -----------------------------------------------------------
    def rank_at(self, px: int, py: int) -> int:
        return (px % self.nxproc) * self.nyproc + (py % self.nyproc)

    def neighbour(self, axis: int, step: int) -> int:
        """The rank `step` blocks away along axis (0 = x, 1 = y), periodic."""
        if axis == 0:
            return self.rank_at(self.px + step, self.py)
        return self.rank_at(self.px, self.py + step)

    def block(self, nx: int, ny: int) -> Tuple[slice, slice]:
        """This rank's (x, y) slices of a global (nx, ny) plane; the
        layout must divide the plane."""
        if nx % self.nxproc or ny % self.nyproc:
            raise ValueError(f"a {nx} x {ny} grid does not divide into {self.nxproc} x "
                             f"{self.nyproc} equal blocks")
        bx, by = nx // self.nxproc, ny // self.nyproc
        return (slice(self.px * bx, (self.px + 1) * bx), slice(self.py * by, (self.py + 1) * by))

    def global_shape(self, nx_local: int, ny_local: int) -> Tuple[int, int]:
        return nx_local * self.nxproc, ny_local * self.nyproc

    # -- communication ----------------------------------------------------
    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """What goes to the backend: gloo takes CPU tensors, NCCL CUDA
        tensors (a host scalar goes to the rank's card), and bool goes as
        uint8."""
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        if self.backend == "gloo" and t.device.type != "cpu":
            t = t.cpu()
        elif self.backend == "nccl" and t.device.type == "cpu":
            t = t.to(torch.device("cuda", torch.cuda.current_device()))
        return t.contiguous()

    @staticmethod
    def _back(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(device=like.device, dtype=like.dtype)

    def reset_stats(self) -> None:
        """Zero the counts of exchanges (one batch of point-to-point
        messages, or of local copies on a rank that is its own neighbour),
        of the messages to other ranks in them, and of all-reduces."""
        for k in self.stats:
            self.stats[k] = 0

    def sendrecv(self, items) -> List[torch.Tensor]:
        """items: (tensor, dst rank, src rank).  Sends each tensor to its
        dst and receives a tensor of its shape from its src: item k of this
        rank goes to item k of its dst, so every rank passes the same list
        of shapes.  One `exchange`: one message per peer and direction."""
        out: List[Optional[torch.Tensor]] = [None] * len(items)
        moved = []
        for q, (t, dst, src) in enumerate(items):
            if dst == self.rank and src == self.rank:
                out[q] = t.clone()
            else:
                moved.append(q)
        if not moved:
            self.stats["exchanges"] += 1
            return out
        like = items[moved[0]][0]
        if any(items[q][0].dtype != like.dtype for q in moved):
            raise ValueError("Mesh.sendrecv exchanges tensors of one dtype per call")
        by_dst, by_src = {}, {}
        for q in moved:
            by_dst.setdefault(items[q][1], []).append(q)
            by_src.setdefault(items[q][2], []).append(q)
        sends = [(torch.cat([items[q][0].reshape(-1) for q in qs]), dst)
                 for dst, qs in by_dst.items()]
        recvs = [((sum(items[q][0].numel() for q in qs),), src) for src, qs in by_src.items()]
        for flat, qs in zip(self.exchange(sends, recvs, like), by_src.values()):
            for q, g in zip(qs, flat.split([items[q][0].numel() for q in qs])):
                out[q] = g.view(items[q][0].shape)
        return out

    def exchange(self, sends, recvs, like: torch.Tensor) -> List[torch.Tensor]:
        """One batch of messages of any shapes: sends [(tensor, dst rank)],
        recvs [(shape, src rank)] with tensors of `like`'s dtype and device
        back, in the order of `recvs`.  At most one message per direction
        and peer; every rank must post the counterpart of each message.
        Staged through one buffer each way, as `sendrecv`."""
        self.stats["exchanges"] += 1
        if not sends and not recvs:
            return []
        sizes = [int(np.prod(shape)) for shape, _ in recvs]
        sbuf = self._staged(torch.cat([t.reshape(-1) for t, _ in sends]) if sends else
                            like.new_empty(0))
        rbuf = sbuf.new_empty(sum(sizes))
        ops, start = [], 0
        for t, dst in sends:
            ops.append(dist.P2POp(dist.isend, sbuf.narrow(0, start, t.numel()), dst))
            start += t.numel()
        start = 0
        for n, (_, src) in zip(sizes, recvs):
            ops.append(dist.P2POp(dist.irecv, rbuf.narrow(0, start, n), src))
            start += n
        self.stats["messages"] += len(sends)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        got = self._back(rbuf, like).split(sizes)
        return [g.view(shape) for g, (shape, _) in zip(got, recvs)]

    @staticmethod
    def _dim_axis(v: torch.Tensor, dim: int, axis: Optional[int]) -> Tuple[int, int]:
        d = dim if dim >= 0 else v.dim() + dim
        if axis is None:
            if d == v.dim() - 2:
                axis = 0
            elif d == v.dim() - 1:
                axis = 1
            else:
                raise ValueError("Mesh: name the axis of a dim that is not one of the last two")
        return d, axis

    def roll(self, v: torch.Tensor, shift: int, dim: int, axis: Optional[int] = None):
        """`torch.roll(v, shift, dim)` of the global field whose block v is,
        for shift +1 or -1 along x or y (axis 0 / 1; the last two dims are
        x and y unless `axis` says otherwise): one plane from one
        neighbour."""
        return self.roll_many([(v, shift, dim, axis)])[0]

    def roll_many(self, items) -> List[torch.Tensor]:
        """`roll` of each (v, shift, dim[, axis]) item, every plane in one
        exchange; along an axis of one rank, a local `torch.roll`."""
        out: List[Optional[torch.Tensor]] = [None] * len(items)
        planes, cut = [], []
        for k, it in enumerate(items):
            v, shift, dim = it[:3]
            d, axis = self._dim_axis(v, dim, it[3] if len(it) > 3 else None)
            if shift not in (1, -1):
                raise ValueError(f"Mesh.roll shifts by +1 or -1, not {shift}")
            if (self.nxproc, self.nyproc)[axis] == 1:
                out[k] = torch.roll(v, shift, dims=d)
                continue
            n = v.shape[d]
            edge = n - 1 if shift == 1 else 0
            planes.append((v.narrow(d, edge, 1), self.neighbour(axis, shift),
                           self.neighbour(axis, -shift)))
            cut.append((k, v, d, n, shift))
        if not planes:
            self.stats["exchanges"] += 1
            return out
        for recv, (k, v, d, n, shift) in zip(self.sendrecv(planes), cut):
            out[k] = (torch.cat([recv, v.narrow(d, 0, n - 1)], dim=d) if shift == 1 else
                      torch.cat([v.narrow(d, 1, n - 1), recv], dim=d))
        return out

    def pad(self, v: torch.Tensor) -> torch.Tensor:
        """v (..., nx, ny) with a one-cell ring from the neighbours:
        (..., nx + 2, ny + 2), x first, then y over the x-padded block, so
        the corners come from the diagonal neighbours."""
        nx, ny = v.shape[-2:]
        out = v.new_empty(tuple(v.shape[:-2]) + (nx + 2, ny + 2))
        out[..., 1:-1, 1:-1] = v
        right, left = self.neighbour(0, 1), self.neighbour(0, -1)
        out[..., :1, 1:-1], out[..., -1:, 1:-1] = self.sendrecv([
            (v[..., -1:, :], right, left), (v[..., :1, :], left, right)])
        up, down = self.neighbour(1, 1), self.neighbour(1, -1)
        out[..., :, :1], out[..., :, -1:] = self.sendrecv([
            (out[..., :, -2:-1], up, down), (out[..., :, 1:2], down, up)])
        return out

    def flip(self, v: torch.Tensor, dim: int, axis: Optional[int] = None) -> torch.Tensor:
        """`torch.flip` of the global field along x or y: the block of the
        mirror rank, reversed."""
        d, axis = self._dim_axis(v, dim, axis)
        if axis == 0:
            mirror = self.rank_at(self.nxproc - 1 - self.px, self.py)
        else:
            mirror = self.rank_at(self.px, self.nyproc - 1 - self.py)
        got = self.sendrecv([(v, mirror, mirror)])[0]
        return torch.flip(got, dims=(d,))

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: t reduced over every rank ("sum", "max", "min")."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
        self.stats["reductions"] += 1
        st = self._staged(t)
        st = st.clone() if st.data_ptr() == t.data_ptr() else st
        dist.all_reduce(st, op=red)
        return self._back(st, t)

    def all_gather_axis(self, t: torch.Tensor, axis: int) -> List[torch.Tensor]:
        """t of every rank along the axis through this one, in block order."""
        group = self._groups[axis]
        if group is None:
            return [t]
        st = self._staged(t)
        outs = [torch.empty_like(st) for _ in self._members[axis]]
        dist.all_gather(outs, st, group=group)
        return [self._back(o, t) for o in outs]

    def all_gather_blocks(self, t: torch.Tensor) -> torch.Tensor:
        """The global field (..., nxproc * nx, nyproc * ny) from every
        rank's block (..., nx, ny), on every rank."""
        if self.world == 1:
            return t
        st = self._staged(t)
        outs = [torch.empty_like(st) for _ in range(self.world)]
        dist.all_gather(outs, st)
        rows = [torch.cat(outs[px * self.nyproc:(px + 1) * self.nyproc], dim=-1)
                for px in range(self.nxproc)]
        return self._back(torch.cat(rows, dim=-2), t)

    def all_gather_cells(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """The global field from every rank's range of a flat cell axis,
        on every rank."""
        if self.world == 1:
            return t
        st = self._staged(t)
        outs = [torch.empty_like(st) for _ in range(self.world)]
        dist.all_gather(outs, st)
        return self._back(torch.cat(outs, dim=axis), t)

    def cell_range(self, nc: int) -> Tuple[int, int]:
        """This rank's range [lo, hi) of a flat cell axis of nc cells."""
        return cell_partition(nc, self.world)[self.rank]

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        st = self._staged(t)
        st = st.clone() if st.data_ptr() == t.data_ptr() else st
        dist.broadcast(st, src)
        return self._back(st, t)


def make_mesh(nxproc: Optional[int] = None, nyproc: Optional[int] = None) -> Mesh:
    """The (x, y) layout of the process group's ranks.  Without
    nxproc/nyproc the world size is factored as square-ish as possible
    (the JAX package's rule, after the reference's
    `domain_decompose_2d_petsc`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed process group "
                           "(init_distributed)")
    n = dist.get_world_size()
    if nxproc is None or nyproc is None:
        nxproc = int(np.floor(np.sqrt(n)))
        while n % nxproc != 0:
            nxproc -= 1
        nyproc = n // nxproc
    return Mesh(nxproc, nyproc)


def check_mesh(mesh: Mesh, device) -> None:
    """What a solver's `set_mesh` asks of its mesh: a process group that is
    up, with a backend that takes tensors on `device` (NCCL or gloo on the
    card, gloo on the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("set_mesh needs a torch.distributed process group "
                           "(parallel.mesh.init_distributed)")
    kind = torch.device(device).type
    ok = ("nccl", "gloo") if kind == "cuda" else ("gloo",)
    if mesh.backend not in ok:
        raise ValueError(f"a solver on {kind} takes a {' or '.join(ok)} group, not {mesh.backend}")


def cell_partition(nc: int, world: int) -> List[Tuple[int, int]]:
    """Every rank's range [lo, hi) of a flat cell axis of nc cells:
    contiguous equal ranges in rank order, over every mesh axis (the JAX
    package's `P(..., ("x", "y"), ...)`).  As JAX's `device_put` with that
    placement, a world size that does not divide nc raises."""
    if nc % world:
        raise ValueError(f"{nc} cells do not divide into {world} equal ranges (one per rank)")
    n = nc // world
    return [(r * n, (r + 1) * n) for r in range(world)]


class GhostExchange:
    """The values of other ranks' cells that this rank's cells read, the
    reference's PetscSF.  `index` (nc, k) holds, for every global cell, k
    flat indices into a global (nc * unit,) field (cell c owns entries
    c * unit .. c * unit + unit - 1); entries where `valid` is False are
    read as index 0 and must be masked by the caller.  Built once: every
    rank holds the whole topology, so it computes every rank's send and
    receive lists itself.

    `exchange(flat)` takes this rank's (..., nloc * unit) values and
    returns them followed by its ghosts; `index_local` (nloc, k) indexes
    that extended field.  On one rank there are no ghosts and
    `index_local` is `index`."""

    def __init__(self, mesh: "Mesh", index: np.ndarray, valid: np.ndarray, unit: int, device):
        index = np.asarray(index, np.int64)
        valid = np.asarray(valid, bool)
        nc = index.shape[0]
        parts = cell_partition(nc, mesh.world)
        span = nc // mesh.world
        self.mesh = mesh
        lo, hi = parts[mesh.rank]
        self.nloc = hi - lo

        def remote(r):
            """The sorted global indices rank r reads from other ranks."""
            a, b = parts[r]
            idx = index[a:b][valid[a:b]]
            cell = idx // unit
            return np.unique(idx[(cell < a) | (cell >= b)])

        ghosts = remote(mesh.rank)
        owners = ghosts // unit // span
        # ghosts are sorted by index, so each owner's are one run, owners ascending
        self.recvs = [(int(q), int((owners == q).sum())) for q in np.unique(owners)]
        self.sends = []
        for q in range(mesh.world):
            if q == mesh.rank:
                continue
            theirs = remote(q)
            mine = theirs[(theirs // unit >= lo) & (theirs // unit < hi)]
            if mine.size:
                self.sends.append((q, torch.as_tensor(mine - lo * unit, device=device)))
        loc = index[lo:hi]
        own = (loc // unit >= lo) & (loc // unit < hi)
        out = np.where(own, loc - lo * unit, 0)
        far = ~own & valid[lo:hi]
        out[far] = self.nloc * unit + np.searchsorted(ghosts, loc[far])
        self.n_ghosts = int(ghosts.size)
        self.index_local = torch.as_tensor(out, device=device)

    def exchange(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's values (..., nloc * unit) followed by its ghosts
        (..., n_ghosts), in one exchange with the neighbouring ranks."""
        if self.mesh.world == 1:
            self.mesh.stats["exchanges"] += 1
            return flat
        lead = tuple(flat.shape[:-1])
        got = self.mesh.exchange([(flat.index_select(-1, i), q) for q, i in self.sends],
                                 [(lead + (n,), q) for q, n in self.recvs], flat)
        return torch.cat([flat] + got, dim=-1)

    def gather(self, flat: torch.Tensor) -> torch.Tensor:
        """out[..., c, j] = the global field at index[c, j] for this rank's
        cells: (..., nloc * unit) -> (..., nloc, k)."""
        ext = self.exchange(flat)
        got = torch.index_select(ext, -1, self.index_local.reshape(-1))
        return got.reshape(tuple(flat.shape[:-1]) + tuple(self.index_local.shape))


def _block_index(mesh: Mesh, shape: Sequence[int], ndim_leading: Optional[int],
                 cell_axis: Optional[int] = None):
    """The tuple of slices that selects this rank's block of a global
    array: whole leading dims, then the (x, y) block; or, with
    `cell_axis`, this rank's range of that flat cell axis."""
    if cell_axis is not None:
        ax = cell_axis % len(shape)
        lo, hi = mesh.cell_range(shape[ax])
        return tuple(slice(None) for _ in range(ax)) + (slice(lo, hi),)
    lead = len(shape) - 2 if ndim_leading is None else ndim_leading
    if lead != len(shape) - 2:
        raise ValueError("fields have their (x, y) dims last")
    sx, sy = mesh.block(shape[-2], shape[-1])
    return tuple(slice(None) for _ in range(lead)) + (sx, sy)


def shard_fields(mesh: Mesh, *arrays, ndim_leading=None, cell_axis: Optional[int] = None):
    """This rank's blocks of full arrays (numpy or tensors) whose last two
    dims are (nx, ny), or, with `cell_axis`, their ranges of that flat
    cell axis (an ICON mesh's), as contiguous tensors where each array is;
    None passes through."""
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        blk = a[_block_index(mesh, tuple(a.shape), ndim_leading, cell_axis)]
        t = torch.as_tensor(np.ascontiguousarray(blk) if isinstance(blk, np.ndarray) else blk)
        out.append(t.contiguous())
    return tuple(out)


def scatter_global(
    mesh: Mesh,
    data: Union[np.ndarray, Callable],
    global_shape: Optional[Tuple[int, ...]] = None,
    dtype=None,
    ndim_leading: Optional[int] = None,
    cell_axis: Optional[int] = None,
) -> torch.Tensor:
    """This rank's block of an (x, y)-decomposed global field, or its
    range of the flat cell axis `cell_axis`, the reference's host-model
    input path (each MPI rank owns its subdomain's optical properties).

    `data` is a callable `data(index: tuple[slice, ...]) -> array` that
    returns the block of the GLOBAL array that `index` selects (it is asked
    for this rank's block only: nothing global is made), or a full global
    array that every rank slices.  `global_shape` and `dtype` are required
    with a callable."""
    if callable(data):
        if global_shape is None or dtype is None:
            raise ValueError("scatter_global(callable) needs global_shape and dtype")
        index = _block_index(mesh, tuple(global_shape), ndim_leading, cell_axis)
        blk = np.asarray(data(index), dtype)
    else:
        arr = np.asarray(data)
        blk = arr[_block_index(mesh, arr.shape, ndim_leading, cell_axis)]
    return torch.as_tensor(np.ascontiguousarray(blk))


def gather_to_host(x, mesh: Optional[Mesh] = None, cell_axis: Optional[int] = None) -> np.ndarray:
    """The global field as a numpy array on EVERY rank (the reference's
    `pprts_get_result_toZero`, here on all ranks): an all-gather of the
    blocks, or of the ranges of the flat cell axis `cell_axis`; without a
    mesh, x itself."""
    if mesh is None:
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    x = torch.as_tensor(x)
    if cell_axis is not None:
        return mesh.all_gather_cells(x, cell_axis % x.dim()).detach().cpu().numpy()
    return mesh.all_gather_blocks(x).detach().cpu().numpy()
