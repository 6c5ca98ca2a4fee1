"""Meshes of ranks (port of ``repro/launch/mesh.py``).

The reference's meshes are JAX device grids. The port's tensor-parallel
serving runs one process per rank over ``torch.distributed``, so a mesh
here is a named grid of ranks: ``shape`` (axis name -> size, in order),
``axis_names`` and ``size``, what the spec rules (``sharding.specs``)
read. A local mesh also holds this rank's place in the grid (``rank``,
``coords``) and the process groups of its axes (``groups``).

Single pod : (16, 16)      axes ("data", "model")          = 256 chips
Multi-pod  : (2, 16, 16)   axes ("pod", "data", "model")   = 512 chips

``make_production_mesh`` returns those shapes with no ranks behind them,
for the spec rules and the dry-run's reckoning (``launch.dryrun``).
``make_local_mesh`` builds a ("data", "model") mesh over the ranks that
exist: an initialised process group, or this process alone;
``make_named_mesh`` lays those ranks out as any named shape (the split
serve step's ``{"pod": 2}``).

Backends (``init_rank``): NCCL where every rank has a card of its own;
gloo on the CPU and where ranks share a card, since NCCL will not put two
ranks of one communicator on one device. Tensor-parallel serving
(``sharding.serving``) hands its CUDA tensors to gloo's ``all_reduce``
and ``broadcast``, which stage them through the host. ``Mesh.ppermute`` (the
reference's ``jax.lax.ppermute``, the pod link of the split serve step)
sends and receives point to point. ``Mesh.all_reduce``,
``Mesh.all_gather`` and ``Mesh.reduce_scatter`` are the collectives of
the sharded train step (``sharding.training``: FSDP gathers a parameter
over "data" and scatters its gradient back, data parallelism sums
gradients, tensor parallelism sums over "model") over a named axis or
axes; each counts its calls and result bytes by kind, under the label its
caller gives (``collectives``), and the seconds it took. Under gloo every
one of them stages a CUDA tensor through the host itself (a copy to the
host, the collective, a copy back), which synchronises with the card.
Every rank builds the process groups of both axes of a local mesh, in the
same order. Rendezvous is a ``FileStore`` (no port to pick or collide
on), and every collective has a timeout, so ranks that drift apart fail
instead of hanging. ``spawn_ranks`` starts one process a rank and fails
them all when one fails or the time runs out.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# seconds a rank waits in a collective (and at rendezvous) before failing
COLLECTIVE_TIMEOUT_S = 120


class Mesh:
    """A named grid of ranks. ``rank``/``coords``/``groups`` are set for a
    local mesh (this process's place; each axis' process group, None
    where that axis is the whole world or one rank). ``model_group`` is
    ``groups["model"]``."""

    def __init__(self, shape: Dict[str, int], rank: Optional[int] = None,
                 groups: Optional[Dict[str, Any]] = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.rank = rank
        self.groups = dict(groups or {})
        self.coords: Optional[Dict[str, int]] = None
        self.sent_bytes = 0
        self.received_bytes = 0
        self.reset_counts()
        if rank is not None:
            coords, rest = {}, rank
            for name in reversed(self.axis_names):
                coords[name] = rest % self.shape[name]
                rest //= self.shape[name]
            self.coords = {name: coords[name] for name in self.axis_names}

    def reset_counts(self) -> None:
        """Zero ``collectives`` (label -> kind -> {"count", "bytes"}) and
        ``collective_s``."""
        self.collectives: Dict[str, Dict[str, Dict[str, int]]] = {}
        self.collective_s = 0.0

    @property
    def model_group(self) -> Any:
        return self.groups.get("model")

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def peer(self, axis: str, index: int) -> int:
        """The rank at this rank's coordinates with ``axis`` at ``index``."""
        rank = 0
        for name in self.axis_names:
            rank = rank * self.shape[name] + (
                index if name == axis else self.coords[name])
        return rank

    def ppermute(self, tensor: torch.Tensor, axis: str,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``jax.lax.ppermute`` over this local mesh's ranks: along
        ``axis``, the rank at index ``src`` sends ``tensor`` to the rank
        at ``dst`` for every pair (src, dst) of ``perm`` (the other
        coordinates fixed), and each rank returns what it received; a
        rank that no pair names as a destination returns zeros of
        ``tensor``'s shape and dtype. Every rank of the axis must call it
        with the same ``perm``. Counts ``sent_bytes`` / ``received_bytes``."""
        if self.coords is None:
            raise ValueError("ppermute needs a local mesh, not an abstract "
                             "one")
        srcs, dsts = [a for a, _ in perm], [b for _, b in perm]
        n = self.shape[axis]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or \
                not all(0 <= i < n for i in srcs + dsts):
            raise ValueError(f"ppermute: {list(perm)} is not a permutation "
                             f"of indices of an axis of {n}")
        i = self.coords[axis]
        out = torch.zeros_like(tensor)
        staged = tensor.is_cuda and dist.get_backend() == "gloo"
        send = (tensor.cpu() if staged else tensor).contiguous()
        recv = torch.empty_like(send)
        works, received = [], False
        for src, dst in perm:
            if src == i and dst == i:
                out.copy_(tensor)
            elif src == i:
                works.append(dist.isend(send, self.peer(axis, dst)))
                self.sent_bytes += send.nbytes
            elif dst == i:
                works.append(dist.irecv(recv, self.peer(axis, src)))
                self.received_bytes += recv.nbytes
                received = True
        for w in works:
            w.wait(datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        if received:
            out.copy_(recv)
        return out

    # ---- the collectives of the sharded train step ----

    def _group(self, axes: Sequence[str]) -> Tuple[Any, int]:
        """The process group over ``axes`` (those of size > 1) and its
        size: the world where they are every axis of size > 1, the one
        axis' group where it is one, else an error."""
        live = [a for a in axes if self.shape.get(a, 1) > 1]
        n = 1
        for a in live:
            n *= self.shape[a]
        if n == 1 or n == self.size:
            return None, n
        if len(live) == 1:
            return self.groups[live[0]], n
        raise ValueError(f"no process group over {tuple(live)} of mesh "
                         f"{self.shape}")

    def _count(self, label: str, kind: str, nbytes: int) -> None:
        entry = self.collectives.setdefault(label, {}).setdefault(
            kind, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += int(nbytes)

    def _run(self, label, kind, t, out, call):
        """``call(src, dst)`` on host copies under gloo for a CUDA
        tensor, waited on with the module's timeout; counts ``out``'s
        bytes and the seconds."""
        t0 = time.perf_counter()
        staged = t.is_cuda and dist.get_backend() == "gloo"
        src = (t.cpu() if staged else t).contiguous()
        dst = torch.empty(out, dtype=t.dtype,
                          device="cpu" if staged else t.device)
        call(src, dst).wait(datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        res = dst.to(t.device) if staged else dst
        self.collective_s += time.perf_counter() - t0
        self._count(label, kind, res.nbytes)
        return res

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str],
                   label: str = "") -> torch.Tensor:
        """``t`` summed over the ranks that share this rank's coordinates
        on every axis but ``axes``; a new tensor, ``t`` untouched. Over
        one rank it returns ``t`` and counts nothing."""
        group, n = self._group(axes)
        if n == 1:
            return t

        def call(src, dst):
            dst.copy_(src)
            return dist.all_reduce(dst, group=group, async_op=True)
        return self._run(label, "all-reduce", t, t.shape, call)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int,
                   label: str = "") -> torch.Tensor:
        """The blocks of ``axis``' ranks concatenated along ``dim`` in
        the axis' order (this rank's ``t`` among them). Over one rank it
        returns ``t`` and counts nothing."""
        group, n = self._group((axis,))
        if n == 1:
            return t
        moved = t.movedim(dim, 0)
        shape = (n * moved.shape[0], *moved.shape[1:])

        def call(src, dst):
            return dist.all_gather_into_tensor(dst, src, group=group,
                                               async_op=True)
        return self._run(label, "all-gather", moved, shape,
                         call).movedim(0, dim).contiguous()

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int,
                       label: str = "") -> torch.Tensor:
        """``t`` summed over ``axis``' ranks, cut along ``dim`` into equal
        parts, this rank's part (its index on the axis). Over one rank it
        returns ``t`` and counts nothing."""
        group, n = self._group((axis,))
        if n == 1:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dimension {dim} of "
                             f"{tuple(t.shape)} does not divide by {n}")
        moved = t.movedim(dim, 0)
        shape = (moved.shape[0] // n, *moved.shape[1:])

        def call(src, dst):
            return dist.reduce_scatter_tensor(dst, src, group=group,
                                              async_op=True)
        return self._run(label, "reduce-scatter", moved, shape,
                         call).movedim(0, dim).contiguous()


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(dict(zip(axes, shape)))


def make_local_mesh(model: int = 1) -> Mesh:
    """The mesh of the ranks that exist: the initialised process group's,
    or this process alone. ``model`` (the tensor-parallel axis size) is
    clamped to the world size (asking for more shards than ranks degrades
    to what there is instead of building an empty ``(0, k)`` mesh) and
    must divide it; the rest is the "data" axis. Every rank must call
    this, in the same order: a "model" axis shorter than the world makes
    one process group a data row, a "data" axis shorter than the world one
    a model column (ranks c, c + model, ...), each built by all ranks,
    the rows first."""
    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    live = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if live else 1
    rank = dist.get_rank() if live else 0
    model = min(model, n)
    if n % model:
        raise ValueError(
            f"model={model} does not divide the {n} ranks; pick a divisor "
            f"of {n}")
    data = n // model
    groups: Dict[str, Any] = {}
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    if live and 1 < model < n:
        for row in range(data):
            g = dist.new_group(list(range(row * model, (row + 1) * model)),
                               timeout=timeout)
            if row == rank // model:
                groups["model"] = g
    if live and 1 < data < n:
        for col in range(model):
            g = dist.new_group(list(range(col, n, model)), timeout=timeout)
            if col == rank % model:
                groups["data"] = g
    return Mesh({"data": data, "model": model}, rank=rank, groups=groups)


def make_named_mesh(shape: Dict[str, int]) -> Mesh:
    """The ranks that exist (the initialised process group's, or this
    process alone) laid out row-major as ``shape`` (axis name -> size),
    whose sizes must multiply to the world size."""
    live = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if live else 1
    mesh = Mesh(shape, rank=dist.get_rank() if live else 0)
    if mesh.size != n:
        raise ValueError(f"mesh {dict(shape)} holds {mesh.size} ranks, the "
                         f"world {n}")
    return mesh


def init_rank(rank: int, world: int, init_file: str, device: str = "cuda",
              timeout_s: float = COLLECTIVE_TIMEOUT_S) -> torch.device:
    """Join the process group of ``world`` ranks as ``rank`` (rendezvous
    through the ``FileStore`` at ``init_file``) and return this rank's
    device: ``cuda:rank`` over NCCL where there is a card a rank, else
    ``cuda:0`` (the ranks share it) or the CPU, over gloo."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_rank: no CUDA device; pass device='cpu'")
        own = torch.cuda.device_count() >= world
        dev = torch.device("cuda", rank if own else 0)
        torch.cuda.set_device(dev)
        backend = "nccl" if own else "gloo"
    elif device == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    dist.init_process_group(
        backend, store=dist.FileStore(init_file, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def spawn_ranks(argv: Sequence[str], world: int,
                timeout_s: float) -> List[str]:
    """Run ``python argv... --rank r --world world --init FILE`` for every
    rank, all started together, and wait for all of them. Returns each
    rank's output (stdout and stderr). If a rank fails or the time runs
    out, every rank still running is killed and ``RuntimeError`` names
    the first failure with the ranks' outputs."""
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "rendezvous")
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, *argv, "--rank", str(r), "--world", str(world),
             "--init", init], stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].poll()}"
                    break
                if time.monotonic() > deadline:
                    failed = f"ranks still running after {timeout_s} s"
                    break
                time.sleep(0.05)
            else:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
                f.close()
        if failed:
            raise RuntimeError(f"spawn_ranks: {failed}\n" + "\n".join(
                f"--- rank {r} ---\n{o}" for r, o in enumerate(outs)))
        return outs
