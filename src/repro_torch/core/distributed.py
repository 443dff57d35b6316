"""Process groups and collectives for data parallelism (the counterpart of
``repro/launch/mesh.py``, which builds the reference's device mesh).

One process per rank. Under ``torchrun`` the world comes from its
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and the rendezvous
in ``MASTER_ADDR``/``MASTER_PORT``); otherwise :func:`spawn` starts the
ranks itself and they meet at a ``file://`` store in a fresh temporary
directory. The backend follows the device: ``nccl`` on ``cuda``, one rank
per card (device ``LOCAL_RANK``), ``gloo`` on ``cpu``. Every group gets a
timeout, so a collective that one rank never joins raises instead of
hanging. A world of one goes through the same calls as any other.

A leaf sharded on dimension ``d`` is split into ``size`` contiguous chunks
of that dimension, and rank r holds chunk r. On the wire the chunks are
laid out rank-major, ``torch.cat([c.reshape(-1) for c in
t.chunk(size, d)])``, which is what ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` exchange. The ``*_many`` collectives move a
group of leaves (a layer's params, every gradient) in one call per dtype:
rank r's part of the wire is its chunk of each leaf in turn.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class World:
    """This process's place in the data-parallel group (the default
    process group)."""
    rank: int
    size: int
    local_rank: int
    device: torch.device

    def all_reduce(self, t: torch.Tensor, op: str = "mean") -> torch.Tensor:
        """Sum (``op="sum"``) or mean of ``t`` over the ranks, in place;
        returns ``t``."""
        if op not in ("sum", "mean"):
            raise ValueError(f"op must be 'sum' or 'mean': {op!r}")
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        if op == "mean":
            t.div_(self.size)
        return t

    def all_reduce_many(self, ts: list, op: str = "mean") -> list:
        """``all_reduce`` of every tensor of ``ts`` in place, one collective
        per dtype (the tensors go through one flat buffer)."""
        for idx in _by_dtype(ts):
            flat = self.all_reduce(torch.cat([ts[i].reshape(-1)
                                              for i in idx]), op)
            for i, part in zip(idx, flat.split([ts[i].numel()
                                                for i in idx])):
                ts[i].copy_(part.view(ts[i].shape))
        return ts

    def chunk(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's chunk of ``t`` along ``dim`` (a view)."""
        return t.chunk(self.size, dim)[self.rank]

    def _split(self, shape, dim):
        """``shape`` with ``dim`` split into (world, chunk)."""
        if shape[dim] % self.size:
            raise ValueError(f"dimension {dim} of {tuple(shape)} not "
                             f"divisible by world size {self.size}")
        return list(shape[:dim]) + [self.size, shape[dim] // self.size] + \
            list(shape[dim + 1:])

    def reduce_scatter_many(self, ts: list, dims: list) -> list:
        """For each tensor, the sum over the ranks of this rank's chunk
        along its dimension (new contiguous tensors of the chunks' shapes);
        one collective per dtype."""
        out = [None] * len(ts)
        for idx in _by_dtype(ts):
            t0 = ts[idx[0]]
            sizes = [ts[i].numel() // self.size for i in idx]
            wire = torch.empty((self.size, sum(sizes)), dtype=t0.dtype,
                               device=t0.device)
            off = 0
            for i, n in zip(idx, sizes):
                split = self._split(ts[i].shape, dims[i])
                moved = ts[i].reshape(split).movedim(dims[i], 0)
                wire[:, off:off + n].view(moved.shape).copy_(moved)
                off += n
            flat = torch.empty(sum(sizes), dtype=t0.dtype, device=t0.device)
            _reduce_scatter(flat, wire.view(-1), op=dist.ReduceOp.SUM)
            for i, part in zip(idx, flat.split(sizes)):
                shape = list(ts[i].shape)
                shape[dims[i]] //= self.size
                out[i] = part.view(shape)
        return out

    def all_gather_many(self, shards: list, dims: list) -> list:
        """The whole leaves from every rank's chunks ``shards`` (chunk i
        split along ``dims[i]``), one collective per dtype."""
        out = [None] * len(shards)
        for idx in _by_dtype(shards):
            s0 = shards[idx[0]]
            sizes = [shards[i].numel() for i in idx]
            flat = torch.cat([shards[i].reshape(-1) for i in idx])
            wire = torch.empty((self.size, flat.numel()), dtype=s0.dtype,
                               device=s0.device)
            _all_gather(wire.view(-1), flat)
            off = 0
            for i, n in zip(idx, sizes):
                shape = list(shards[i].shape)
                shape[dims[i]] *= self.size
                full = torch.empty(shape, dtype=s0.dtype, device=s0.device)
                dst = full.view(self._split(shape, dims[i])).movedim(
                    dims[i], 0)
                dst.copy_(wire[:, off:off + n].view(dst.shape))
                out[i] = full
                off += n
        return out


def _by_dtype(ts) -> list:
    """Indices of ``ts`` grouped by dtype, in first-seen order."""
    groups = {}
    for i, t in enumerate(ts):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def _reduce_scatter(out, wire, op):
    # the newer name where the installed torch has it (the older one warns)
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(
        out, wire, op=op)


def _all_gather(out, wire):
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, wire)


def _check_cards(size: int) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no GPU; "
                           "pass device='cpu' (--device cpu) to run on the "
                           "CPU")
    n = torch.cuda.device_count()
    if size > n:
        raise RuntimeError(
            f"a data-parallel world of {size} ranks needs {size} GPUs (one "
            f"rank per card; NCCL refuses two ranks on one device), and "
            f"torch sees {n}")


def init_world(device="cuda", *, rank=None, size=None, init_method=None,
               timeout_s: float = COLLECTIVE_TIMEOUT_S) -> World:
    """Join the process group. Without ``rank``/``size`` the world is
    ``torchrun``'s (its environment variables); ``init_method`` defaults to
    ``env://``. ``nccl`` on ``cuda`` (the rank's card is ``LOCAL_RANK``),
    ``gloo`` on ``cpu``."""
    device = torch.device(device)
    local_rank = None
    if rank is None:
        try:
            rank = int(os.environ["RANK"])
            size = int(os.environ["WORLD_SIZE"])
        except KeyError as e:
            raise RuntimeError(
                f"no world given and {e} unset: start the ranks with "
                f"torchrun, or through spawn()") from e
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if local_rank is None:
        local_rank = rank
    if device.type == "cuda":
        _check_cards(local_rank + 1)
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no data-parallel backend for device {device}")
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
    return World(rank=rank, size=size, local_rank=local_rank, device=device)


def close_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _child(rank, size, device, init_method, timeout_s, fn, args, results):
    """A spawned rank: join the group, run ``fn(world, *args)``, send
    ``(rank, True, result)`` or ``(rank, False, traceback)``."""
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        world = init_world(device, rank=rank, size=size,
                           init_method=init_method, timeout_s=timeout_s)
        out = fn(world, *args)
        close_world()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def spawn(fn, nprocs: int, *args, device="cuda", deadline_s=None,
          timeout_s: float = COLLECTIVE_TIMEOUT_S) -> list:
    """Run ``fn(world, *args)`` on ``nprocs`` fresh processes (the
    ``spawn`` start method; ``fn`` and ``args`` must pickle, so ``fn`` lives
    in an importable module) and return their results by rank.

    A rank that raises, or dies, ends the world: the others are killed and
    its traceback is raised here. ``deadline_s`` bounds the whole run; at
    it every rank is killed and ``TimeoutError`` raised. ``timeout_s`` is
    each collective's limit. On ``cuda`` a world larger than the card count
    raises before any process starts."""
    device = torch.device(device)
    if device.type == "cuda":
        _check_cards(nprocs)
    ctx = mp.get_context("spawn")
    store = tempfile.mkdtemp(prefix="repro_torch_world_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(
        rank, nprocs, device.type, f"file://{store}/store", timeout_s, fn,
        args, results)) for rank in range(nprocs)]
    out, end = {}, None if deadline_s is None else \
        time.monotonic() + deadline_s
    try:
        for p in procs:
            p.start()
        while len(out) < nprocs:
            if end is not None and time.monotonic() > end:
                raise TimeoutError(
                    f"data-parallel world of {nprocs} did not finish in "
                    f"{deadline_s} s; ranks {sorted(set(range(nprocs)) - set(out))} "
                    f"still running")
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in out]
                if dead:
                    # a message may still be in flight from a rank that
                    # has just exited: look once more before giving up
                    try:
                        rank, ok, payload = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank(s) {dead} exited with codes "
                            f"{[procs[r].exitcode for r in dead]} and sent "
                            f"no result") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n"
                                   f"{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=60)
        return [out[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join(timeout=10)
        results.close()
        shutil.rmtree(store, ignore_errors=True)
