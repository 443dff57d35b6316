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

``backend="gloo"`` on ``cuda``, passed explicitly to :func:`init_world` or
:func:`spawn` (the CLI never does), lets several ranks share cards: rank r
computes on card ``r % device_count``, and each collective moves its
tensors through host memory (``World.host_staged``), where gloo runs it
(the pipeline's point-to-point ``exchange`` too).
That is a transport, not a fallback: the compute stays on the card. It is
how one card runs a world of ranks (tensor parallelism's model groups,
``chip_smoke.py``); NCCL is what runs across cards.

A :class:`World` is the default group, or a subgroup of it (``group``, the
global ``ranks`` of its members in group-rank order): pipeline parallelism
(``launch/mesh.py``) runs ZeRO over a stage's data group and hands
activations and cotangents between the ranks of a pipe group with
:meth:`World.exchange`, point to point.

A leaf sharded on dimension ``d`` is split into ``size`` contiguous chunks
of that dimension, and rank r holds chunk r. On the wire the chunks are
laid out rank-major, ``torch.cat([c.reshape(-1) for c in
t.chunk(size, d)])``, which is what ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` exchange. The ``*_many`` collectives move a
group of leaves (a layer's params, every gradient) in one call per dtype:
rank r's part of the wire is its chunk of each leaf in turn.
:meth:`World.all_to_all` sends each rank its own block (Ulysses' reshard
between sequence rows and heads, ``models/shardctx.py``).

Every collective of a group of more than one rank records its kind
(:data:`COLLECTIVE_KINDS`, the reference's names) and the bytes of its
result on this rank, the convention of ``repro/launch/hlo_analysis.py``:
:func:`count_collectives` reads the tally since :func:`reset_collectives`,
and an op counter (``launch/op_count.py``) registered with
:func:`add_recorder` is told of each one, with whether its group spans
more than one node of :data:`NODE_CARDS` cards. A :class:`RecordingWorld`
is rank r of a world of N that moves nothing: its collectives return
tensors of their results' shapes (on ``meta`` for the dry run) and record
the same bytes as a real world's, and its subgroups need no process
group.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import queue as queue_mod
import shutil
import signal
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.comm_model import COLLECTIVE_KINDS

COLLECTIVE_TIMEOUT_S = 600.0
# the cards of one node (an NVLink domain: DGX H100)
NODE_CARDS = 8

_COUNTS = dict.fromkeys(COLLECTIVE_KINDS, 0)
_RECORDERS = []


def count_collectives() -> dict:
    """``{kind: bytes}``: the result bytes on this rank of every collective
    since :func:`reset_collectives`, by kind."""
    return dict(_COUNTS)


def reset_collectives() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def add_recorder(fn) -> None:
    """Call ``fn(kind, nbytes, network)`` at each collective from now on."""
    _RECORDERS.append(fn)


def remove_recorder(fn) -> None:
    _RECORDERS.remove(fn)


@dataclass(frozen=True)
class World:
    """This process's place in a process group: the default one
    (``group`` None), or a subgroup whose members are the global ``ranks``
    (``rank`` and ``size`` are then this process's place in it)."""
    rank: int
    size: int
    local_rank: int
    device: torch.device
    group: object = None
    ranks: tuple = None
    # gloo on cuda: each collective copies its tensors to the host and back
    host_staged: bool = False
    # a RecordingWorld's: collectives record their bytes and move nothing
    recording = False

    def subgroup(self, group, ranks) -> "World":
        """This process's place in ``group`` (made by ``dist.new_group``
        over the global ``ranks``, this process among them)."""
        ranks = tuple(ranks)
        return World(rank=ranks.index(dist.get_rank()), size=len(ranks),
                     local_rank=self.local_rank, device=self.device,
                     group=group, ranks=ranks, host_staged=self.host_staged)

    def global_rank(self, r: int) -> int:
        """The global rank of this group's rank ``r``."""
        return r if self.ranks is None else self.ranks[r]

    @property
    def spans_nodes(self) -> bool:
        """Whether the group's cards lie in more than one node of
        :data:`NODE_CARDS` (global rank // NODE_CARDS)."""
        ranks = self.ranks if self.ranks is not None else range(self.size)
        return len({r // NODE_CARDS for r in ranks}) > 1

    def _record(self, kind: str, nbytes: int) -> None:
        """Tally one collective of ``kind`` with ``nbytes`` of result on
        this rank (none for a group of one: it moves nothing)."""
        if self.size <= 1:
            return
        _COUNTS[kind] += nbytes
        for fn in _RECORDERS:
            fn(kind, nbytes, self.spans_nodes)

    def _staged(self, fn, out: torch.Tensor, *ins: torch.Tensor) -> None:
        """``fn(out, *ins)``, a collective that writes ``out``; under
        ``host_staged`` on host copies, the result copied back into
        ``out``."""
        if not self.host_staged or out.device.type == "cpu":
            fn(out, *ins)
            return
        host = out.cpu()
        fn(host, *(t.cpu() for t in ins))
        # an inference tensor (the eval's counts) takes the copy in
        # inference mode; any other outside it
        with torch.inference_mode(out.is_inference()):
            out.copy_(host)

    def all_reduce(self, t: torch.Tensor, op: str = "mean") -> torch.Tensor:
        """Sum (``op="sum"``), mean or max of ``t`` over the ranks, in
        place; returns ``t``."""
        if op not in ("sum", "mean", "max"):
            raise ValueError(f"op must be 'sum', 'mean' or 'max': {op!r}")
        if self.size == 1 and self.host_staged:
            # one rank's sum, mean and max are its own: no trip through
            # host memory (a model-parallel run's data group of one)
            return t
        self._record("all-reduce", t.numel() * t.element_size())
        red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        self._staged(lambda x: dist.all_reduce(x, op=red, group=self.group),
                     t)
        if op == "mean":
            t.div_(self.size)
        return t

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (a MAX all-reduce): every rank
        gets the same answer, so all take the same branch."""
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        return bool(self.all_reduce(t, "max").item())

    def all_reduce_many(self, ts: list, op: str = "mean") -> list:
        """``all_reduce`` of every tensor of ``ts`` in place, one collective
        per dtype (the tensors go through one flat buffer; under
        ``host_staged`` a buffer in host memory, filled and emptied a
        tensor at a time, so the card holds no second copy of them)."""
        if self.size == 1 and self.host_staged:
            return ts
        for idx in _by_dtype(ts):
            if self.host_staged and ts[idx[0]].device.type != "cpu":
                sizes = [ts[i].numel() for i in idx]
                flat = torch.empty(sum(sizes), dtype=ts[idx[0]].dtype)
                for i, part in zip(idx, flat.split(sizes)):
                    part.copy_(ts[i].reshape(-1))
                self.all_reduce(flat, op)
            else:
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
            self._record("reduce-scatter", flat.numel() * flat.element_size())
            self._staged(lambda o, i: _reduce_scatter(
                o, i, op=dist.ReduceOp.SUM, group=self.group),
                flat, wire.view(-1))
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
            self._record("all-gather", wire.numel() * wire.element_size())
            self._staged(lambda o, i: _all_gather(o, i, group=self.group),
                         wire.view(-1), flat)
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

    def all_to_all(self, sends: list, shapes: list) -> list:
        """Block ``sends[i]`` to rank i, and from each rank i a block of
        ``shapes[i]`` back, in rank order (one dtype; the blocks may differ
        in size, as an uneven sequence split makes them). One
        ``all_to_all_single`` on flat buffers, the blocks packed along
        dimension 0 with uneven split sizes (gloo's list form refuses
        uneven blocks); under ``host_staged`` through host memory."""
        sizes = [math.prod(s) for s in shapes]
        flat = torch.cat([t.reshape(-1) for t in sends])
        out = torch.empty(sum(sizes), dtype=flat.dtype, device=flat.device)
        self._record("all-to-all", out.numel() * out.element_size())
        self._staged(lambda o, i: dist.all_to_all_single(
            o, i, sizes, [t.numel() for t in sends], group=self.group),
            out, flat)
        return [p.view(s) for p, s in zip(out.split(sizes), shapes)]

    def exchange(self, sends: list, recvs: list) -> list:
        """Point to point within the group, in one
        ``dist.batch_isend_irecv``: ``sends`` ``[(tensor, rank)]`` and
        ``recvs`` ``[(shape, dtype, rank)]`` (group ranks; at most one
        message each way between two ranks per call). Returns the received
        tensors in the order of ``recvs``. A receive whose peer never sends
        raises at the group's timeout. Under ``host_staged`` the tensors
        travel as host copies."""
        staged = self.host_staged and self.device.type != "cpu"
        wire = torch.device("cpu") if staged else self.device
        out = [torch.empty(shape, dtype=dtype, device=wire)
               for shape, dtype, _ in recvs]
        if out:
            self._record("collective-permute",
                         sum(t.numel() * t.element_size() for t in out))
        ops = [dist.P2POp(dist.isend, t.contiguous().to(wire),
                          self.global_rank(r), self.group)
               for t, r in sends] + \
            [dist.P2POp(dist.irecv, buf, self.global_rank(r), self.group)
             for buf, (_, _, r) in zip(out, recvs)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [t.to(self.device) for t in out]


@dataclass(frozen=True)
class RecordingWorld(World):
    """Rank ``rank`` of a world of ``size`` that moves nothing (the dry
    run's world, on ``meta``): every collective records the bytes a real
    world's would and leaves its result as an empty tensor of its shape
    (an in-place one untouched); its subgroups are formed from the global
    ``ranks`` without a process group."""
    recording = True

    def subgroup(self, group, ranks) -> "RecordingWorld":
        ranks = tuple(ranks)
        return RecordingWorld(rank=ranks.index(self.global_rank(self.rank)),
                              size=len(ranks), local_rank=self.local_rank,
                              device=self.device, group=None, ranks=ranks)

    def _staged(self, fn, out, *ins) -> None:
        return None

    def exchange(self, sends: list, recvs: list) -> list:
        out = [torch.empty(shape, dtype=dtype, device=self.device)
               for shape, dtype, _ in recvs]
        if out:
            self._record("collective-permute",
                         sum(t.numel() * t.element_size() for t in out))
        return out


def recording_world(rank: int, size: int, device="meta") -> RecordingWorld:
    """Rank ``rank`` of a :class:`RecordingWorld` of ``size``."""
    return RecordingWorld(rank=rank, size=size, local_rank=0,
                          device=torch.device(device))


def _by_dtype(ts) -> list:
    """Indices of ``ts`` grouped by dtype, in first-seen order."""
    groups = {}
    for i, t in enumerate(ts):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def _reduce_scatter(out, wire, op, group=None):
    # the newer name where the installed torch has it (the older one warns)
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(
        out, wire, op=op, group=group)


def _all_gather(out, wire, group=None):
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, wire, group=group)


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


def _backend(device: torch.device, backend) -> str:
    """The backend of ``device``: its default (``nccl`` on ``cuda``,
    ``gloo`` on ``cpu``), or ``backend`` where it is given; on ``cuda``
    only ``"gloo"`` may be asked for (ranks that share cards)."""
    default = {"cuda": "nccl", "cpu": "gloo"}.get(device.type)
    if default is None:
        raise ValueError(f"no data-parallel backend for device {device}")
    if backend is None or backend == default:
        return default
    if device.type == "cuda" and backend == "gloo":
        return backend
    raise ValueError(f"backend {backend!r} on {device.type}: the choices "
                     f"are {default!r} and, on cuda, 'gloo'")


def init_world(device="cuda", *, rank=None, size=None, init_method=None,
               timeout_s: float = COLLECTIVE_TIMEOUT_S,
               backend=None) -> World:
    """Join the process group. Without ``rank``/``size`` the world is
    ``torchrun``'s (its environment variables); ``init_method`` defaults to
    ``env://``. ``nccl`` on ``cuda`` (the rank's card is ``LOCAL_RANK``),
    ``gloo`` on ``cpu``. ``backend="gloo"`` on ``cuda`` puts the rank on
    card ``LOCAL_RANK % device_count`` (ranks may share one) and stages
    every collective through host memory."""
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
    backend = _backend(device, backend)
    staged = device.type == "cuda" and backend == "gloo"
    if device.type == "cuda":
        _check_cards(1 if staged else local_rank + 1)
        device = torch.device("cuda", local_rank % torch.cuda.device_count()
                              if staged else local_rank)
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
    return World(rank=rank, size=size, local_rank=local_rank, device=device,
                 host_staged=staged)


def close_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _child(rank, size, device, init_method, timeout_s, backend, fn, args,
           results):
    """A spawned rank: join the group, run ``fn(world, *args)``, send
    ``(rank, "ok", result)``, ``(rank, "error", traceback)``, or ``(rank,
    "exit", code)`` for a ``SystemExit`` with a nonzero int code (e.g. the
    preemption exit, 75), which then is the rank's exit code too."""
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        world = init_world(device, rank=rank, size=size,
                           init_method=init_method, timeout_s=timeout_s,
                           backend=backend)
        out = fn(world, *args)
        close_world()
    except SystemExit as e:
        if isinstance(e.code, int) and e.code:
            results.put((rank, "exit", e.code))
            raise
        results.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1)
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, "ok", out))


@contextlib.contextmanager
def _forward_signals(procs):
    """While the ranks run, pass SIGTERM and SIGINT on to every live one
    (a supervisor signals only the launcher); a no-op off the main
    thread, where handlers cannot be set."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def forward(signum, frame):
        del frame
        for p in procs:
            if p.pid is not None and p.exitcode is None:
                os.kill(p.pid, signum)

    prev = {s: signal.signal(s, forward)
            for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield
    finally:
        for s, h in prev.items():
            signal.signal(s, h)


def spawn(fn, nprocs: int, *args, device="cuda", deadline_s=None,
          timeout_s: float = COLLECTIVE_TIMEOUT_S, backend=None) -> list:
    """Run ``fn(world, *args)`` on ``nprocs`` fresh processes (the
    ``spawn`` start method; ``fn`` and ``args`` must pickle, so ``fn`` lives
    in an importable module) and return their results by rank.

    A rank that raises, or dies, ends the world: the others are killed and
    its traceback is raised here. A rank that exits with a nonzero int code
    (``SystemExit``, e.g. the preemption exit) makes this raise
    ``SystemExit`` with that code once every rank has finished. SIGTERM
    and SIGINT sent to this process are passed on to the ranks.
    ``deadline_s`` bounds the whole run; at it every rank is killed and
    ``TimeoutError`` raised. ``timeout_s`` is
    each collective's limit. On ``cuda`` a world larger than the card count
    raises before any process starts, unless ``backend="gloo"`` is given
    (see :func:`init_world`: the ranks then share the cards)."""
    device = torch.device(device)
    if device.type == "cuda":
        _check_cards(1 if _backend(device, backend) == "gloo" else nprocs)
    ctx = mp.get_context("spawn")
    store = tempfile.mkdtemp(prefix="repro_torch_world_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(
        rank, nprocs, device.type, f"file://{store}/store", timeout_s,
        backend, fn, args, results)) for rank in range(nprocs)]
    out, exits, end = {}, {}, None if deadline_s is None else \
        time.monotonic() + deadline_s
    try:
        for p in procs:
            p.start()
        with _forward_signals(procs):
            while len(out) + len(exits) < nprocs:
                if end is not None and time.monotonic() > end:
                    raise TimeoutError(
                        f"data-parallel world of {nprocs} did not finish in "
                        f"{deadline_s} s; ranks "
                        f"{sorted(set(range(nprocs)) - set(out) - set(exits))}"
                        f" still running")
                try:
                    rank, status, payload = results.get(timeout=0.5)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in out
                            and r not in exits]
                    if dead:
                        # a message may still be in flight from a rank that
                        # has just exited: look once more before giving up
                        try:
                            rank, status, payload = results.get(timeout=2.0)
                        except queue_mod.Empty:
                            raise RuntimeError(
                                f"rank(s) {dead} exited with codes "
                                f"{[procs[r].exitcode for r in dead]} and "
                                f"sent no result") from None
                    else:
                        continue
                if status == "error":
                    raise RuntimeError(f"rank {rank} of {nprocs} failed:\n"
                                       f"{payload}")
                if status == "exit":
                    exits[rank] = payload
                else:
                    out[rank] = payload
        for p in procs:
            p.join(timeout=60)
        if exits:
            # every rank takes the same exit (e.g. the agreed preemption
            # step), so the lowest rank's code is the world's
            raise SystemExit(exits[min(exits)])
        return [out[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join(timeout=10)
        results.close()
        shutil.rmtree(store, ignore_errors=True)
