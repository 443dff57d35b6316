"""Counted FLOPs, bytes and collectives of what a program runs (the
counterpart of ``repro/launch/hlo_analysis.py``, which reads them from the
compiled HLO text).

:class:`OpCounter` installs a ``TorchDispatchMode``: every aten op run
inside it (on ``meta`` tensors for the dry run, or on the card) adds to
its :class:`Totals`, by these conventions:

  flops        matmul and convolution MACs x2, by
               ``torch.utils.flop_counter``'s formulas (the reference's
               ``_dot_flops``/``_conv_flops``); elementwise work is not
               counted
  hbm_bytes    each op's input plus output bytes, the eager counterpart of
               the reference's post-fusion call-site traffic; views,
               reshapes, ``detach`` and the allocations without data
               (``empty``) count 0, like ``_FREE_OPS``
  coll         the bytes of each collective's result on this rank, by kind
               (``COLLECTIVE_KINDS``), as ``core/distributed.py``'s
               ``World`` records them; ``coll_network`` the part moved by
               groups that span more than one 8-card node

A hand-written kernel runs through ``ctypes``, out of the counter's sight,
so each kernel wrapper charges its analytic work (:func:`charge`, from
:func:`attn_work`, :func:`rms_work` and :func:`wkv6_work`, the formulas
``chip_smoke.py``'s bound column uses), on the card and on ``meta`` alike.

Loops whose iterations repeat the same work (the microbatches of gradient
accumulation, the key blocks of ``models/blockwise.py``) go through
:func:`repeat`: under a counter made with ``skip_repeats`` (the dry run's)
the body runs once and everything it does is counted times the trip
count, as the reference's analyzer applies ``known_trip_count``; without
one every iteration runs. The work before and after such a loop does not
depend on whether it was skipped.

Peak bytes (:attr:`OpCounter.peak_bytes`): ``args_bytes`` (the rank's
params, optimizer state and batch, given by the caller) plus the saved
activations live at the time (``torch.autograd.graph.saved_tensors_hooks``,
each storage once, the args' own storages excluded) plus the outputs of
the op running. It leaves out the gradients and their accumulators, what
a checkpointed (remat) region saves while it recomputes in the backward
(torch's checkpoint keeps those out of the outer hooks), the collectives'
buffers, kernel workspaces and the allocator's rounding and
fragmentation.
"""
from __future__ import annotations

import contextlib
import functools
import os
import sys
import weakref
from collections import defaultdict
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.core import distributed
from repro_torch.core.distributed import COLLECTIVE_KINDS

aten = torch.ops.aten

# ops that move no data: views, shape changes, aliases and allocations
_FREE = frozenset(p for p in (
    aten.view, aten._unsafe_view, aten.reshape, aten.alias, aten.detach,
    aten.t, aten.transpose, aten.permute, aten.expand, aten.squeeze,
    aten.unsqueeze, aten.slice, aten.select, aten.as_strided,
    aten.split, aten.split_with_sizes, aten.unbind, aten.chunk,
    aten.view_as, aten.movedim, aten.narrow, aten.diagonal,
    aten.unflatten, aten.flatten, aten.empty, aten.empty_like,
    aten.empty_strided, aten.new_empty, aten.new_empty_strided,
    aten.lift_fresh, aten._reshape_alias, aten.view_as_real,
    aten.view_as_complex, aten.unfold, aten.tensor_split,
    aten.resolve_conj, aten.resolve_neg, aten.conj, aten._conj,
    aten.sym_size, aten.sym_stride, aten.sym_numel, aten.is_same_size,
    aten.sym_storage_offset) if p is not None)


def tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def _bytes_of(tree) -> int:
    return sum(tensor_bytes(t) for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


@dataclass
class Totals:
    """The reference's ``Totals`` (``hlo_analysis.py:70-90``), with the
    collective bytes of groups that span nodes kept apart too."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll: dict = None
    coll_network: dict = None

    def __post_init__(self):
        if self.coll is None:
            self.coll = {k: 0.0 for k in COLLECTIVE_KINDS}
        if self.coll_network is None:
            self.coll_network = {k: 0.0 for k in COLLECTIVE_KINDS}

    def add(self, other, mult=1.0):
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        for k in COLLECTIVE_KINDS:
            self.coll[k] += other.coll[k] * mult
            self.coll_network[k] += other.coll_network[k] * mult

    @property
    def coll_bytes(self):
        return sum(self.coll.values())


_ACTIVE = []


def active():
    """The innermost :class:`OpCounter` entered, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class _Mode(TorchDispatchMode):
    """The dispatch mode of an :class:`OpCounter`: an op with a composite
    decomposition (``matmul``, ``einsum``, ``to``: what autograd would
    have decomposed, e.g. under ``inference_mode``) runs decomposed under
    the mode, so its parts are counted; any other op runs and is
    counted."""

    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket not in flop_registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self.counter._count(func, out, args, kwargs)
        return out


class _Saved:
    """A saved tensor as the autograd graph holds it while counted."""
    __slots__ = ("t", "__weakref__")

    def __init__(self, t):
        self.t = t


class OpCounter:
    """Counts what runs inside it (see the module docstring), a context
    manager. ``where``:
    also attribute each op to the innermost ``repro_torch`` function that
    called it (slower; :meth:`top_contributors` reads it).
    ``skip_repeats``: run a :func:`repeat` loop's body once, counted times
    its trip count (the dry run on ``meta``). ``args_bytes`` and
    ``arg_tensors``: the rank's arguments' bytes, and their tensors, whose
    storages are not counted again as saved activations."""

    def __init__(self, *, where=False, skip_repeats=False, args_bytes=0,
                 arg_tensors=()):
        self.totals = Totals()
        self.by_op = defaultdict(lambda: [0.0, 0.0, 0])   # flops, bytes, n
        self.where = where
        self.skip_repeats = skip_repeats
        self.mult = 1.0
        self._outer = []
        self.args_bytes = args_bytes
        self._args = {t.untyped_storage()._cdata for t in arg_tensors}
        self._live = {}             # storage -> [refs, bytes]
        self.saved_bytes = 0
        self.peak_saved = 0
        self.peak_bytes = args_bytes
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, self._unpack)

    # --- the saved activations ---------------------------------------------

    def _pack(self, t):
        box = _Saved(t)
        key = t.untyped_storage()._cdata
        if key in self._args:
            return box
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [0, t.untyped_storage().nbytes()]
            self.saved_bytes += entry[1]
            self.peak_saved = max(self.peak_saved, self.saved_bytes)
        entry[0] += 1
        weakref.finalize(box, self._release, key)
        return box

    def _release(self, key):
        entry = self._live.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self.saved_bytes -= entry[1]
            del self._live[key]

    @staticmethod
    def _unpack(box):
        return box.t

    # --- the mode ------------------------------------------------------------

    def __enter__(self):
        _ACTIVE.append(self)
        distributed.add_recorder(self.record_collective)
        self._hooks.__enter__()
        self._mode = _Mode(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._mode.__exit__(*exc)
        finally:
            self._hooks.__exit__(*exc)
            distributed.remove_recorder(self.record_collective)
            _ACTIVE.remove(self)
        return False

    def _where(self):
        f = sys._getframe(3)
        here = os.path.dirname(os.path.dirname(__file__))
        while f is not None:
            path = f.f_code.co_filename
            if path.startswith(here) and not path.endswith(
                    os.path.join("launch", "op_count.py")):
                rel = os.path.relpath(path, here)
                return f"{rel}:{f.f_code.co_name}"
            f = f.f_back
        return "?"

    def _add(self, name, flops, nbytes):
        m = self.mult
        self.totals.flops += flops * m
        self.totals.hbm_bytes += nbytes * m
        row = self.by_op[name]
        row[0] += flops * m
        row[1] += nbytes * m
        row[2] += m

    def _count(self, func, out, args, kwargs):
        """Count one aten op that ran (no decomposition left)."""
        packet = func._overloadpacket
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if packet in _FREE or not outs:
            return
        out_bytes = sum(tensor_bytes(t) for t in outs)
        nbytes = _bytes_of((args, kwargs)) + out_bytes
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        name = str(packet)
        if self.where:
            name = f"{name} @ {self._where()}"
        self._add(name, flops, nbytes)
        self.peak_bytes = max(self.peak_bytes, self.args_bytes
                              + self.saved_bytes + out_bytes)

    # --- what the counter cannot see -----------------------------------------

    def charge(self, name, nbytes, flops):
        """A hand-written kernel's analytic work."""
        self._add(f"kernel.{name}", flops, nbytes)

    def record_collective(self, kind, nbytes, network):
        """One collective of ``kind`` whose result on this rank is
        ``nbytes``; ``network``: its group spans nodes."""
        m = self.mult
        self.totals.coll[kind] += nbytes * m
        if network:
            self.totals.coll_network[kind] += nbytes * m

    def top_contributors(self, n: int = 20, by: str = "bytes") -> list:
        """``[(score, calls, op)]``: the ``n`` aten ops (with ``where``,
        by the ``repro_torch`` function that ran them) and kernels with
        the most ``by`` ("bytes" or "flops"), trip counts applied (the
        reference's ``top_contributors``, ``hlo_analysis.py:290``)."""
        col = {"flops": 0, "bytes": 1}[by]
        rows = [(v[col], v[2], k) for k, v in self.by_op.items() if v[col]]
        rows.sort(key=lambda r: -r[0])
        return rows[:n]


def charge(name, work):
    """Charge the active counter (if any) with a kernel's work: ``work()``
    -> ``(bytes, flops)``, evaluated only while counting."""
    c = active()
    if c is not None:
        c.charge(name, *work())


def repeat(items):
    """Iterate ``items``, a loop whose iterations do the same work: under a
    counter with ``skip_repeats`` only the first, counted ``len(items)``
    times (the reference's ``known_trip_count``); else every one."""
    items = list(items)
    c = active()
    if c is None or not c.skip_repeats or len(items) <= 1:
        yield from items
        return
    c._outer.append(c.mult)
    c.mult *= len(items)
    try:
        yield items[0]
    finally:
        c.mult = c._outer.pop()


@contextlib.contextmanager
def once():
    """Inside a :func:`repeat` body: count the work of the first iteration
    only once (an accumulator's allocation)."""
    c = active()
    if c is None or not c._outer:
        yield
        return
    mult, c.mult = c.mult, c._outer[-1]
    try:
        yield
    finally:
        c.mult = mult


# --- the kernels' work (the bound column of chip_smoke.py's kernel table) -----

# Published dense peaks (NVIDIA data sheets) by card: HBM bytes/s, bf16
# tensor-core FLOP/s and fp32 FLOP/s outside the tensor cores. The SXM part
# is the H100 80GB HBM3.
PEAKS = {
    "H100 PCIe": (2.0e12, {"bf16": 756e12, "fp32": 51e12}),
    "H100 NVL": (3.9e12, {"bf16": 835e12, "fp32": 60e12}),
    "H100": (3.35e12, {"bf16": 989e12, "fp32": 67e12}),
    "H200": (4.8e12, {"bf16": 989e12, "fp32": 67e12}),
}


def peaks(name):
    """(the part of :data:`PEAKS` whose key ``name`` contains, its
    rates)."""
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise ValueError(f"no peak rates known for card {name!r}")


def bound(card, n_bytes, flops, rate="bf16"):
    """(bound_ms, bound_by, how): the least time the card could take to
    move ``n_bytes`` (each input read once, each output written once) and
    to do ``flops`` at the published ``rate`` peak, the larger of the two."""
    part, (bw, rates) = peaks(card)
    t_bytes, t_ops = n_bytes / bw * 1e3, flops / rates[rate] * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    how = (f"{n_bytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s = {t_bytes:.4f} "
           f"ms; {flops / 1e9:.2f} GFLOP at {rates[rate] / 1e12:.0f} "
           f"TFLOP/s {rate} = {t_ops:.4f} ms; peaks of the {part} data "
           f"sheet")
    return max(t_bytes, t_ops), bound_by, how


@functools.lru_cache(maxsize=256)
def live_pairs(s, t, causal, window):
    """The (query, key) pairs that the causal mask and the window leave
    live: keys k < T with k <= q (causal) and q - k < window (window > 0)."""
    n = 0
    for q in range(s):
        hi = min(t, q + 1) if causal else t
        lo = max(0, q - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


@functools.lru_cache(maxsize=256)
def live_keys(s, t, causal, window):
    """The keys that some live (query, key) pair of ``live_pairs`` reads:
    a kernel that skips dead tiles never needs the others (under the
    top-left causal mask, keys S..T-1 of an S < T call)."""
    n = end = 0
    for q in range(s):      # each query's range [lo, hi) moves right
        hi = min(t, q + 1) if causal else t
        lo = max(0, q - window + 1) if window > 0 else 0
        lo = max(lo, end)
        if hi > lo:
            n, end = n + hi - lo, hi
    return n


def head_dims(shape):
    """(D, Dv) of an attention shape (B, H, KH, S, T, D[, Dv])."""
    return shape[5], shape[6] if len(shape) > 6 else shape[5]


def attn_work(shape, el, causal, window=0):
    """Bytes each attention kernel must move and the FLOPs of its products
    at ``shape`` (B, H, KH, S, T, D[, Dv]) with ``el``-byte elements,
    counting the live (query, key) pairs only (``live_pairs``: the causal
    triangle, cut by the window) and the K and V rows they read
    (``live_keys``); dK and dV are written at all T rows. Q K^T and dq = dS
    K run over D, P V and dO V^T over Dv."""
    b, h, kh, s, t = shape[:5]
    d, dv = head_dims(shape)
    pairs = b * h * live_pairs(s, t, causal, window)
    q, o = b * h * s * d * el, b * h * s * dv * el
    keys = live_keys(s, t, causal, window)
    k, v, rows = b * kh * keys * d * el, b * kh * keys * dv * el, \
        b * h * s * 4
    dk, dv_ = b * kh * t * d * el, b * kh * t * dv * el
    return {    # K1: q, k, v, o, lse; K2: + dO, dq, delta; K3: dk, dv
        "fwd": (q + k + v + o + rows, 2 * pairs * (d + dv)),
        "dq": (2 * q + k + v + 2 * o + 2 * rows, 2 * pairs * (2 * d + dv)),
        "dkv": (q + o + k + v + dk + dv_ + 2 * rows,
                2 * pairs * (2 * d + 2 * dv)),
    }


def rms_work(rows, d, el, split=False):
    """Bytes K4 ("fwd") and K5 ("bwd") must move at ``rows`` x ``d`` with
    ``el``-byte x and dy (x read and out written; x, dy read and dx
    written; the fp32 scale, dscale and rinv once each), and their fp32
    operations, about 4 and 10 a value. ``split``: the split-row route
    (a part of a row; each pass also writes its per-row partial and reads
    the whole rows' sums back)."""
    n = rows * d
    extra = 8 * rows if split else 0
    return {"fwd": (2 * n * el + 4 * d + 4 * rows + extra, 4 * n),
            "bwd": (3 * n * el + 8 * d + 4 * rows + extra, 10 * n)}


def wkv6_work(shape, el, w_el):
    """Bytes each WKV6 kernel must move (each input read once, each output
    written once) and its fp32 operations at ``shape`` (B, S, H, P, chunk)
    with ``el``-byte r/k/v and ``w_el``-byte wlog; an exp counts as one
    operation, a multiply-add as two. Per (b, h) and chunk of cs rows and
    its cs (cs - 1) / 2 live pairs (t, j), each pairwise decay
    exp(lprev_t - L_j) counted once (a subtraction and an exp): K6 takes
    4 cs P^2 + 2 P^2 for the carried state and its update, 7 per pair and
    column (the decay 2, the att dot 3, att·v 2) and ~9 cs P elementwise;
    K7 takes 8 cs P^2 + 4 P^2 for its four state products, 14 per pair and
    column (the decay 2, att 3, dr_att 3, dk_att 2 with dA·decay shared,
    dA 2, dv 2) and ~20 cs P elementwise. Returns {"fwd": with states,
    "primal": without, "bwd", "fwd_design": the bytes K6's two launches
    move as designed, with or without states: the scan reads k, v, wlog and
    s0 and writes every S_c (the states, or a scratch of their size) and
    s_end; the chunk launch reads r, k, v, wlog, u and the S_c and writes
    o; "bwd_design": the bytes K7's two launches move as designed, each
    reading dO once: the scan reads r, wlog, dO and dS_end and writes every
    G_c (the size of the states) and ds0; the chunk launch reads r, k, v,
    wlog, u, dO, the states and the G_c and writes the gradients and the du
    partials}."""
    b, s, h, p, cs = shape
    n, pp, bh = b * s * h * p, b * h * p * p, b * h
    nc, pairs = s // cs, cs * (cs - 1) // 2
    ins = 3 * n * el + n * w_el + h * p * 4
    states = bh * nc * p * p * 4
    fwd_ops = bh * nc * (4 * cs * p * p + 2 * p * p + 7 * pairs * p
                         + 9 * cs * p)
    bwd_ops = bh * nc * (8 * cs * p * p + 4 * p * p + 14 * pairs * p
                         + 20 * cs * p)
    primal = ins + 2 * pp * 4 + n * 4               # + s0, s_end, o
    outs = 3 * n * el + n * w_el                    # dr/dk/dv, dwlog
    fwd_scan = 2 * n * el + n * w_el + pp * 4 + states + pp * 4
    fwd_chunks = ins + states + n * 4
    scan = n * el + n * w_el + n * 4 + pp * 4 + states + pp * 4
    chunks = ins + n * 4 + 2 * states + outs + bh * nc * p * 4
    return {"fwd": (primal + states, fwd_ops), "primal": (primal, fwd_ops),
            "fwd_design": (fwd_scan + fwd_chunks, fwd_ops),
            # + states, dO, dS_end; dr/dk/dv, dwlog, ds0, du per (b, h)
            "bwd": (ins + states + n * 4 + pp * 4 + outs + pp * 4
                    + bh * p * 4, bwd_ops),
            "bwd_design": (scan + chunks, bwd_ops)}
