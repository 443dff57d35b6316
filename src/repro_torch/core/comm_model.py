"""Analytic communication and compute cost model, the "cluster simulator"
(``repro/core/comm_model.py``, with the same functions and signatures).

The paper measures the wall-clock cost of synchronisation on real GPU
clusters (Figs. 4-6, 14-15). One card cannot show it, so scaling curves are
modelled: a measured single-device compute time times an analytic
collective model, with the constants of one NVIDIA H100 SXM5 node (and the
paper's clusters, for the heterogeneous Tesla reproduction).

Ring all-reduce time:  t = 2 (n-1)/n * bytes / bw   (+ per-hop latency)
Hierarchical (multi-node): reduce-scatter inside the node (NVLink) ->
all-reduce across nodes (InfiniBand) -> all-gather inside the node.

:class:`Hardware`'s fields against the reference's TPU ones: ``nvlink_bw``
is ``ici_bw`` (the fast links inside a node or pod), ``ib_bw`` is
``dcn_bw`` (the network between them, per device), ``pcie_bw`` is
``host_infeed_bw`` (host memory to device memory).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence


@dataclass(frozen=True)
class Hardware:
    """One NVIDIA H100 SXM5 at its 700 W power limit, in an 8-card node
    (NVIDIA H100 Tensor Core GPU datasheet; DGX H100 datasheet for the
    network). Every rate is one direction, dense, without sparsity."""
    name: str = "h100_sxm5_700w"
    # bf16 tensor cores, dense: 989 TFLOP/s (H100 SXM5, 700 W; the
    # datasheet's 1,979 is with 2:4 sparsity)
    peak_flops: float = 989e12
    # HBM3: 3.35 TB/s (H100 SXM5 80 GB, 700 W)
    hbm_bw: float = 3.35e12
    # NVLink 4: 900 GB/s per card over both directions, 450 GB/s each way
    # (H100 SXM5, 700 W)
    nvlink_bw: float = 450e9
    # one ConnectX-7 NDR InfiniBand port per card: 400 Gb/s = 50 GB/s
    # each way (DGX H100: eight H100 SXM5 at 700 W)
    ib_bw: float = 50e9
    link_latency: float = 1e-6        # s per hop (the model's assumption)
    # PCIe Gen5 x16: 128 GB/s over both directions, 64 GB/s each way
    # (H100 SXM5, 700 W)
    pcie_bw: float = 64e9


H100_SXM = Hardware()

# The paper's clusters (§III Fig.3), fp32 GEMM throughput estimates.
GPU_SPECS = {
    "rtx3070": 20.3e12, "gtx1070": 6.5e12, "tesla_p4": 5.5e12,
    "t4": 8.1e12, "rtx2080ti": 13.4e12,
}


def allreduce_time(nbytes: float, n: int, bw: float,
                   latency: float = 1e-6) -> float:
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * nbytes / bw + 2 * (n - 1) * latency


def reduce_scatter_time(nbytes: float, n: int, bw: float,
                        latency: float = 1e-6) -> float:
    if n <= 1:
        return 0.0
    return (n - 1) / n * nbytes / bw + (n - 1) * latency


def allgather_time(nbytes: float, n: int, bw: float,
                   latency: float = 1e-6) -> float:
    return reduce_scatter_time(nbytes, n, bw, latency)


def hierarchical_allreduce_time(nbytes: float, intra: int, pods: int,
                                hw: Hardware = H100_SXM) -> float:
    """reduce-scatter (NVLink) -> cross-node all-reduce (InfiniBand) ->
    all-gather (NVLink); ``pods`` is the number of nodes."""
    t = reduce_scatter_time(nbytes, intra, hw.nvlink_bw, hw.link_latency)
    t += allreduce_time(nbytes / max(intra, 1), pods, hw.ib_bw, 50e-6)
    t += allgather_time(nbytes, intra, hw.nvlink_bw, hw.link_latency)
    return t


@dataclass
class StepModel:
    """DeepSpeed-style data-parallel step time model.

    compute_times: per-device per-microbatch fwd+bwd seconds; heterogeneous
    clusters (the paper's Tesla setup) pass unequal values, and the step
    synchronises on the slowest device (the paper's §IV-B observation).
    """
    grad_bytes: float
    compute_times: Sequence[float] = field(default_factory=lambda: [1.0])
    comm_bw: float = H100_SXM.nvlink_bw
    latency: float = 1e-6
    accum_steps: int = 1
    infeed_bytes_per_mb: float = 0.0
    infeed_bw: float = H100_SXM.pcie_bw

    def step_time(self) -> float:
        n = len(self.compute_times)
        compute = max(self.compute_times) * self.accum_steps
        infeed = self.infeed_bytes_per_mb * self.accum_steps / self.infeed_bw
        sync = allreduce_time(self.grad_bytes, n, self.comm_bw, self.latency)
        return compute + max(infeed - compute, 0.0) + sync

    def sync_fraction(self) -> float:
        n = len(self.compute_times)
        sync = allreduce_time(self.grad_bytes, n, self.comm_bw, self.latency)
        return sync / self.step_time()


def strong_scaling_times(single_dev_time: float, grad_bytes: float,
                         device_counts: Sequence[int],
                         comm_bw: float = H100_SXM.nvlink_bw,
                         hetero: Sequence[float] | None = None):
    """Fixed global workload split across n devices (paper Figs. 4, 8, 14).
    hetero: optional per-device relative speeds (1.0 = reference)."""
    out = []
    for n in device_counts:
        speeds = (hetero or [1.0] * n)[:n]
        per_dev = [single_dev_time / n / s for s in speeds]
        m = StepModel(grad_bytes=grad_bytes, compute_times=per_dev,
                      comm_bw=comm_bw)
        out.append(m.step_time())
    return out


def weak_scaling_times(single_dev_time: float, grad_bytes: float,
                       device_counts: Sequence[int],
                       comm_bw: float = H100_SXM.nvlink_bw,
                       hetero: Sequence[float] | None = None):
    """Per-device workload fixed (paper Figs. 5, 9, 17)."""
    out = []
    for n in device_counts:
        speeds = (hetero or [1.0] * n)[:n]
        per_dev = [single_dev_time / s for s in speeds]
        m = StepModel(grad_bytes=grad_bytes, compute_times=per_dev,
                      comm_bw=comm_bw)
        out.append(m.step_time())
    return out
