"""Port parity for the dry run's counter (``launch/op_count.py``), the
counterpart of ``repro/launch/hlo_analysis.py``.

FLOPs: the port's model on ``meta`` tensors (``use_kernels=False``, fp32,
batch 2 x 64) under ``OpCounter`` against ``hlo_analysis.analyze`` of the
reference's ``jax.jit(...).lower(...).compile()`` on the CPU, for every
config's smoke version: the forward with every output kept, tolerance 0;
``value_and_grad`` of the loss, tolerance 0 but for four gaps, each named
with its cause in ``GRAD_GAPS``. The counter's conventions: a matmul's
bytes, a view's, a loop counted by its trip count against the loop in
full (the blockwise attention's key blocks, the accumulation's
microbatches with their ZeRO-2 collectives), the kernel wrappers' meta
path and charges, the peak; and the kernel work formulas against the
kernel table's figures.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import configs  # noqa: E402
from repro_torch.configs import EngineConfig  # noqa: E402
from repro_torch.core.distributed import recording_world  # noqa: E402
from repro_torch.core.engine import Trainer  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.launch import op_count  # noqa: E402
from repro_torch.launch.op_count import OpCounter  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402
from repro_torch.models.blockwise import \
    blockwise_attention_qchunked  # noqa: E402

ARCHS = ("vit-b16", "chatglm3-6b", "qwen2.5-14b", "glm4-9b", "gemma3-12b",
         "granite-moe-3b-a800m", "deepseek-v3-671b", "qwen2-vl-72b",
         "rwkv6-7b", "hubert-xlarge", "zamba2-2.7b")
B, S = 2, 64
# value_and_grad: port minus reference FLOPs at the smoke configs, and why
GRAD_GAPS = {
    # the reference's combine weights are a three-operand einsum
    # (repro/models/moe.py:61), so the gates' gradient is a dot that
    # contracts the E experts: 2·B·S·k·E = 2·128·2·4 = 2,048 FLOPs a MoE
    # layer; the port scales the one-hot by the gates elementwise first
    # (models/moe.py::top_k_routing), which is no matmul (two MoE layers)
    "granite-moe-3b-a800m": -4_096,
    "deepseek-v3-671b": -2_048,            # its one MoE layer
    # both recompute each chunk's body of the plain WKV6 in the backward
    # (jax.checkpoint; torch.utils.checkpoint); XLA drops the recomputed
    # products the backward does not read, torch recomputes the body
    "rwkv6-7b": 1_114_112,
    # the port checkpoints a layer's whole SSD scan (models/mamba2.py::
    # _ssd_chunk_scan: every chunk at once, no (chunk, chunk, H) decay
    # tensor kept) and recomputes its einsums in the backward, 17,301,504
    # FLOPs; XLA recomputes 1,048,576 of the reference's checkpointed
    # per-chunk body
    "zamba2-2.7b": 16_252_928,
}


def _specs(cfg):
    """{name: (shape, kind)} of a smoke batch of B x S."""
    if cfg.arch_type == "audio":
        return {"features": ((B, S, cfg.audio_feat_dim), "f"),
                "mask": ((B, S), "b"), "labels": ((B, S), "i")}
    if cfg.arch_type == "vit":
        return {"images": ((B, cfg.image_size, cfg.image_size, 3), "f"),
                "labels": ((B,), "i")}
    out = {"tokens": ((B, S), "i")}
    if cfg.arch_type == "vlm":
        out["image_embeds"] = ((B, 8, cfg.d_model), "f")
        out["positions"] = ((B, S, 3), "i")
    return out


def _reference_flops(arch, grad):
    import jax
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro.launch import hlo_analysis
    from repro.models import transformer as ref_model
    cfg = ref_configs.get_smoke_config(arch).replace(dtype="float32",
                                                     use_pallas=False)
    kinds = {"f": jnp.float32, "b": jnp.bool_, "i": jnp.int32}
    pshapes = jax.eval_shape(lambda k: ref_model.init_params(cfg, k),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    batch = {k: jax.ShapeDtypeStruct(s, kinds[d])
             for k, (s, d) in _specs(cfg).items()}
    if grad:
        fn = jax.value_and_grad(
            lambda p, b: ref_model.loss_fn(cfg, p, b)[0])
    else:
        # every output kept: XLA drops an unused MTP head otherwise
        def fn(p, b):
            return ref_model.forward(cfg, p, b, mode="train")
    hlo = jax.jit(fn).lower(pshapes, batch).compile().as_text()
    return hlo_analysis.analyze(hlo).flops


def _port_flops(arch, grad):
    cfg = configs.get_smoke_config(arch).replace(dtype="float32",
                                                 use_kernels=False)
    kinds = {"f": torch.float32, "b": torch.bool, "i": torch.int32}
    params = model.init_params(cfg, device="meta")
    batch = {k: torch.empty(s, dtype=kinds[d], device="meta")
             for k, (s, d) in _specs(cfg).items()}
    with OpCounter() as c:
        if grad:
            leaves = [p.requires_grad_() for p in params.values()]
            loss, _ = model.loss_fn(cfg, params, batch)
            torch.autograd.grad(loss, leaves)
        else:
            model.forward(cfg, params, batch, mode="train")
    return c.totals.flops


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_flops_equal_the_reference_analyzer(arch):
    assert _port_flops(arch, False) == _reference_flops(arch, False)


@pytest.mark.parametrize("arch", ARCHS)
def test_value_and_grad_flops_equal_the_reference_but_named_gaps(arch):
    gap = _port_flops(arch, True) - _reference_flops(arch, True)
    assert gap == GRAD_GAPS.get(arch, 0)


# --- conventions ---------------------------------------------------------------

def test_a_matmul_counts_its_macs_twice_and_its_three_tensors_once():
    m, k, n = 24, 40, 8
    a = torch.empty((m, k), device="meta")
    b = torch.empty((k, n), dtype=torch.bfloat16, device="meta")
    with OpCounter() as c:
        a.to(torch.bfloat16) @ b
    assert c.by_op["aten.mm"] == [2 * m * k * n, (m * k + k * n + m * n) * 2,
                                  1]
    # the cast reads fp32 and writes bf16
    assert c.by_op["aten._to_copy"][1] == m * k * (4 + 2)


def test_views_and_allocations_count_nothing():
    x = torch.empty((4, 6, 8), device="meta")
    with OpCounter() as c:
        x.view(24, 8).t().reshape(8, 4, 6).transpose(0, 1)[1:].detach()
        torch.empty((100, 100), device="meta")
        x.unsqueeze(0).expand(3, 4, 6, 8).permute(1, 0, 2, 3)
    assert c.totals.hbm_bytes == 0 and c.totals.flops == 0
    with OpCounter() as c:
        x.contiguous()              # already contiguous: a no-op
        x.transpose(0, 1).contiguous()
    assert c.totals.hbm_bytes == 2 * x.numel() * 4


def _blockwise(q, k, v, grad):
    out = blockwise_attention_qchunked(q, k, v, 0, causal=True, block_k=16,
                                       block_q=32)
    if grad:
        torch.autograd.grad(out.sum(), (q, k, v))


@pytest.mark.parametrize("grad", [False, True])
def test_a_loop_counted_by_trip_count_equals_it_counted_in_full(grad):
    """``models/blockwise.py``'s key blocks (8 of 16 keys, and in the
    backward too): skipping the repeats counts the same FLOPs and bytes as
    running every block, on meta and on the CPU."""
    for device in ("meta", "cpu"):
        q, k, v = (torch.randn((2, 128, 4, 32), device=device,
                               requires_grad=grad) for _ in range(3))
        with OpCounter() as full:
            _blockwise(q, k, v, grad)
        with OpCounter(skip_repeats=True) as skip:
            _blockwise(q, k, v, grad)
        assert skip.totals.flops == full.totals.flops > 0
        assert skip.totals.hbm_bytes == full.totals.hbm_bytes


def test_rwkv6s_chunk_loop_without_grad_counts_by_trip_count():
    """The plain WKV6's chunk loop (``models/rwkv6.py::wkv6_chunked``, 4
    chunks of 16) runs one chunk under a skipping counter when no
    gradient is taken (prefill): the same FLOPs and bytes."""
    from repro_torch.models.rwkv6 import wkv6_chunked
    r, k, v, w = (torch.empty((2, 64, 2, 16), device="meta")
                  for _ in range(4))
    u, s0 = torch.empty((2, 16), device="meta"), \
        torch.empty((2, 2, 16, 16), device="meta")
    with torch.no_grad():
        with OpCounter() as full:
            o, _ = wkv6_chunked(r, k, v, w, u, 16, s0)
        with OpCounter(skip_repeats=True) as skip:
            o2, _ = wkv6_chunked(r, k, v, w, u, 16, s0)
    assert o.shape == o2.shape == (2, 64, 2, 16)
    assert skip.totals.flops == full.totals.flops > 0
    assert skip.totals.hbm_bytes == full.totals.hbm_bytes


@pytest.mark.parametrize("zero", [0, 2, 3])
def test_accumulation_counted_by_trip_count_equals_it_in_full(zero):
    """A ViT smoke step at accum 4 on rank 0 of a recording world of 2:
    FLOPs, bytes and every collective (ZeRO-2 reduce-scatters each
    microbatch, ZeRO-3 gathers each layer in each) the same whether the
    counter skips the microbatches or runs them."""
    cfg = configs.get_smoke_config("vit-b16").replace(dtype="float32")
    batch = {"images": torch.empty((16, 32, 32, 3), device="meta"),
             "labels": torch.empty((16,), dtype=torch.int64, device="meta")}
    got = []
    for skip in (False, True):
        trainer = Trainer(cfg, EngineConfig(
            train_batch_size=16, gradient_accumulation_steps=4,
            zero_stage=zero, guard_anomalies=False), device="meta",
            world=recording_world(0, 2))
        state = trainer.init_state(model.init_params(cfg, device="meta"))
        with OpCounter(skip_repeats=skip) as c:
            trainer.train_step(state, batch)
        got.append(c.totals)
    full, skipped = got
    assert skipped.flops == full.flops > 0
    assert skipped.hbm_bytes == full.hbm_bytes
    assert skipped.coll == full.coll and sum(full.coll.values()) > 0


def test_peak_counts_the_args_the_saved_activations_and_the_op():
    x = torch.empty((64, 256), device="meta", requires_grad=True)
    w = torch.empty((256, 512), device="meta", requires_grad=True)
    with OpCounter(args_bytes=x.numel() * 4 + w.numel() * 4,
                   arg_tensors=[x, w]) as c:
        h = torch.tanh(x @ w)             # saves x, w (args) and tanh's out
        y = h @ w.t()
        torch.autograd.grad(y.sum(), (x, w))
    act = 64 * 512 * 4
    assert c.peak_saved >= act
    assert c.peak_bytes >= c.args_bytes + act
    assert c.saved_bytes == 0             # freed after the backward


# --- the kernel wrappers on meta -------------------------------------------------

def test_kernel_wrappers_on_meta_charge_their_work_and_launch_nothing():
    """On ``meta`` each wrapper returns empty outputs of its kernel's
    shapes, charges ``op_count``'s work formula, and counts no launch."""
    before = (fa.flash_attention_fwd.launches, rms.fused_rmsnorm_fwd.launches,
              wk.wkv6_fwd.launches)
    shape = (2, 4, 2, 64, 64, 48, 32)
    q = torch.empty((2, 4, 64, 48), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 2, 64, 48), dtype=torch.bfloat16, device="meta")
    v = torch.empty((2, 2, 64, 32), dtype=torch.bfloat16, device="meta")
    with OpCounter() as c:
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse,
                                              torch.empty_like(out))
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, torch.empty_like(out),
                                            lse, delta)
    work = op_count.attn_work(shape, 2, True)
    assert (out.shape, lse.shape, dq.shape, dk.shape, dv.shape) == \
        ((2, 4, 64, 32), (2, 4, 64), q.shape, k.shape, v.shape)
    for name, part in (("flash_fwd", "fwd"), ("flash_bwd_dq", "dq"),
                       ("flash_bwd_dkv", "dkv")):
        nbytes, flops = work[part]
        assert c.by_op[f"kernel.{name}"] == [flops, nbytes, 1]
    x = torch.empty((3, 5, 64), dtype=torch.bfloat16, device="meta")
    scale = torch.empty((64,), device="meta")
    with OpCounter() as c:
        y, rinv = rms.fused_rmsnorm_fwd(x, scale)
        rms.fused_rmsnorm_bwd(x, scale, rinv, torch.empty_like(x))
    assert y.shape == x.shape and rinv.shape == (15,)
    w = op_count.rms_work(15, 64, 2)
    assert c.by_op["kernel.rmsnorm_fwd"][:2] == [w["fwd"][1], w["fwd"][0]]
    assert c.by_op["kernel.rmsnorm_bwd"][:2] == [w["bwd"][1], w["bwd"][0]]
    b, s, h, p, chunk = 2, 64, 2, 32, 16
    r = torch.empty((b, s, h, p), dtype=torch.bfloat16, device="meta")
    u = torch.empty((h, p), device="meta")
    s0 = torch.empty((b, h, p, p), device="meta")
    with OpCounter() as c:
        o, s_end, states = wk.wkv6_fwd(r, r, r, r, u, s0, chunk=chunk,
                                       with_states=True)
        wk.wkv6_bwd(r, r, r, r, u, states, o, s_end, chunk=chunk)
    w = op_count.wkv6_work((b, s, h, p, chunk), 2, 2)
    assert c.by_op["kernel.wkv6_fwd"][:2] == [w["fwd"][1], w["fwd"][0]]
    assert c.by_op["kernel.wkv6_bwd"][:2] == [w["bwd"][1], w["bwd"][0]]
    assert (fa.flash_attention_fwd.launches, rms.fused_rmsnorm_fwd.launches,
            wk.wkv6_fwd.launches) == before


def test_the_kernel_path_on_meta_counts_as_the_kernels_charge():
    """A smoke decoder step with ``use_kernels`` on ``meta``: its
    attention and norms are the kernels' charges, one a layer and norm."""
    cfg = configs.get_smoke_config("chatglm3-6b").replace(
        use_kernels=True, dtype="bfloat16")
    params = model.init_params(cfg, device="meta")
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                   device="meta")}
    with OpCounter() as c:
        leaves = [p.requires_grad_() for p in params.values()]
        loss, _ = model.loss_fn(cfg, params, batch)
        torch.autograd.grad(loss, leaves)
    kernels = {k: v[2] for k, v in c.by_op.items() if k.startswith("kernel.")}
    layers = cfg.num_layers
    assert kernels == {"kernel.flash_fwd": layers,
                       "kernel.flash_bwd_dq": layers,
                       "kernel.flash_bwd_dkv": layers,
                       "kernel.rmsnorm_fwd": 2 * layers + 1,
                       "kernel.rmsnorm_bwd": 2 * layers + 1}


# --- one work formula --------------------------------------------------------------

def test_work_formulas_give_the_kernel_tables_figures():
    """``PERF.md``'s kernel table (bf16): K4 67.1 MB and K5 100.7 MB at
    4096 x 4096, K6 377.5 MB and K7 12.70 GFLOP at B 4, S 1024, H 64, P
    64, chunk 32 with an fp32 log-decay (``chip_smoke.py`` imports these
    formulas)."""
    rms_w = op_count.rms_work(4096, 4096, 2)
    assert round(rms_w["fwd"][0] / 1e6, 1) == 67.1
    assert round(rms_w["bwd"][0] / 1e6, 1) == 100.7
    wkv = op_count.wkv6_work((4, 1024, 64, 64, 32), 2, 4)
    assert round(wkv["fwd"][0] / 1e6, 1) == 377.5
    assert round(wkv["bwd"][1] / 1e9, 2) == 12.70
    ms, by, _ = op_count.bound("NVIDIA H100 80GB HBM3", *rms_w["fwd"],
                               rate="fp32")
    assert by == "bytes" and round(ms, 4) == 0.0200
    assert op_count.live_pairs(4, 4, True, 0) == 10
    assert op_count.live_keys(2, 6, True, 0) == 2
    assert op_count.head_dims((1, 2, 2, 3, 3, 192, 128)) == (192, 128)
