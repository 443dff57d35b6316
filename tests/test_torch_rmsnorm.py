"""Port parity for the fused RMSNorm (K4 forward, K5 backward and their
autograd Function).

On the CPU the wrappers ``fused_rmsnorm_fwd``/``_bwd`` take their plain
versions (``kernels/ref.py::ref_rmsnorm_fwd``/``ref_rmsnorm_bwd``).
``ops.fused_rmsnorm`` through ``FusedRMSNorm`` is held against the JAX
package's ``ref_rmsnorm`` with ``jax.grad`` at the reference's own cases
and bounds (``tests/test_kernel_grads.py:105-137``): 1e-4 in fp32, and
6e-2 for bf16 inputs against the fp32 oracle. The Pallas kernels are
reached only through a probe that skips while this JAX cannot build them.
The CUDA kernels are checked on the card by ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import rmsnorm as ref_rms_mod  # noqa: E402
from repro.kernels.ref import ref_rmsnorm as jax_ref_rmsnorm  # noqa: E402
from repro.models import norms as ref_norms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels.ref import ref_rmsnorm_bwd, \
    ref_rmsnorm_fwd  # noqa: E402
from repro_torch.models import norms  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 6e-2}
EPS = 1e-6

# tests/test_kernel_grads.py RMS_CASES (shape; the Pallas row tile is not
# a parameter of the port's kernels)
RMS_SHAPES = [(64, 256), (3, 37, 128), (2, 2, 2, 512), (1024, 512)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    sc = rng.normal(0, 1, shape[-1:]).astype(np.float32)
    w = rng.normal(0, 1, shape).astype(np.float32)      # cotangent
    return x, sc, w


def _jax_grads(x, sc, w):
    def loss(x, s):
        return jnp.sum(jax_ref_rmsnorm(x, s, EPS).astype(jnp.float32) * w)
    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(sc))


def _port(x, sc, w, dtype):
    """out, dx, dscale of ``ops.fused_rmsnorm`` under autograd."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    st = torch.from_numpy(sc).requires_grad_()
    out = ops.fused_rmsnorm(xt, st, eps=EPS)
    dx, dscale = torch.autograd.grad(
        (out.float() * torch.from_numpy(w)).sum(), (xt, st))
    return out, dx, dscale


def _close(got, want, tol, name):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=name)


@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_rmsnorm_matches_jax_grad(shape, dtype):
    x, sc, w = _inputs(shape)
    xq = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()
    out, dx, dscale = _port(x, sc, w, getattr(torch, dtype))
    assert out.dtype == dx.dtype == getattr(torch, dtype)
    assert dscale.dtype == torch.float32
    assert out.shape == dx.shape == shape and dscale.shape == shape[-1:]
    # bf16 against the fp32 oracle, as the reference test does
    want_out = jax_ref_rmsnorm(jnp.asarray(xq), jnp.asarray(sc), EPS)
    want_dx, want_ds = _jax_grads(xq, sc, w)
    tol = TOL[dtype]
    _close(out, want_out, tol, "out")
    _close(dx, want_dx, tol, "dx")
    _close(dscale, want_ds, tol, "dscale")


def test_rinv_residual_is_fp32_per_row():
    """``tests/test_kernel_grads.py:140-150`` on the port's K4 wrapper."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (6, 37, 128)).astype(np.float32)).bfloat16()
    out, rinv = rms.fused_rmsnorm_fwd(x, torch.ones(128))
    assert out.shape == x.shape and out.dtype == x.dtype
    assert rinv.dtype == torch.float32 and rinv.shape == (6 * 37,)
    want = 1.0 / np.sqrt(np.mean(x.float().numpy() ** 2, axis=-1) + EPS)
    np.testing.assert_allclose(rinv.numpy().reshape(6, 37), want, rtol=1e-2)


@pytest.mark.parametrize("shape", [(5, 7, 96), (1, 1000), (33, 1001)])
def test_plain_backward_is_the_reference_formula(shape):
    """``ref_rmsnorm_bwd`` (the formula of the Pallas ``_bwd_kernel``)
    equals autograd through the plain forward, ragged and odd D too, both
    in fp32."""
    x, sc, w = _inputs(shape, seed=2)
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(sc).requires_grad_()
    out, rinv = ref_rmsnorm_fwd(xt, st, EPS)
    want = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (xt, st))
    dx, dscale = ref_rmsnorm_bwd(xt.detach(), st.detach(), rinv.detach(),
                                 torch.from_numpy(w))
    torch.testing.assert_close(dx, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dscale, want[1], rtol=1e-5, atol=1e-5)


def test_backward_never_differentiates_the_forward(monkeypatch):
    """The graph holds one FusedRMSNorm node over (x, scale); its backward
    runs K5 (here its plain version) and no forward."""
    x, sc, w = _inputs((4, 8, 64), seed=3)
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(sc).requires_grad_()
    out = ops.fused_rmsnorm(xt, st, eps=EPS)
    assert type(out.grad_fn).__name__ == "FusedRMSNormBackward"
    assert [type(f[0]).__name__ for f in out.grad_fn.next_functions] == \
        ["AccumulateGrad"] * 2
    calls = []

    def forbid(*a, **kw):
        raise AssertionError("the backward called a forward")

    def spy(*a, **kw):
        calls.append("bwd")
        return ref_rmsnorm_bwd(*a, **kw)
    monkeypatch.setattr(rms, "fused_rmsnorm_fwd", forbid)
    monkeypatch.setattr(rms, "ref_rmsnorm_fwd", forbid)
    monkeypatch.setattr(rms, "ref_rmsnorm_bwd", spy)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (xt, st))
    assert calls == ["bwd"]
    want = ref_rmsnorm_bwd(xt.detach(), st.detach(),
                           ref_rmsnorm_fwd(xt.detach(), st.detach(), EPS)[1],
                           torch.from_numpy(w))
    for g, r in zip(grads, want):
        assert torch.equal(g, r)


def test_host_checks_reject_bad_inputs():
    x = torch.zeros(4, 64)
    sc = torch.ones(64)
    with pytest.raises(ValueError, match="scale"):
        rms.fused_rmsnorm_fwd(x, torch.ones(63))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rms.fused_rmsnorm_fwd(x.half(), sc)
    with pytest.raises(ValueError, match="scale must be float32"):
        rms.fused_rmsnorm_fwd(x, sc.bfloat16())
    rinv = torch.ones(4)
    with pytest.raises(ValueError, match="dy must be"):
        rms.fused_rmsnorm_bwd(x, sc, rinv, torch.zeros(4, 32))
    with pytest.raises(ValueError, match="dy must be"):
        rms.fused_rmsnorm_bwd(x, sc, rinv, x.bfloat16())
    with pytest.raises(ValueError, match="rinv must be"):
        rms.fused_rmsnorm_bwd(x, sc, rinv.double(), x)
    with pytest.raises(ValueError, match="rinv must be"):
        rms.fused_rmsnorm_bwd(x, sc, torch.ones(5), x)
    # what only the kernels refuse
    rms.check_kernel_inputs(x, sc)
    with pytest.raises(ValueError, match="kernel shapes"):
        rms.check_kernel_inputs(torch.zeros(2, rms.MAX_D + 1),
                                torch.ones(rms.MAX_D + 1))
    with pytest.raises(ValueError, match="kernel shapes"):
        rms.check_kernel_inputs(torch.zeros(0, 64), sc)
    with pytest.raises(ValueError, match="unit stride"):
        rms.check_kernel_inputs(torch.zeros(64, 4).t(), sc)
    with pytest.raises(ValueError, match="unit stride"):
        rms.check_kernel_inputs(x, torch.ones(128)[::2])
    # tensors on more than one device never reach a kernel; on meta (the
    # dry run) the wrapper gives empty outputs of the kernel's shapes and
    # launches nothing
    with pytest.raises(ValueError, match="runs on cuda"):
        rms.fused_rmsnorm_fwd(x, sc.to("meta"))
    before = rms.fused_rmsnorm_fwd.launches
    out, rinv = rms.fused_rmsnorm_fwd(x.to("meta"), sc.to("meta"))
    assert (out.device.type, out.shape, rinv.shape) == \
        ("meta", x.shape, (x.numel() // x.shape[-1],))
    assert rms.fused_rmsnorm_fwd.launches == before


def test_cpu_calls_do_not_count_launches():
    x, sc, w = _inputs((3, 37, 128))
    before = (rms.fused_rmsnorm_fwd.launches, rms.fused_rmsnorm_bwd.launches)
    _port(x, sc, w, torch.float32)
    assert before == (0, 0)
    assert (rms.fused_rmsnorm_fwd.launches,
            rms.fused_rmsnorm_bwd.launches) == (0, 0)


def test_row_layout_copies_only_what_the_kernels_refuse(monkeypatch):
    monkeypatch.setattr(rms.row_layout, "copies", 0)
    model_layout = torch.zeros(4, 1024, 64)
    x2 = rms.row_layout(model_layout)
    assert x2.shape == (4096, 64) and x2.data_ptr() == \
        model_layout.data_ptr()
    row_strided = torch.zeros(8, 80)[:, :64]          # one row stride, 80
    assert rms.row_layout(row_strided).stride() == (80, 1)
    scale_slice = torch.ones(3, 64)[1]                # a stacked param's row
    assert rms.row_layout(scale_slice)[0].data_ptr() == \
        scale_slice.data_ptr()
    assert rms.row_layout.copies == 0
    for odd in (torch.zeros(64, 8).t(),                   # last stride 8
                torch.zeros(4, 6, 64)[:, :5],             # no one row stride
                torch.zeros(2, 3, 64).transpose(0, 1)):
        fixed = rms.row_layout(odd)
        assert fixed.is_contiguous()
        assert torch.equal(fixed, odd.reshape(-1, odd.shape[-1]))
    assert rms.row_layout.copies == 3


@pytest.mark.parametrize("rows", [1, 7, 255, 256, 257, 4096, 4097, 100000])
def test_bwd_blocks_cover_every_row_once(rows):
    """K5 takes the fewest rows per CTA that need at most BWD_BLOCKS (256)
    CTAs: 16 rows a CTA, 256 CTAs, at the decoder's 4096 rows; every CTA
    has at least one row."""
    per, n = rms.bwd_blocks(rows)
    assert n <= rms.BWD_BLOCKS == 256
    assert per == -(-rows // rms.BWD_BLOCKS)
    assert (n - 1) * per < rows <= n * per
    if rows == 4096:
        assert (per, n) == (16, 256)


def _k5_dscale(x, dy, rinv):
    """dscale in K5's order, in fp32: each CTA of ``bwd_blocks(rows)`` sums
    its rows' dy∘x∘rinv in row order into its partial (a workspace row);
    the reduction launch's thread group g of RED_GROUPS = 8 sums the
    partials g, g + 8, ... in turn, and the groups' sums are added in group
    order."""
    rows, d = x.shape
    per, n = rms.bwd_blocks(rows)
    prod = (dy * x) * rinv[:, None]
    prod = torch.nn.functional.pad(prod, (0, 0, 0, n * per - rows))
    ws = torch.zeros(n, d)
    for i in range(per):                 # a zero padded row adds nothing
        ws += prod[i::per][:n]
    groups = torch.zeros(8, d)
    for b in range(n):
        groups[b % 8] += ws[b]
    out = torch.zeros(d)
    for g in range(8):
        out += groups[g]
    return out


@pytest.mark.parametrize("rows,d", [(4096, 4096), (4097, 512), (300, 1001)])
def test_k5_dscale_order_matches_reference(rows, d):
    """K5's blocked, fixed-order dscale (``_k5_dscale``) equals
    ``ref_rmsnorm_bwd``'s within 1e-6 of its largest value, at the
    decoder's 4096 rows and at ragged row counts; the order depends on the
    shape only, so it repeats bit for bit."""
    x, sc, w = _inputs((rows, d), seed=6)
    xt, dyt, st = map(torch.from_numpy, (x, w, sc))
    _, rinv = ref_rmsnorm_fwd(xt, st, EPS)
    got = _k5_dscale(xt, dyt, rinv)
    _, want = ref_rmsnorm_bwd(xt, st, rinv, dyt)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert torch.equal(got, _k5_dscale(xt, dyt, rinv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_dispatch_matches_reference_norm(dtype):
    """``models.norms.rmsnorm`` with the kernels on (their plain version
    here) and off, against ``repro.models.norms.rmsnorm``; a bf16 scale
    view (``cast_params_bf16``) is taken by the kernel path too."""
    x, sc, _ = _inputs((2, 9, 256), seed=4)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = ref_norms.rmsnorm(jnp.asarray(xt.float().numpy()).astype(dtype),
                             jnp.asarray(sc), 1e-5)
    for use_kernels in (True, False):
        got = norms.rmsnorm(xt, torch.from_numpy(sc), 1e-5,
                            use_kernels=use_kernels)
        assert got.dtype == xt.dtype
        _close(got, np.asarray(want, np.float32), TOL[dtype], "out")
    st = torch.from_numpy(sc).bfloat16().requires_grad_()
    out = norms.rmsnorm(xt, st, 1e-5, use_kernels=True)
    (g,) = torch.autograd.grad(out.float().sum(), st)
    assert g.dtype == torch.bfloat16


@pytest.mark.parametrize("shape", RMS_SHAPES[:2])
def test_matches_pallas_interpret(shape):
    """The port against the Pallas kernels themselves in interpret mode,
    where this JAX can build them (ROADMAP caveat R1)."""
    x, sc, w = _inputs(shape, seed=5)
    out, dx, dscale = _port(x, sc, w, torch.float32)

    def loss(x, s):
        y = ref_rms_mod.fused_rmsnorm(x, s, eps=EPS, block_rows=16,
                                      interpret=True)
        return jnp.sum(y * w), y
    try:
        (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                           has_aux=True)(
            jnp.asarray(x), jnp.asarray(sc))
    except AttributeError as e:     # this JAX's Pallas cannot build the call
        pytest.skip(f"Pallas interpret mode does not run with this JAX: {e}")
    _close(out, y, TOL["float32"], "out")
    _close(dx, grads[0], TOL["float32"], "dx")
    _close(dscale, grads[1], TOL["float32"], "dscale")
