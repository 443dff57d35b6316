"""Port parity for the 1-bit error-feedback optimizers
(``repro_torch/optim/onebit.py``): the reference's five properties
(``tests/test_onebit.py``, with its hypothesis settings) on the port, then
``compress_ef`` and three updates of ``onebit_adamw``, ``onebit_sgd`` and
``onebit_lamb`` against ``repro.optim.onebit`` on the same numpy inputs,
the error buffer and the inner moments included, and the in-place
``apply`` against the functional ``update``. Tolerance: 1e-6, one
optimizer update's (``tests/test_torch_train.py``).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("hypothesis")  # dev-only dep (requirements-dev.txt)

import threading  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.optim import onebit as ref_onebit  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.specs import concrete_batch  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import OneBitState, make_onebit_optimizer  # noqa: E402
from repro_torch.optim.onebit import compress_ef, \
    compressed_bytes  # noqa: E402

OPT_TOL = 1e-6
BASES = ("adamw", "sgd", "lamb")
SHAPES = {"w": (16, 8), "b": (8,), "s": ()}


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# --- the reference's five properties, on the port ------------------------------

@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 16))
def test_error_feedback_is_lossless_in_sum(seed):
    """q_t + e_t == g_t + e_{t-1}: no gradient mass is lost."""
    gen = np.random.default_rng(seed)
    g = _t(gen.standard_normal(64))
    err = _t(0.1 * gen.standard_normal(64))
    q, new_err = compress_ef(g, err)
    np.testing.assert_allclose((q + new_err).numpy(), (g + err).numpy(),
                               atol=1e-6)


def test_compression_is_one_bit():
    g = _t(np.random.default_rng(0).standard_normal(128))
    q, _ = compress_ef(g, torch.zeros(128))
    assert len(np.unique(np.abs(q.numpy()))) == 1     # single magnitude
    assert compressed_bytes(128 * 4) == 16.0          # 32x fewer wire bytes


def test_error_accumulates_and_corrects():
    """With error feedback the running sum of compressed gradients tracks
    the running sum of the true ones; the gap is the final error buffer."""
    gs = _t(np.random.default_rng(1).standard_normal((50, 16)))
    err = torch.zeros(16)
    q_sum = torch.zeros(16)
    for g in gs:
        q, err = compress_ef(g, err)
        q_sum = q_sum + q
    np.testing.assert_allclose((gs.sum(0) - q_sum).numpy(), err.numpy(),
                               atol=1e-4)


def test_onebit_lamb_converges():
    opt = make_onebit_optimizer("lamb", weight_decay=0.0, grad_clip=0.0)
    w = {"w": torch.tensor([3.0, -2.0, 1.5, 0.7])}
    state = opt.init(w)
    l0 = float(torch.sum(w["w"] ** 2))
    for _ in range(80):
        w, state, _ = opt.update({"w": 2 * w["w"]}, state, w, 0.05)
    assert float(torch.sum(w["w"] ** 2)) < l0 * 0.3


def test_onebit_end_to_end_training():
    """ChatGLM3's smoke model, fp32, trains 12 steps with 1-bit AdamW on
    one batch: the loss falls by more than 0.1."""
    cfg = configs.get_smoke_config("chatglm3-6b").replace(dtype="float32")
    params = transformer.init_params(cfg, seed=0, device="cpu")
    opt = make_onebit_optimizer("adamw", weight_decay=0.0)
    state = opt.init(params)
    batch = {k: torch.from_numpy(v)
             for k, v in concrete_batch(cfg, 4, 32, seed=0).items()}
    losses = []
    for _ in range(12):
        view = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss, _ = transformer.loss_fn(cfg, view, batch)
        grads = dict(zip(view, torch.autograd.grad(loss, list(
            view.values()))))
        params, state, _ = opt.update(grads, state, params, 1e-3)
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] - 0.1, losses


# --- parity with the reference -------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_compress_ef_matches_reference(seed):
    gen = np.random.default_rng(seed)
    g = gen.standard_normal((32, 5)).astype(np.float32)
    err = (0.3 * gen.standard_normal((32, 5))).astype(np.float32)
    q, new_err = compress_ef(_t(g), _t(err))
    rq, rerr = ref_onebit.compress_ef(jnp.asarray(g), jnp.asarray(err))
    np.testing.assert_allclose(q.numpy(), np.asarray(rq), atol=OPT_TOL,
                               rtol=0)
    np.testing.assert_allclose(new_err.numpy(), np.asarray(rerr),
                               atol=OPT_TOL, rtol=0)


def _draws(seed, steps=3):
    gen = np.random.default_rng(seed)
    params = {k: gen.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: gen.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("base", BASES)
def test_onebit_updates_match_reference(base):
    """Three updates from the same params and gradients: the params, the
    error buffer and the inner moments within 1e-6 of the reference's, the
    returned grad norm (q's) within 1e-6 of itself."""
    params, grads = _draws(0)
    kw = {"weight_decay": 0.01, "grad_clip": 1.0}
    ref = ref_onebit.make_onebit_optimizer(base, **kw)
    port = make_onebit_optimizer(base, **kw)
    assert port.name == ref.name == f"onebit_{base}"
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: _t(v) for k, v in params.items()}
    rs, ps = ref.init(rp), port.init(pp)
    for g in grads:
        rp, rs, rn = ref.update({k: jnp.asarray(v) for k, v in g.items()},
                                rs, rp, 1e-2)
        pp, ps, pn = port.update({k: _t(v) for k, v in g.items()}, ps, pp,
                                 1e-2)
        # the norm (~11 here) relative: fp32 holds it to ~1e-7 of itself
        assert abs(float(pn) - float(rn)) <= OPT_TOL * float(rn)
        for k in SHAPES:
            pairs = [(pp[k], rp[k]), (ps.error[k], rs.error[k]),
                     (ps.inner.mu[k], rs.inner.mu[k])]
            if base != "sgd":
                pairs.append((ps.inner.nu[k], rs.inner.nu[k]))
            for got, want in pairs:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           atol=OPT_TOL, rtol=0, err_msg=k)
    assert ps.inner.step == int(rs.inner.step) == len(grads)


@pytest.mark.parametrize("base", BASES)
def test_apply_is_update_in_place(base):
    """``apply`` writes the params, the error buffer and the moments in
    place, bitwise what ``update`` returns; ``update`` leaves its inputs
    as they were."""
    params, grads = _draws(1)
    opt = make_onebit_optimizer(base)
    fp = {k: _t(v) for k, v in params.items()}
    ip = {k: t.clone() for k, t in fp.items()}
    fs, istate = opt.init(fp), opt.init(ip)
    for g in grads:
        g = {k: _t(v) for k, v in g.items()}
        keep = {k: t.clone() for k, t in fp.items()}
        fp, fs, _ = opt.update(g, fs, fp, 1e-2)
        assert not all(torch.equal(keep[k], fp[k]) for k in fp)
        istate = opt.apply({k: t.clone() for k, t in g.items()}, istate, ip,
                           1e-2)
        assert isinstance(istate, OneBitState)
        for k in fp:
            assert torch.equal(ip[k], fp[k]), k
            assert torch.equal(istate.error[k], fs.error[k]), k
            assert torch.equal(istate.inner.mu[k], fs.inner.mu[k]), k


def test_chunked_scale_is_the_whole_tensors():
    """Two ranks (threads), each handed its half of every tensor and a
    ``reduce`` that sums over both: ``update`` scales by the whole
    tensor's mean|v| (and LAMB's trust ratio and the norm see whole
    tensors), so the halves are those of the whole update."""
    params, grads = _draws(2, steps=1)
    opt = make_onebit_optimizer("lamb")
    whole = {k: _t(v).reshape(-1) for k, v in params.items() if v.ndim}
    g = {k: _t(grads[0][k]).reshape(-1) for k in whole}
    want, want_state, want_norm = opt.update(g, opt.init(whole), whole, 1e-2)
    barrier, posted, out = threading.Barrier(2), [None, None], [None, None]

    def rank(i):
        def reduce(local):
            posted[i] = local
            barrier.wait()
            total = {k: posted[0][k] + posted[1][k] for k in local}
            barrier.wait()
            return total
        p = {k: t.chunk(2)[i] for k, t in whole.items()}
        out[i] = opt.update({k: t.chunk(2)[i] for k, t in g.items()},
                            opt.init(p), p, 1e-2, reduce=reduce)
    threads = [threading.Thread(target=rank, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for k in whole:
        for got, ref in ((torch.cat([o[0][k] for o in out]), want[k]),
                         (torch.cat([o[1].error[k] for o in out]),
                          want_state.error[k])):
            np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                       atol=OPT_TOL, rtol=0, err_msg=k)
    assert abs(float(out[0][2]) - float(want_norm)) <= \
        OPT_TOL * float(want_norm)
