"""Port parity for the RWKV6 slice (``rwkv6-7b``): the config, the param
tree, the per-head group norm, token shift and data-dependent lerp, the
time mix and channel mix, the model's logits, loss and gradients, a 3-step
SGD trajectory, the gradients at an ill-conditioned batch, the bf16
gradients of two AdamW steps on both sides (the model's conditioning near
the group norm's eps) and the training CLI.

The reference side is built from the JAX package's pure functions
(``repro.models.rwkv6``, ``model.forward``, ``model.loss_fn`` with
``jax.value_and_grad``, the optimizer ``update``), not from
``DistributedEngine`` (ROADMAP caveat R1). The reference's smoke params
cross with ``params_from_numpy``, with the zero mixes and biases and the
unit norm scales perturbed by numpy noise on both sides so that every
branch matters. Tolerances are ``tests/test_torch_lm.py``'s: logits 1e-4,
loss 1e-5, grads and trajectory 2e-4.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.data import DataPipeline as RefPipeline  # noqa: E402
from repro.models import norms as ref_norms  # noqa: E402
from repro.models import rwkv6 as ref_rwkv6  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro.optim import make_optimizer as ref_make_optimizer  # noqa: E402
from repro.optim import make_schedule as ref_make_schedule  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import EngineConfig, ModelConfig, \
    SSMConfig  # noqa: E402
from repro_torch.core.engine import Trainer, to_device  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.data.synthetic import make_token_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import norms, rwkv6, transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402

ARCH = "rwkv6-7b"
LOGITS_TOL, LOSS_TOL, GRAD_TOL, TRAJ_TOL = 1e-4, 1e-5, 2e-4, 2e-4
VOCAB, SEQ = 512, 48        # 48: a chunk of 32 and a padded tail
EPS_WELL_CONDITIONED = 1e-3  # the group norm's eps for the fp32 gate


def _perturb(tree, rng):
    """Noise on the params that init leaves at 0 or 1, in place."""
    tm, cm = tree["stack"]["time_mix"], tree["stack"]["channel_mix"]
    for leaf in (tm["mu_base"], tm["mu"], tm["ln_scale"], tm["ln_bias"],
                 cm["mu_k"], cm["mu_r"], tree["stack"]["ln1"]["scale"],
                 tree["stack"]["ln2"]["scale"], tree["final_norm"]["scale"]):
        leaf += rng.normal(0, 0.1, leaf.shape).astype(np.float32)


@pytest.fixture(scope="module")
def smoke():
    """(reference cfg, reference params, numpy param tree), fp32."""
    cfg = ref_configs.get_smoke_config(ARCH).replace(dtype="float32")
    params = jax.jit(lambda k: ref_model.init_params(cfg, k))(
        jax.random.PRNGKey(0))
    tree = jax.tree.map(np.array, params)
    _perturb(tree, np.random.default_rng(7))
    return cfg, jax.tree.map(jnp.asarray, tree), tree


def _port_cfg(use_kernels=True, **kw):
    return configs.get_smoke_config(ARCH).replace(
        dtype="float32", use_kernels=use_kernels, **kw)


def _flat(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat(leaf, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = leaf
    return out


def _layer(tree, group, i=0):
    """Layer i's slice of one stacked group: {name: numpy}."""
    return {k: np.asarray(v)[i] for k, v in tree["stack"][group].items()}


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               err_msg=name)


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(cfg, p, b), has_aux=True))


@pytest.mark.parametrize("factory", ["config", "smoke"])
def test_config_fields_match_reference(factory):
    """Field by field; ``ssm`` is the port's own SSMConfig, compared by its
    fields."""
    port = getattr(configs.rwkv6_7b, factory)()
    ref = getattr(ref_configs.REGISTRY[ARCH], factory)()
    for f in dataclasses.fields(port):
        if f.name in ("use_kernels", "ssm"):
            continue
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert dataclasses.asdict(port.ssm) == dataclasses.asdict(ref.ssm)
    assert [f.name for f in dataclasses.fields(SSMConfig)] == \
        [f.name for f in dataclasses.fields(type(ref.ssm))]
    assert SSMConfig() == SSMConfig(**dataclasses.asdict(type(ref.ssm)()))
    assert configs.get_config(ARCH) == port or factory == "smoke"


def test_unported_families_still_raise():
    for arch in ("zamba2-2.7b", "hubert-xlarge", "qwen2-vl-72b"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            configs.get_config(arch)
    base = configs.get_config(ARCH)
    for change in ({"block_kind": "mamba2"}, {"arch_type": "hybrid"},
                   {"block_kind": "mla"}, {"arch_type": "dense"},
                   {"block_kind": "attn"}):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            base.replace(**change)
    with pytest.raises(ValueError, match="needs ssm"):
        base.replace(ssm=None)
    assert ARCH in configs.REGISTRY and ARCH not in configs.NOT_YET_PORTED


def test_full_width_param_shapes_match_reference():
    """rwkv6-7b at full width and the 4 layers the card trains: every
    param's key and shape equal the reference's ``jax.eval_shape``."""
    ref_cfg = ref_configs.get_config(ARCH).replace(num_layers=4)
    want = jax.eval_shape(lambda k: ref_model.init_params(ref_cfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    params = transformer.init_params(
        configs.get_config(ARCH).replace(num_layers=4), device="meta")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in _flat(want).items()}
    n = sum(v.numel() for v in params.values())
    assert n == ref_cfg.param_count() and 1.41e9 < n < 1.42e9


def test_init_scales_follow_the_reference():
    """The reference's constants and scales: decay_base -0.6, unit group-norm
    scale, zero mixes, LoRA std 0.01, bonus std 0.3."""
    p = transformer.init_params(_port_cfg().replace(d_model=256,
                                                    num_heads=8), seed=3,
                                device="cpu")
    assert torch.all(p["stack.time_mix.decay_base"] == -0.6)
    assert torch.all(p["stack.time_mix.ln_scale"] == 1.0)
    for key in ("mu_base", "mu", "ln_bias"):
        assert torch.all(p[f"stack.time_mix.{key}"] == 0.0)
    for key, std in (("lora_w1", 0.01), ("decay_w2", 0.01),
                     ("bonus_u", 0.3), ("w_r", 256 ** -0.5)):
        got = float(p[f"stack.time_mix.{key}"].std())
        assert 0.8 * std < got < 0.95 * std, key   # truncated at 2 sigma


def test_params_from_numpy_carries_the_tree(smoke):
    """The reference's nested RWKV6 tree crosses as it is: the same dotted
    keys as the port's init, every leaf equal, and a model built on it."""
    _, _, tree = smoke
    flat = params_from_numpy(tree)
    want = _flat(tree)
    assert set(flat) == set(want) == set(transformer.init_params(
        _port_cfg(), device="meta"))
    for key, leaf in flat.items():
        assert np.array_equal(leaf.numpy(), want[key]), key
    model = transformer.Transformer(_port_cfg(), flat)
    assert set(model.state_dict()) == set(flat)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groupnorm_heads_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (2, 9, 4, 32)).astype(np.float32)
    sc, b = (rng.normal(0, 1, (128,)).astype(np.float32) for _ in range(2))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = norms.groupnorm_heads(xt, torch.from_numpy(sc), torch.from_numpy(b),
                                1e-5)
    want = ref_norms.groupnorm_heads(
        jnp.asarray(xt.float().numpy()).astype(dtype), jnp.asarray(sc),
        jnp.asarray(b), 1e-5)
    assert got.dtype == xt.dtype
    _close(got, want, 1e-5 if dtype == "float32" else 2e-2)


def test_token_shift_and_ddlerp_match_jax(smoke):
    _, _, tree = smoke
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, SEQ, 128)).astype(np.float32)
    last = rng.normal(0, 1, (2, 128)).astype(np.float32)
    got = rwkv6._token_shift(torch.from_numpy(x), torch.from_numpy(last))
    want = ref_rwkv6._token_shift(jnp.asarray(x), jnp.asarray(last))
    _close(got, want, 0)
    p = _layer(tree, "time_mix")
    got = rwkv6._ddlerp({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), got)
    want = ref_rwkv6._ddlerp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), want)
    assert got.shape == (2, SEQ, 5, 128)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_time_and_channel_mix_match_jax(smoke, use_kernels):
    """One layer's time mix (WKV6 through ``ops.wkv6`` or the checkpointed
    chunked form) and channel mix against the reference's, fp32."""
    cfg, _, tree = smoke
    pcfg = _port_cfg(use_kernels)
    x = np.random.default_rng(3).normal(0, 1, (2, SEQ, 128)).astype(
        np.float32)
    for group, port_fn, ref_fn in (
            ("time_mix", rwkv6.rwkv6_time_mix, ref_rwkv6.rwkv6_time_mix),
            ("channel_mix", rwkv6.rwkv6_channel_mix,
             ref_rwkv6.rwkv6_channel_mix)):
        p = _layer(tree, group)
        got = port_fn({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), pcfg)
        want, _ = ref_fn({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), cfg)
        assert got.shape == x.shape
        _close(got, want, LOGITS_TOL, group)
    with pytest.raises(NotImplementedError, match="decode cache"):
        rwkv6.rwkv6_time_mix({}, torch.from_numpy(x), pcfg, cache={})


def test_naive_path_keeps_no_pairwise_tensor():
    """``wkv6_chunked`` checkpoints each chunk: autograd saves nothing the
    size of a chunk's (B, chunk, chunk, H, P) pairwise-decay tensor, and the
    gradients equal those of the plain backward."""
    b, s, h, p, cs = 2, 64, 2, 32, 16
    rng = np.random.default_rng(4)
    xs = [torch.from_numpy(rng.normal(0, 1, (b, s, h, p)).astype(np.float32))
          for _ in range(3)]
    xs.append(-torch.exp(torch.from_numpy(rng.normal(0, 1, (b, s, h, p))
                                          .astype(np.float32))))
    xs += [torch.from_numpy(0.3 * rng.normal(0, 1, (h, p)).astype(
        np.float32)), torch.zeros(b, h, p, p)]
    leaves = [x.requires_grad_() for x in xs]
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o, _ = rwkv6.wkv6_chunked(*leaves[:5], cs, leaves[5])
    assert max(sizes) < b * cs * cs * h * p
    got = torch.autograd.grad(o.sum(), leaves[:5])
    o2, _ = ops.wkv6(*leaves, chunk=cs)
    torch.testing.assert_close(o, o2, rtol=1e-5, atol=1e-5)
    want = torch.autograd.grad(o2.sum(), leaves[:5])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_logits_loss_and_grads_match_jax(smoke, use_kernels):
    cfg, params, tree = smoke
    tokens = make_token_batch(VOCAB, 2, SEQ, seed=1)["tokens"]
    jb = {"tokens": jnp.asarray(tokens)}
    want_logits = jax.jit(lambda p, b: ref_model.forward(cfg, p, b)[0])(
        params, jb)
    (loss, metrics), grads = _ref_value_and_grad(cfg)(params, jb)
    pcfg = _port_cfg(use_kernels)
    leaves = {k: v.requires_grad_() for k, v in
              params_from_numpy(tree).items()}
    tb = {"tokens": torch.from_numpy(tokens)}
    logits = transformer.forward(pcfg, leaves, tb)
    assert logits.shape == (2, SEQ, VOCAB) and logits.dtype == torch.float32
    _close(logits, want_logits, LOGITS_TOL, "logits")
    got_loss, got_m = transformer.loss_from_logits(pcfg, logits, tb)
    assert set(got_m) == set(metrics) == {"loss", "moe_aux"}
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    got = torch.autograd.grad(got_loss, list(leaves.values()))
    want = _flat(grads)
    assert set(want) == set(leaves)
    for key, g in zip(leaves, got):
        _close(g, want[key], GRAD_TOL, key)


def test_bf16_kernel_and_naive_paths_agree(smoke):
    """In the compute dtype the two WKV6 paths see the same bf16 r/k/v and
    fp32 log-decays: their gradients agree to cosine >= 0.99, the bar
    ``chip_smoke.py`` holds the card's full-width model to."""
    _, _, tree = smoke
    tokens = make_token_batch(VOCAB, 2, SEQ, seed=2)["tokens"]
    grads = []
    for use_kernels in (True, False):
        leaves = {k: v.requires_grad_() for k, v in
                  params_from_numpy(tree).items()}
        loss, _ = transformer.loss_fn(
            _port_cfg(use_kernels).replace(dtype="bfloat16"), leaves,
            {"tokens": torch.from_numpy(tokens)})
        grads.append(torch.cat([g.flatten().double() for g in
                                torch.autograd.grad(loss,
                                                    list(leaves.values()))]))
    cos = float(grads[0] @ grads[1] / (grads[0].norm() * grads[1].norm()))
    assert cos >= 0.99


def test_three_step_trajectory_matches_reference(smoke):
    """Three SGD steps (batch 4 in two micro-batches of 2 x 48 tokens, the
    chunk tail padded) through ``Trainer`` against the reference's
    ``loss_fn``, fp32 accumulation and ``update``: losses 2e-4, grad norms
    1e-4 relative, params 2e-4. SGD, not AdamW: AdamW's first step is
    lr·sign(g), so a gradient at rounding level (RWKV6's 0.01-scale LoRA
    weights) moves a param by ±lr on either side; its update is held to the
    reference by ``test_torch_train.py`` and ``test_torch_lm.py``."""
    cfg, params, tree = smoke
    lr, steps, batch, accum = 1e-2, 3, 4, 2
    kw = dict(global_batch=batch, vocab=VOCAB, seq_len=SEQ,
              epoch_size=batch * steps)
    ref_pipe = RefPipeline(kind="token", **kw)
    pipe = DataPipeline(kind="token", **kw)
    opt = ref_make_optimizer("sgd")
    sched = ref_make_schedule("cosine", lr, 1, steps)
    opt_state = opt.init(params)
    vg = _ref_value_and_grad(cfg)
    trainer = Trainer(_port_cfg(), EngineConfig(
        train_batch_size=batch, gradient_accumulation_steps=accum, lr=lr,
        optimizer="sgd", warmup_steps=1, total_steps=steps), device="cpu")
    model = transformer.Transformer(trainer.cfg, params_from_numpy(tree))
    state = trainer.init_state(model.params())
    for i in range(steps):
        host = ref_pipe.batch_at(0, i)["tokens"]
        mb_out = [vg(params, {"tokens": jnp.asarray(part)})
                  for part in np.split(host, accum)]
        loss = np.mean([float(o[0][0]) for o in mb_out])
        grads = jax.tree.map(lambda *g: sum(g) / accum,
                             *[o[1] for o in mb_out])
        params, opt_state, gnorm = opt.update(grads, opt_state, params,
                                              sched(i))
        state, m = trainer.train_step(state,
                                      to_device(pipe.batch_at(0, i), "cpu"))
        assert m["step_ok"] == 1 and state.step == i + 1
        np.testing.assert_allclose(float(m["loss"]), loss, atol=TRAJ_TOL,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]), float(gnorm),
                                   rtol=1e-4)
    want = _flat(params)
    for k, p in model.params().items():
        _close(p, want[k], TRAJ_TOL, k)


def test_fp32_gradients_at_an_ill_conditioned_batch(smoke):
    """The token pipeline's first batch at 8 x 32 (seed 0), micro-batch 4,
    holds a head whose WKV output nearly cancels: its group-norm input
    variance is under 1e-3 of the median. Near the model's eps of 1e-5 the
    norm amplifies fp32 rounding there, so any two fp32 evaluations, the
    reference's included, can disagree beyond 2e-4. With the norm's eps
    raised to 1e-3 on both sides, the port's K6/K7 path and its chunked path
    hold the reference's gradients within 2e-4 at this batch: the gate
    ``chip_smoke.py`` holds the full-width model to."""
    cfg, params, tree = smoke
    cfg = cfg.replace(norm_eps=EPS_WELL_CONDITIONED)
    host = RefPipeline(kind="token", global_batch=8, vocab=VOCAB, seq_len=32,
                       epoch_size=24).batch_at(0, 0)["tokens"][:4]
    _, want = _ref_value_and_grad(cfg)(params, {"tokens": jnp.asarray(host)})
    want = _flat(want)
    variances = []

    def spy(x, *a):
        variances.append(x.var(-1, unbiased=False))
        return norms.groupnorm_heads(x, *a)
    for use_kernels in (True, False):
        leaves = {k: v.requires_grad_() for k, v in
                  params_from_numpy(tree).items()}
        pcfg = _port_cfg(use_kernels, norm_eps=EPS_WELL_CONDITIONED)
        rwkv6.groupnorm_heads = spy
        try:
            loss, _ = transformer.loss_fn(pcfg, leaves,
                                          {"tokens": torch.from_numpy(host)})
        finally:
            rwkv6.groupnorm_heads = norms.groupnorm_heads
        got = torch.autograd.grad(loss, list(leaves.values()))
        for key, g in zip(leaves, got):
            _close(g, want[key], GRAD_TOL, f"{key} use_kernels={use_kernels}")
    var = torch.cat([v.detach().flatten() for v in variances])
    assert float(var.min()) < 1e-3 * float(var.median())


# the reference's LM train row: accumulate_gradients' metrics, grad_norm,
# lr, step_ok (src/repro/core/engine.py:353-379) plus step and wall_s
REF_LM_KEYS = {"loss", "moe_aux", "grad_norm", "lr", "step_ok", "step",
               "wall_s"}


def test_rwkv6_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "metrics.json"
    hist = cli.main(["--arch", ARCH, "--smoke", "--seq", "64", "--device",
                     "cpu", "--steps", "3", "--batch", "8", "--accum", "2",
                     "--log-every", "1", "--metrics-out", str(out)])
    rows = json.loads(out.read_text())
    assert rows == hist and [r["step"] for r in rows] == list(range(3))
    for r in rows:
        assert set(r) == REF_LM_KEYS and r["step_ok"] == 1
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
    printed = capsys.readouterr().out
    assert "arch=rwkv6-7b-smoke" in printed and "seq=64 vocab=512" in printed
    with pytest.raises(SystemExit, match="needs a real dataset"):
        cli.main(["--arch", ARCH, "--smoke", "--steps", "1", "--seq", "16",
                  "--batch", "2", "--eval-every", "1", "--device", "cpu"])


def test_model_config_rejects_rwkv_without_its_family():
    with pytest.raises(NotImplementedError, match="block_kind"):
        ModelConfig(name="x", arch_type="dense", num_layers=1, d_model=64,
                    num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=8,
                    block_kind="rwkv6", ssm=SSMConfig())


def _position0_spies(records):
    """Spies on both sides' group norm that record the smallest
    position-0 input variance (over batch rows and heads) of each call."""
    def ref_spy(x, *a):
        var = jnp.var(x.astype(jnp.float32)[:, 0], axis=-1).min()
        jax.debug.callback(lambda v: records.append(float(v)), var)
        return ref_norms.groupnorm_heads(x, *a)

    def port_spy(x, *a):
        records.append(float(x.detach().float()[:, 0]
                             .var(-1, unbiased=False).min()))
        return norms.groupnorm_heads(x, *a)
    return ref_spy, port_spy


def _cosine(a, b):
    a = np.concatenate([np.asarray(a[k], np.float64).ravel()
                        for k in sorted(a)])
    b = np.concatenate([np.asarray(b[k], np.float64).ravel()
                        for k in sorted(b)])
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_bf16_gradient_blow_up_is_the_models_conditioning(smoke,
                                                          monkeypatch):
    """ROADMAP fault F1 (RWKV6 bf16 gradients after one or two AdamW
    steps), settled. From the same transferred smoke params, the reference
    (``loss_fn`` + ``jax.value_and_grad`` + AdamW ``update``, its chunked
    WKV6: the Pallas calls raise here) and the port (the kernel-dispatch
    and the naive path, each with its own AdamW) take two bf16 steps of
    batch 4 x 48 at the CLI's lr 3e-4. At each of the three points, each
    side records the smallest position-0 group-norm input variance and
    the cosine of its bf16 gradient to its fp32 gradient.

    The smoke width does reach the eps: at init the fp32 variance is
    ~7e-7, under the model's 1e-5. There both sides give the same bf16
    variance (~7.7e-5, mostly rounding) and the same blow-up (bf16 to
    fp32 cosine ~0.64 on each side). At every point of the reference's
    trajectory the port's fp32 gradient and variance equal the
    reference's. After two steps, where every side's variance is over 100
    times the eps, every bf16 gradient is back within cosine 0.99 of its
    fp32 one. So the port does not depart from the reference: the blow-up
    is the model's conditioning, which bf16 rounding then amplifies."""
    _, params, tree = smoke
    cfg = ref_configs.get_smoke_config(ARCH).replace(dtype="float32")
    eps, lr, steps = cfg.norm_eps, 3e-4, 2
    pipe = RefPipeline(kind="token", global_batch=4, vocab=VOCAB,
                       seq_len=SEQ, epoch_size=4 * (steps + 1))
    batches = [pipe.batch_at(0, i)["tokens"] for i in range(steps + 1)]
    records = []
    ref_spy, port_spy = _position0_spies(records)
    monkeypatch.setattr(ref_rwkv6, "groupnorm_heads", ref_spy)
    monkeypatch.setattr(rwkv6, "groupnorm_heads", port_spy)
    ref_vg = {dt: jax.jit(jax.value_and_grad(
        lambda p, b, dt=dt: ref_model.loss_fn(cfg.replace(dtype=dt), p, b),
        has_aux=True)) for dt in ("bfloat16", "float32")}

    def ref_point(p, tokens):
        out = {}
        for dt, vg in ref_vg.items():
            records.clear()
            _, g = vg(p, {"tokens": jnp.asarray(tokens)})
            g = jax.block_until_ready(g)
            out[dt] = (min(records), g)
        return out

    def port_point(p, tokens, use_kernels):
        out = {}
        for dt in ("bfloat16", "float32"):
            leaves = {k: v.detach().clone().requires_grad_()
                      for k, v in p.items()}
            records.clear()
            loss, _ = transformer.loss_fn(
                _port_cfg(use_kernels).replace(dtype=dt), leaves,
                {"tokens": torch.from_numpy(tokens)})
            out[dt] = (min(records), dict(zip(
                leaves, torch.autograd.grad(loss, list(leaves.values())))))
        return out

    def reading(point, flat):
        var16, g16 = point["bfloat16"]
        var32, g32 = point["float32"]
        return var16, var32, _cosine(flat(g16), flat(g32))

    ref_opt = ref_make_optimizer("adamw")
    ref_state = ref_opt.init(params)
    ref_flat = lambda g: jax.tree.map(np.asarray, _flat(g))  # noqa: E731
    port_flat = lambda g: {k: v.numpy() for k, v in g.items()}  # noqa
    port_opt = make_optimizer("adamw")
    own = {}
    for use_kernels in (True, False):
        p = params_from_numpy(tree)
        own[use_kernels] = [p, port_opt.init(p)]
    readings = {"ref": [], True: [], False: []}
    for i, tokens in enumerate(batches):
        ref = ref_point(params, tokens)
        readings["ref"].append(reading(ref, ref_flat))
        at_ref = port_point(params_from_numpy(jax.tree.map(np.array,
                                                           params)),
                            tokens, True)
        # the port at the reference's params: the same fp32 conditioning
        # and the same fp32 gradient
        np.testing.assert_allclose(at_ref["float32"][0], ref["float32"][0],
                                   rtol=1e-2, err_msg=f"step {i}")
        assert _cosine(port_flat(at_ref["float32"][1]),
                       ref_flat(ref["float32"][1])) >= 0.9999
        for use_kernels, (p, state) in own.items():
            point = port_point(p, tokens, use_kernels)
            readings[use_kernels].append(reading(point, port_flat))
            if i < steps:
                own[use_kernels][:2] = port_opt.update(
                    point["bfloat16"][1], state, p, lr)[:2]
        if i < steps:
            params, ref_state, _ = ref_opt.update(ref["bfloat16"][1],
                                                  ref_state, params, lr)
    (r16, r32, r_cos) = readings["ref"][0]
    for side in (True, False):
        p16, p32, p_cos = readings[side][0]
        # at init: the same variances and the same blow-up on both sides
        np.testing.assert_allclose([p16, p32], [r16, r32], rtol=1e-2)
        assert p32 < eps and abs(p_cos - r_cos) <= 0.01 and p_cos < 0.99
    for side, rows in readings.items():
        var16, var32, cos = rows[-1]
        assert min(var16, var32) > 100 * eps and cos >= 0.99, (side, rows)
