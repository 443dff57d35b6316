"""Port parity for the dense-decoder slice (``chatglm3-6b``): the config,
the synthetic token stream, RoPE, the LM forward, loss and gradients, a
3-step AdamW trajectory and the training CLI.

The reference side is built from the JAX package's pure functions
(``model.forward``, ``model.loss_fn`` with ``jax.value_and_grad``,
``make_optimizer(...).update``, ``make_schedule``, the host data code), not
from ``DistributedEngine`` (ROADMAP caveat R1). The reference's smoke params
cross with ``params_from_numpy``, with the zero biases and unit norm scales
perturbed by numpy noise on both sides so that every branch matters.
Tolerances are those of ``tests/test_torch_train.py``: loss 1e-5, grads
2e-4, trajectory 2e-4; logits 1e-4 as ``tests/test_torch_vit.py``.
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
from repro.data.synthetic import make_token_batch as \
    ref_make_token_batch  # noqa: E402
from repro.models import rope as ref_rope  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro.optim import make_optimizer as ref_make_optimizer  # noqa: E402
from repro.optim import make_schedule as ref_make_schedule  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import EngineConfig  # noqa: E402
from repro_torch.core.engine import Evaluator, Trainer, \
    to_device  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.data.synthetic import make_token_batch  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import rope, transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "chatglm3-6b"
LOGITS_TOL, LOSS_TOL, GRAD_TOL, TRAJ_TOL = 1e-4, 1e-5, 2e-4, 2e-4
VOCAB, SEQ = 512, 32


@pytest.fixture(scope="module")
def smoke():
    """(reference cfg, reference params, numpy param tree), fp32, with the
    biases and norm scales perturbed."""
    cfg = ref_configs.get_smoke_config(ARCH).replace(dtype="float32")
    params = jax.jit(lambda k: ref_model.init_params(cfg, k))(
        jax.random.PRNGKey(0))
    tree = jax.tree.map(np.array, params)
    rng = np.random.default_rng(7)
    for group, keys in (("attn", ("bq", "bk", "bv")), ("ln1", ("scale",)),
                        ("ln2", ("scale",))):
        for key in keys:
            leaf = tree["stack"][group][key]
            leaf += rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    tree["final_norm"]["scale"] += rng.normal(
        0, 0.1, tree["final_norm"]["scale"].shape).astype(np.float32)
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
            out[f"{prefix}{name}"] = np.asarray(leaf)
    return out


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(cfg, p, b), has_aux=True))


def _tokens(b, s, seed):
    return make_token_batch(VOCAB, b, s, seed=seed)


@pytest.mark.parametrize("factory", ["config", "smoke"])
def test_config_fields_match_reference(factory):
    port = getattr(configs.chatglm3_6b, factory)()
    ref = getattr(ref_configs.REGISTRY[ARCH], factory)()
    for f in dataclasses.fields(port):
        if f.name != "use_kernels":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert configs.get_config(ARCH) == port or factory == "smoke"
    assert port.layer_windows() == ref.layer_windows()


@pytest.mark.parametrize("change", [
    {"tie_embeddings": True}, {"embed_scale": True},
    {"rope_style": "mrope"}, {"arch_type": "moe"}, {"act": "geglu"}])
def test_unported_branches_raise(change):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        configs.get_config(ARCH).replace(**change)


def test_full_width_param_shapes_match_reference():
    """chatglm3-6b at full width and the 4 layers the card trains: every
    param's key and shape equal the reference's ``jax.eval_shape``."""
    ref_cfg = ref_configs.get_config(ARCH).replace(num_layers=4)
    want = jax.eval_shape(lambda k: ref_model.init_params(ref_cfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    params = transformer.init_params(
        configs.get_config(ARCH).replace(num_layers=4), device="meta")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in _flat_shapes(want).items()}
    n = sum(v.numel() for v in params.values())
    assert n == ref_cfg.param_count() and 1.3e9 < n < 1.4e9


def _flat_shapes(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat_shapes(leaf, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = leaf
    return out


@pytest.mark.parametrize("vocab,b,s,seed", [(512, 4, 64, 0), (65024, 2, 33, 5),
                                            (2, 3, 7, 2 ** 31 - 1)])
def test_token_batch_is_byte_identical(vocab, b, s, seed):
    got = make_token_batch(vocab, b, s, seed=seed)
    want = ref_make_token_batch(vocab, b, s, seed=seed)
    assert got["tokens"].dtype == want["tokens"].dtype == np.int32
    assert got["tokens"].tobytes() == want["tokens"].tobytes()


def test_token_pipeline_is_byte_identical():
    kw = dict(global_batch=8, vocab=VOCAB, seq_len=SEQ, epoch_size=8 * 5)
    for seed in (0, 3):
        ref = RefPipeline(kind="token", seed=seed, **kw)
        port = DataPipeline(kind="token", seed=seed, **kw)
        assert port.steps_per_epoch == ref.steps_per_epoch == 5
        for epoch, index in ((0, 0), (0, 4), (2, 1)):
            got, want = port.batch_at(epoch, index), ref.batch_at(epoch,
                                                                  index)
            assert set(got) == set(want) == {"tokens"}
            assert got["tokens"].tobytes() == want["tokens"].tobytes()
        assert port.next_cursor(0, 4) == ref.next_cursor(0, 4) == (1, 0)
        with pytest.raises(IndexError):
            port.batch_at(0, 5)
    with pytest.raises(ValueError, match="kind"):
        DataPipeline(kind="audio", global_batch=8)


@pytest.mark.parametrize("style", ["full", "half"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(style, dtype):
    rng = np.random.default_rng(1)
    q = rng.normal(0, 1, (2, 40, 4, 32)).astype(np.float32)
    k = rng.normal(0, 1, (2, 40, 2, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32)[None], (2, 40))
    tq, tk = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k))
    gq, gk = rope.apply_rope(tq, tk, torch.from_numpy(pos.copy()),
                             style=style, theta=10000.0)
    wq, wk = ref_rope.apply_rope(jnp.asarray(tq.float().numpy()).astype(dtype),
                                 jnp.asarray(tk.float().numpy()).astype(dtype),
                                 jnp.asarray(pos), style=style, theta=10000.0)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for g, w in ((gq, wq), (gk, wk)):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=tol,
                                   rtol=tol)
    if style == "half":             # the second half passes through
        assert torch.equal(gq[..., 16:], tq[..., 16:])


@pytest.mark.parametrize("use_kernels", [True, False])
def test_logits_loss_and_grads_match_jax(smoke, use_kernels):
    cfg, params, tree = smoke
    batch = _tokens(2, SEQ, seed=1)
    jb = {"tokens": jnp.asarray(batch["tokens"])}
    want_logits = jax.jit(lambda p, b: ref_model.forward(cfg, p, b)[0])(
        params, jb)
    (loss, metrics), grads = _ref_value_and_grad(cfg)(params, jb)
    pcfg = _port_cfg(use_kernels)
    leaves = {k: v.requires_grad_() for k, v in
              params_from_numpy(tree).items()}
    tb = {"tokens": torch.from_numpy(batch["tokens"])}
    logits = transformer.forward(pcfg, leaves, tb)
    assert logits.shape == (2, SEQ, VOCAB) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=LOGITS_TOL)
    got_loss, got_m = transformer.loss_from_logits(pcfg, logits, tb)
    assert set(got_m) == set(metrics) == {"loss", "moe_aux"}
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    got = torch.autograd.grad(got_loss, list(leaves.values()))
    want = _flat(grads)
    assert set(want) == set(leaves)
    for key, g in zip(leaves, got):
        np.testing.assert_allclose(g.numpy(), want[key], atol=GRAD_TOL,
                                   err_msg=key)


def test_loss_masks_the_last_position():
    """The label of position t is token t+1; the last position counts
    nothing, whatever its logits."""
    cfg = _port_cfg()
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.normal(0, 1, (2, 5, 7)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 7, (2, 5)).astype(np.int32))
    loss, _ = transformer.loss_from_logits(cfg, logits, {"tokens": tokens})
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    want = -logp.gather(-1, tokens[:, 1:, None].long()).mean()
    torch.testing.assert_close(loss, want)
    logits2 = logits.clone()
    logits2[:, -1] = 100.0
    assert torch.equal(transformer.loss_from_logits(
        cfg, logits2, {"tokens": tokens})[0], loss)


def test_three_step_trajectory_matches_reference(smoke):
    cfg, params, tree = smoke
    lr, steps, batch, accum = 1e-3, 3, 8, 2
    kw = dict(global_batch=batch, vocab=VOCAB, seq_len=SEQ,
              epoch_size=batch * steps)
    ref_pipe = RefPipeline(kind="token", **kw)
    pipe = DataPipeline(kind="token", **kw)
    opt = ref_make_optimizer("adamw")
    sched = ref_make_schedule("cosine", lr, 1, steps)
    opt_state = opt.init(params)
    vg = _ref_value_and_grad(cfg)
    trainer = Trainer(_port_cfg(), EngineConfig(
        train_batch_size=batch, gradient_accumulation_steps=accum, lr=lr,
        warmup_steps=1, total_steps=steps), device="cpu")
    model = transformer.Transformer(trainer.cfg, params_from_numpy(tree))
    state = trainer.init_state(model.params())
    for i in range(steps):
        host = ref_pipe.batch_at(0, i)["tokens"]
        # the reference's accumulation: mean of the microbatch grads in fp32
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
        np.testing.assert_allclose(p.detach().numpy(), want[k],
                                   atol=TRAJ_TOL, err_msg=k)


# the reference's LM train row: accumulate_gradients' metrics, grad_norm,
# lr, step_ok (src/repro/core/engine.py:353-379) plus step and wall_s
REF_LM_KEYS = {"loss", "moe_aux", "grad_norm", "lr", "step_ok", "step",
               "wall_s"}


def test_lm_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "metrics.json"
    hist = cli.main(["--arch", ARCH, "--smoke", "--steps", "5", "--seq", "64",
                     "--batch", "8", "--accum", "2", "--log-every", "1",
                     "--device", "cpu", "--metrics-out", str(out)])
    rows = json.loads(out.read_text())
    assert rows == hist and [r["step"] for r in rows] == list(range(5))
    for r in rows:
        assert set(r) == REF_LM_KEYS and r["step_ok"] == 1
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
    printed = capsys.readouterr().out
    assert "layers=2" in printed and "seq=64 vocab=512" in printed


def test_lm_cli_layers_and_eval(capsys):
    cli.main(["--arch", ARCH, "--smoke", "--layers", "1", "--steps", "1",
              "--seq", "16", "--batch", "2", "--device", "cpu",
              "--no-kernels"])
    assert "layers=1" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="needs a real dataset"):
        cli.main(["--arch", ARCH, "--smoke", "--steps", "1", "--seq", "16",
                  "--batch", "2", "--eval-every", "1", "--device", "cpu"])


def test_evaluator_stays_vit_only():
    cfg = _port_cfg()
    model = transformer.Transformer(cfg, transformer.init_params(
        cfg, device="cpu"))
    with pytest.raises(NotImplementedError, match="vit"):
        Evaluator(cfg, model, device="cpu")
