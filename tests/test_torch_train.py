"""Port parity for training: the loss and its gradients, the optimizers
and the schedule, gradient accumulation, a short trajectory, the anomaly
guard, the reference's own learning criterion and the training CLI.

The reference side is built from the JAX package's pure functions
(``model.loss_fn`` with ``jax.value_and_grad``, ``make_optimizer(...)
.update``, ``make_schedule``, ``accumulate_gradients``), not from
``DistributedEngine``, whose train step does not run with this JAX
(ROADMAP caveat R1). Params cross with ``params_from_numpy``; inputs come
from numpy seeds. Tolerances: loss 1e-5 and grads 2e-4 as
``tests/test_flash_grad.py:170``, one optimizer update 1e-6, trajectory
losses 2e-4 per step.
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
from repro.core import grad_accum as ref_grad_accum  # noqa: E402
from repro.data import DATASETS as REF_DATASETS  # noqa: E402
from repro.data import DataPipeline as RefPipeline  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro.optim import make_optimizer as ref_make_optimizer  # noqa: E402
from repro.optim import make_schedule as ref_make_schedule  # noqa: E402
from repro.optim.optimizers import OptState as RefOptState  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import EngineConfig  # noqa: E402
from repro_torch.core.engine import Trainer, to_device  # noqa: E402
from repro_torch.core.grad_accum import accumulate_gradients, \
    split_microbatches  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.data.synthetic import DATASETS  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import OptState, make_optimizer, \
    make_schedule  # noqa: E402

LOSS_TOL, GRAD_TOL, OPT_TOL, TRAJ_TOL = 1e-5, 2e-4, 1e-6, 2e-4


@pytest.fixture(scope="module")
def smoke():
    """(reference cfg, reference params, numpy param tree), fp32."""
    cfg = ref_configs.get_smoke_config("vit-b16").replace(dtype="float32")
    params = jax.jit(lambda k: ref_model.init_params(cfg, k))(
        jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(np.asarray, params)


def _port_cfg(use_kernels=True, **kw):
    return configs.get_smoke_config("vit-b16").replace(
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


def _batch(n, seed, soft=False):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (n, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (n,)).astype(np.int32)
    if soft:
        labels = rng.dirichlet(np.ones(10), n).astype(np.float32)
    return {"images": images, "labels": labels}


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("smoothing,soft", [(0.0, False), (0.1, False),
                                            (0.0, True)])
def test_loss_and_grads_match_jax(smoke, use_kernels, smoothing, soft):
    cfg, params, tree = smoke
    cfg = cfg.replace(label_smoothing=smoothing)
    batch = _batch(4, seed=0, soft=soft)
    (loss, metrics), grads = _ref_value_and_grad(cfg)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    pcfg = _port_cfg(use_kernels, label_smoothing=smoothing)
    leaves = {k: v.requires_grad_() for k, v in
              params_from_numpy(tree).items()}
    got_loss, got_m = transformer.loss_fn(
        pcfg, leaves, {k: torch.from_numpy(v) for k, v in batch.items()})
    got = torch.autograd.grad(got_loss, list(leaves.values()))
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    for key in ("acc", "moe_aux", "loss"):
        np.testing.assert_allclose(float(got_m[key].detach()),
                                   float(metrics[key]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
    want = _flat(grads)
    assert set(want) == set(leaves)
    for key, g in zip(leaves, got):
        np.testing.assert_allclose(g.numpy(), want[key], atol=GRAD_TOL,
                                   err_msg=key)


def test_soft_xent_matches_reference():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (7, 10)).astype(np.float32)
    hard = rng.integers(0, 10, (7,)).astype(np.int32)
    for labels in (hard, rng.dirichlet(np.ones(10), 7).astype(np.float32)):
        for eps in (0.0, 0.2):
            got = transformer._soft_xent(torch.from_numpy(logits),
                                         torch.from_numpy(labels),
                                         smoothing=eps)
            want = ref_model._soft_xent(jnp.asarray(logits),
                                        jnp.asarray(labels), smoothing=eps)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "z": (3, 2)}
    mk = lambda s: {k: rng.normal(0, s, v).astype(np.float32)  # noqa: E731
                    for k, v in shapes.items()}
    params, grads, mu = mk(1.0), mk(2.0), mk(0.1)
    nu = {k: np.abs(v) for k, v in mk(0.1).items()}
    params["z"][:] = 0.0          # lamb's trust ratio falls back to 1 here
    return params, grads, mu, nu


@pytest.mark.parametrize("name", ["adamw", "sgd", "lamb"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_one_optimizer_update_matches_reference(name, grad_clip):
    params, grads, mu, nu = _opt_inputs()
    lr = 3e-3
    ref = ref_make_optimizer(name, grad_clip=grad_clip)
    ref_nu = () if name == "sgd" else {k: jnp.asarray(v)
                                       for k, v in nu.items()}
    ref_state = RefOptState(jnp.int32(3), {k: jnp.asarray(v)
                                           for k, v in mu.items()}, ref_nu)
    want_p, want_s, want_n = ref.update(
        {k: jnp.asarray(v) for k, v in grads.items()}, ref_state,
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.float32(lr))
    t = lambda d: {k: torch.from_numpy(v.copy())  # noqa: E731
                   for k, v in d.items()}
    opt = make_optimizer(name, grad_clip=grad_clip)
    state = OptState(3, t(mu), () if name == "sgd" else t(nu))
    before = t(params)
    got_p, got_s, got_n = opt.update(t(grads), state, before, lr)
    assert got_s.step == 4 == int(want_s.step)
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=OPT_TOL)
    for k in params:
        assert torch.equal(before[k], torch.from_numpy(params[k]))
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(want_p[k]),
                                   rtol=OPT_TOL, atol=OPT_TOL, err_msg=k)
        np.testing.assert_allclose(got_s.mu[k].numpy(),
                                   np.asarray(want_s.mu[k]), rtol=OPT_TOL,
                                   atol=OPT_TOL)
        if name != "sgd":
            np.testing.assert_allclose(got_s.nu[k].numpy(),
                                       np.asarray(want_s.nu[k]),
                                       rtol=OPT_TOL, atol=OPT_TOL)


def test_optimizer_init_is_fp32_zeros():
    p = {"a": torch.ones(2, 3, dtype=torch.bfloat16)}
    for name in ("adamw", "sgd"):
        st = make_optimizer(name).init(p)
        assert st.step == 0 and st.mu["a"].dtype == torch.float32
        assert not st.mu["a"].any()
        assert (st.nu == ()) == (name == "sgd")
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("adagrad")


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(kind):
    ref = ref_make_schedule(kind, 3e-4, 10, 100)
    port = make_schedule(kind, 3e-4, 10, 100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(port(step), float(ref(step)),
                                   rtol=OPT_TOL, err_msg=str(step))
    assert port(1000) == pytest.approx(
        3e-4 * (0.1 if kind != "constant" else 1.0), rel=1e-6)


def test_engine_config_matches_reference():
    ref = {f.name: f.default for f in
           dataclasses.fields(ref_configs.EngineConfig)}
    for f in dataclasses.fields(EngineConfig):
        assert ref[f.name] == f.default, f.name
    ecfg = EngineConfig(train_batch_size=128, gradient_accumulation_steps=2)
    assert ecfg.derived_micro_batch(1) == 64
    ecfg.validate(1)
    with pytest.raises(ValueError, match="not divisible"):
        EngineConfig(train_batch_size=10,
                     gradient_accumulation_steps=4).validate(1)
    with pytest.raises(ValueError, match="invariant"):
        EngineConfig(train_batch_size=16, micro_batch_per_gpu=4).validate(1)


def test_split_microbatches():
    batch = {"images": torch.arange(24.).reshape(6, 4),
             "labels": torch.arange(6)}
    mbs = split_microbatches(batch, 3)
    assert len(mbs) == 3 and mbs[1]["labels"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="divisible"):
        split_microbatches(batch, 4)


def test_accumulate_gradients_matches_accum_1_and_reference(smoke):
    cfg, params, tree = smoke
    batch = _batch(8, seed=2)
    pcfg = _port_cfg()

    def loss(p, mb):
        return transformer.loss_fn(pcfg, p, mb)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = {k: v.requires_grad_() for k, v in
              params_from_numpy(tree).items()}
    g1, m1 = accumulate_gradients(loss, leaves, tb, 1)
    g2, m2 = accumulate_gradients(loss, leaves, tb, 2)
    want_g, want_m = ref_grad_accum.accumulate_gradients(
        lambda p, mb: ref_model.loss_fn(cfg, p, mb), params,
        {k: jnp.asarray(v) for k, v in batch.items()}, 2)
    want_g = _flat(want_g)
    for k in leaves:
        assert g2[k].dtype == torch.float32
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(g2[k].numpy(), want_g[k], atol=GRAD_TOL,
                                   err_msg=k)
    for key in ("loss", "acc"):
        np.testing.assert_allclose(float(m2[key]), float(want_m[key]),
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(float(m2[key]), float(m1[key]), rtol=1e-5)


def _trainer(ecfg, use_kernels=True):
    return Trainer(_port_cfg(use_kernels), ecfg, device="cpu")


def test_three_step_trajectory_matches_reference(smoke):
    cfg, params, tree = smoke
    lr, steps = 1e-3, 3
    ecfg = EngineConfig(train_batch_size=8, lr=lr, warmup_steps=1,
                        total_steps=steps)
    ref_pipe = RefPipeline(kind="image", global_batch=8,
                           dataset=REF_DATASETS["cifar10"], resolution=32)
    pipe = DataPipeline(global_batch=8, dataset=DATASETS["cifar10"],
                        resolution=32)
    opt = ref_make_optimizer("adamw")
    sched = ref_make_schedule("cosine", lr, 1, steps)
    opt_state = opt.init(params)
    trainer = _trainer(ecfg)
    vit = transformer.ViT(trainer.cfg, params_from_numpy(tree))
    state = trainer.init_state(vit.params())
    for i in range(steps):
        host = ref_pipe.batch_at(0, i)
        (loss, _), grads = _ref_value_and_grad(cfg)(
            params, {k: jnp.asarray(v) for k, v in host.items()})
        params, opt_state, gnorm = opt.update(grads, opt_state, params,
                                              sched(i))
        state, m = trainer.train_step(state,
                                      to_device(pipe.batch_at(0, i), "cpu"))
        assert m["step_ok"] == 1 and state.step == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(loss),
                                   atol=TRAJ_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]), float(gnorm),
                                   rtol=1e-4)
        np.testing.assert_allclose(m["lr"], float(sched(i)), rtol=OPT_TOL)
    want = _flat(params)
    for k, p in vit.params().items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], atol=TRAJ_TOL,
                                   err_msg=k)


def test_anomaly_guard_leaves_state_bitwise_unchanged():
    ecfg = EngineConfig(train_batch_size=4, gradient_accumulation_steps=2)
    trainer = _trainer(ecfg, use_kernels=False)
    vit = transformer.ViT(trainer.cfg, transformer.init_params(
        trainer.cfg, seed=0, device="cpu"))
    state = trainer.init_state(vit.params())
    good = {k: torch.from_numpy(v) for k, v in _batch(4, seed=3).items()}
    state, m = trainer.train_step(state, good)       # non-zero moments
    assert m["step_ok"] == 1 and state.step == 1
    snap = {k: v.detach().clone() for k, v in state.params.items()}
    mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
    nu = {k: v.clone() for k, v in state.opt_state.nu.items()}
    bad = dict(good, images=good["images"].clone())
    bad["images"][1, 0, 0, 0] = float("nan")
    new, m = trainer.train_step(state, bad)
    assert m["step_ok"] == 0 and not np.isfinite(float(m["loss"]))
    assert new.step == 1 and new.opt_state.step == 1
    for k in snap:
        assert torch.equal(new.params[k], snap[k]), k
        assert torch.equal(new.opt_state.mu[k], mu[k]), k
        assert torch.equal(new.opt_state.nu[k], nu[k]), k
    _, m = trainer.train_step(new, good)
    assert m["step_ok"] == 1


def test_cast_params_bf16_takes_grads_at_the_bf16_view():
    """Under ``cast_params_bf16`` the matrices are differentiated as their
    bf16 view (the reference's ZeRO-3 gather cast): each such grad is the
    fp32-compute grad at the rounded params, rounded to bf16; the fp32
    masters take the update."""
    cast = _trainer(EngineConfig(train_batch_size=4, cast_params_bf16=True),
                    use_kernels=False)
    plain = _trainer(EngineConfig(train_batch_size=4), use_kernels=False)
    params = transformer.init_params(cast.cfg, seed=1, device="cpu")
    rounded = {k: p.bfloat16().float() if p.ndim >= 2 else p
               for k, p in params.items()}
    batch = {k: torch.from_numpy(v) for k, v in _batch(4, seed=4).items()}
    got, _ = cast.grads(params, batch)
    want, _ = plain.grads(rounded, batch)
    for k, g in got.items():
        assert g.dtype == torch.float32
        w = want[k].bfloat16().float() if params[k].ndim >= 2 else want[k]
        assert torch.equal(g, w), k
    state, m = cast.train_step(cast.init_state(params), batch)
    assert m["step_ok"] == 1
    assert all(p.dtype == torch.float32 for p in state.params.values())


def test_loss_decreases_on_the_port():
    """``tests/test_arch_smoke.py:87-108``'s criterion on the port's own
    trajectory: smoke ViT in fp32, batch 16, lr 3e-3, 30 steps, warmup 3,
    the synthetic cifar10 stream."""
    cfg = configs.get_smoke_config("vit-b16").replace(dtype="float32")
    trainer = Trainer(cfg, EngineConfig(train_batch_size=16, lr=3e-3,
                                        total_steps=30, warmup_steps=3),
                      device="cpu")
    vit = transformer.ViT(cfg, transformer.init_params(cfg, seed=0,
                                                       device="cpu"))
    state = trainer.init_state(vit.params())
    pipe = DataPipeline(global_batch=16, dataset=DATASETS["cifar10"],
                        resolution=cfg.image_size)
    losses = []
    for i, batch in enumerate(pipe.batches()):
        if i >= 30:
            break
        state, m = trainer.train_step(state, to_device(batch, "cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


# the reference's train row: accumulate_gradients' metrics, grad_norm, lr,
# step_ok (src/repro/core/engine.py:353-379) plus step and wall_s
# (src/repro/launch/train.py:444-446)
REF_TRAIN_KEYS = {"loss", "acc", "moe_aux", "grad_norm", "lr", "step_ok",
                  "step", "wall_s"}


def test_training_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "metrics.json"
    hist = cli.main(["--smoke", "--steps", "3", "--batch", "8", "--accum",
                     "2", "--log-every", "1", "--eval-every", "3",
                     "--eval-size", "16", "--eval-batch", "8", "--device",
                     "cpu", "--metrics-out", str(out)])
    rows = json.loads(out.read_text())
    assert rows == hist and len(rows) == 4
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    for r in rows[:3]:
        assert set(r) == REF_TRAIN_KEYS and r["step_ok"] == 1
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
    assert rows[3]["eval_count"] == 16 and "wall_s" in rows[3]
    printed = capsys.readouterr().out
    assert "[train] step     2 loss=" in printed and "gnorm=" in printed
    assert "[eval ] step     3 top1=" in printed


def test_training_cli_synthetic_stream():
    rows = cli.main(["--smoke", "--steps", "2", "--batch", "4",
                     "--dataset", "synthetic", "--optimizer", "sgd",
                     "--label-smoothing", "0.1", "--device", "cpu"])
    assert [r["step"] for r in rows] == [0, 1]
    with pytest.raises(SystemExit, match="needs a real dataset"):
        cli.main(["--smoke", "--steps", "1", "--dataset", "synthetic",
                  "--eval-every", "1", "--device", "cpu"])


@pytest.mark.parametrize("extra", [["--pp", "2"]])
def test_unported_options_are_refused(extra):
    with pytest.raises(SystemExit, match="not yet ported"):
        cli.main(["--smoke", "--steps", "1", "--device", "cpu"] + extra)


def _saved(d):
    from repro_torch.checkpoint import list_steps
    return list_steps(str(d))


# each option lifted by the checkpoint and resilience slice, run on the CPU:
# (extra args, "{d}" for a fresh checkpoint dir; what the run must show)
LIFTED = {
    "ckpt-every": (["--ckpt-dir", "{d}", "--ckpt-every", "1"],
                   lambda d, rows, out: _saved(d) == [1, 2, 3, 4]),
    "resume-step": (["--ckpt-dir", "{d}", "--resume", "--resume-step", "2"],
                    lambda d, rows, out: "resumed step=2" in out
                    and [r["step"] for r in rows] == [2, 3]),
    "max-restarts": (["--max-restarts", "1"],
                     lambda d, rows, out: len(rows) == 4),
    "ckpt-dir": (["--ckpt-dir", "{d}"],
                 lambda d, rows, out: _saved(d) == [4]),
    "resume": (["--resume"], lambda d, rows, out:
               "no checkpoint in <unset>; starting fresh" in out
               and len(rows) == 4),
    "stop-after": (["--stop-after", "2"],
                   lambda d, rows, out: [r["step"] for r in rows] == [0, 1]),
    "keep-last": (["--ckpt-dir", "{d}", "--ckpt-every", "1", "--keep-last",
                   "2"], lambda d, rows, out: _saved(d) == [3, 4]),
    "inject-faults": (["--inject-faults", "nan_grad@1"],
                      lambda d, rows, out: "update skipped (1/3)" in out
                      and len(rows) == 4),
    # lifted by the host data slice
    "shard-dir": (["--shard-dir", "{d}"],
                  lambda d, rows, out: "dataset=cifar10 shards train=64"
                  in out and len(rows) == 4),
    "prefetch-depth": (["--prefetch-depth", "1"],
                       lambda d, rows, out: len(rows) == 4),
    # the run raises: checked in the test below
    "no-prefetch": (["--no-prefetch", "--inject-faults", "data@1"], None),
}


@pytest.mark.parametrize("flag", sorted(LIFTED) + ["supervise"])
def test_lifted_options_parse_and_run(flag, tmp_path, capsys):
    """The options that the checkpoint and resilience slice lifted out of
    the refused list parse and run on the CPU (each flag's semantics are
    held in ``test_torch_checkpoint.py`` and ``test_torch_resilience.py``).
    ``--resume-step`` resumes from a step the run before it saved."""
    import os
    import subprocess
    import sys
    base = ["--smoke", "--steps", "4", "--batch", "8", "--log-every", "1",
            "--device", "cpu"]
    d = tmp_path / "ck"
    if flag == "supervise":
        # the supervisor relaunches the CLI as a child process
        src = os.path.join(os.path.dirname(__file__), "..", "src")
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train"] + base
            + ["--supervise", "--max-restarts", "0", "--ckpt-dir", str(d)],
            env=dict(os.environ, PYTHONPATH=os.path.abspath(src)),
            capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "launch attempt 1/1" in r.stdout
        assert "--resume" in r.stdout and "run completed cleanly" in r.stdout
        assert _saved(d) == [4]
        return
    extra, check = LIFTED[flag]
    extra = [a.replace("{d}", str(d)) for a in extra]
    if flag == "resume-step":
        cli.main(base + ["--ckpt-dir", str(d), "--ckpt-every", "2",
                         "--stop-after", "3"])
    if flag == "shard-dir":
        from repro_torch.data.datasets import CIFARSource
        from repro_torch.data.streaming import write_shards
        write_shards(str(d), CIFARSource(train_size=64, eval_size=16),
                     shard_size=32)
    if flag == "no-prefetch":
        # the batch is built in the step loop: a transient data fault
        # reaches the loop instead of the prefetcher's retry
        from repro_torch.resilience import TransientError
        with pytest.raises(TransientError):
            cli.main(base + extra)
        return
    capsys.readouterr()
    rows = cli.main(base + extra)
    assert check(d, rows, capsys.readouterr().out), rows
