"""Port parity for tensor-parallel training: gloo worlds at model axis 2,
model axis 4 and data 2 x model 2, at ZeRO 0 and 3, against the
one-process ``Trainer`` on the same params (seed 0) and batches, for the
smoke configs of this slice's families: the ViT (its class head split at
M 2), HuBERT (the masked-frame loss over vocab-sharded labels),
ChatGLM3-6B (D6 at M 4: one KV head a rank, sliced from the whole KV
projections), Qwen2.5-14B (``qkv_bias``), Gemma3-12B (the tied,
vocab-parallel embedding) and Qwen2-VL-72B (M-RoPE, the image splice);
then checkpoints across layouts: model 2 -> one process, one process ->
model 2, data 2 x model 2 at ZeRO 3 -> one process, and the D6 leaves of
model 4 -> one process.

Tolerances: the reference's tensor-parallel bound for losses and grad
norms (3e-4, ``tests/test_engine_distributed.py:92-101``), 2e-4 for each
leaf's first-step gradient gathered whole (the data-parallel tests'), the
resume parity 1e-5 of ``tests/test_torch_checkpoint.py``; the ViT's eval
counts exactly. The spawned ranks import this module, so it imports no
JAX.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import concurrent.futures  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import EngineConfig  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.engine import Evaluator, Trainer, \
    to_device  # noqa: E402
from repro_torch.data.datasets import CIFARSource  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.launch.specs import concrete_batch  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

TP_TOL, GRAD_TOL, RESUME_TOL = 3e-4, 2e-4, 1e-5
STEPS, BATCH, ACCUM, SEQ = 3, 8, 2, 32
EVAL_SIZE, EVAL_BATCH = 40, 8
DEADLINE_S = 240
ARCHS = ("vit-b16", "hubert-xlarge", "chatglm3-6b", "qwen2.5-14b",
         "gemma3-12b", "qwen2-vl-72b")
# layout -> (world size, model axis)
LAYOUTS = {"m2": (2, 2), "m4": (4, 4), "dp2-m2": (4, 2)}
ZEROS = (0, 3)
CASES = [(arch, lay, z) for lay in LAYOUTS for arch in ARCHS for z in ZEROS]
CKPT_ARCH = "chatglm3-6b"
# the world cases that save after step 2 (resumed in one process)
SAVED = [(CKPT_ARCH, "m2", 0), (CKPT_ARCH, "dp2-m2", 3),
         (CKPT_ARCH, "m4", 0)]


def _name(case):
    return "-".join(map(str, case))


def _trainer(arch, *, zero=0, model=1, world=None):
    """(trainer, host batch source, fresh params of seed 0), fp32, batch 8
    in 2 microbatches: procedural CIFAR-10 for the ViT, ``concrete_batch``
    of 32 positions for the rest."""
    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    ecfg = EngineConfig(train_batch_size=BATCH,
                        gradient_accumulation_steps=ACCUM, zero_stage=zero,
                        lr=1e-3, total_steps=10, warmup_steps=1)
    if cfg.arch_type == "vit":
        source = CIFARSource("cifar10", resolution=32, eval_size=EVAL_SIZE)
        pipe = DataPipeline(global_batch=BATCH, source=source)
        trainer = Trainer(cfg, ecfg, preproc=source.preproc, device="cpu",
                          world=world, model_axis=model)

        def batch(step):
            return to_device(pipe.batch_at(0, step), "cpu")
    else:
        trainer = Trainer(cfg, ecfg, device="cpu", world=world,
                          model_axis=model)

        def batch(step):
            return to_device(concrete_batch(cfg, BATCH, SEQ, seed=step),
                             "cpu")
    return trainer, batch, transformer.init_params(cfg, seed=0,
                                                   device="cpu")


def _train(trainer, batch, state, start=0, save=None):
    losses, gnorms = [], []
    for i in range(start, STEPS):
        if i == 2 and save is not None:
            trainer.save_state(save, state)
        state, m = trainer.train_step(state, batch(i))
        assert m["step_ok"] == 1
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return state, losses, gnorms


def _eval(trainer, state):
    source = CIFARSource("cifar10", resolution=32, eval_size=EVAL_SIZE)
    ev = Evaluator(trainer.cfg, Transformer(trainer.cfg, state.params),
                   ecfg=trainer.ecfg, preproc=source.preproc, device="cpu",
                   trainer=trainer)
    em = ev.evaluate(source.eval_batches(EVAL_BATCH))
    return [em[k] for k in ("eval_top1_count", "eval_top5_count",
                            "eval_count")]


def _first_grads(trainer, state, batch):
    """Every leaf's gradient of the first batch at the initial params,
    whole (gathered over the data and model groups)."""
    grads, _ = trainer.grads(state.params, batch(0))
    if trainer.data is not None and trainer.ecfg.zero_stage >= 2:
        grads = trainer._whole(grads, trainer.opt_dims)
    return {k: g.detach().numpy().copy()
            for k, g in trainer.model_whole(grads).items()}


def _case(world, case, root):
    arch, lay, zero = case
    trainer, batch, params = _trainer(arch, zero=zero,
                                      model=LAYOUTS[lay][1], world=world)
    state = trainer.init_state(params)
    grads = _first_grads(trainer, state, batch)
    state, losses, gnorms = _train(
        trainer, batch, state,
        save=os.path.join(root, _name(case)) if case in SAVED else None)
    return {"losses": losses, "gnorms": gnorms,
            # the whole gradients travel from rank 0; every rank sends
            # their sums, which must agree
            "grads": grads if world.rank == 0 else None,
            "grad_sums": {k: float(np.abs(g).sum())
                          for k, g in grads.items()},
            "eval": _eval(trainer, state) if arch == "vit-b16" else None}


def _resume_one(world, root):
    """The one-process save after step 2 restored at model axis 2, then
    step 2."""
    trainer, batch, _ = _trainer(CKPT_ARCH, model=2, world=world)
    state = trainer.restore_state(os.path.join(root, "one"))
    _, losses, gnorms = _train(trainer, batch, state, start=2)
    return {"step": state.step, "losses": losses, "gnorms": gnorms}


def _run_jobs(world, lay, root):
    out = {case: _case(world, case, root) for case in CASES
           if case[1] == lay}
    if lay == "m2":
        out["resume-one"] = _resume_one(world, root)
    return out


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """{arch: the one-process run's losses, grad norms, first-step
    gradients and (ViT) eval counts}; ChatGLM3's run saves after step 2
    under ``root/one``. Returns (runs, root)."""
    root = tmp_path_factory.mktemp("tp-ckpt")
    out = {}
    for arch in ARCHS:
        trainer, batch, params = _trainer(arch)
        state = trainer.init_state(params)
        grads = _first_grads(trainer, state, batch)
        state, losses, gnorms = _train(
            trainer, batch, state,
            save=os.path.join(root, "one") if arch == CKPT_ARCH else None)
        out[arch] = {"losses": losses, "gnorms": gnorms, "grads": grads,
                     "eval": _eval(trainer, state)
                     if arch == "vit-b16" else None}
    return out, root


@pytest.fixture(scope="module")
def worlds(one_process):
    """{layout: [each rank's results]}, the three worlds side by side."""
    root = str(one_process[1])
    with concurrent.futures.ThreadPoolExecutor(len(LAYOUTS)) as pool:
        runs = {lay: pool.submit(distributed.spawn, _run_jobs, size, lay,
                                 root, device="cpu", deadline_s=DEADLINE_S,
                                 timeout_s=60)
                for lay, (size, _) in LAYOUTS.items()}
        return {lay: run.result() for lay, run in runs.items()}


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_model_axis_matches_one_process(case, worlds, one_process):
    """Losses and grad norms within 3e-4 of one process's, the same on
    every rank; every leaf's first-step gradient, gathered whole, within
    2e-4 (and the same on every rank); the ViT's eval counts equal."""
    arch, lay, _ = case
    ranks = [r[case] for r in worlds[lay]]
    want = one_process[0][arch]
    for r in ranks:
        assert np.max(np.abs(np.subtract(r["losses"],
                                         want["losses"]))) <= TP_TOL
        assert np.max(np.abs(np.subtract(r["gnorms"],
                                         want["gnorms"]))) <= TP_TOL
        assert r["losses"] == ranks[0]["losses"]
        assert r["eval"] == want["eval"]
        assert r["grad_sums"] == ranks[0]["grad_sums"]
    got = ranks[0]["grads"]
    assert set(got) == set(want["grads"])
    for k, g in got.items():
        assert g.shape == want["grads"][k].shape, k
        np.testing.assert_allclose(g, want["grads"][k], atol=GRAD_TOL,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("case", SAVED, ids=_name)
def test_model_axis_checkpoint_resumes_in_one_process(case, worlds,
                                                      one_process):
    """A world's save after step 2 (each rank its model chunk, and its
    ZeRO chunk of that; a replicated leaf by model rank 0; the D6 KV
    projections whole), then step 2 in one process: within 1e-5 of the
    world's own step 2 from the same state. The manifest names the model
    axis."""
    root = one_process[1]
    assert case in worlds[case[1]][0]
    path = os.path.join(root, _name(case))
    with open(os.path.join(path, "step_00000002", "manifest.json")) as f:
        manifest = json.load(f)
    size, m = LAYOUTS[case[1]]
    assert manifest["mesh"] == {"data": size // m, "pipe": 1, "model": m}
    specs = {k: v["spec"] for k, v in manifest["leaves"].items()}
    assert specs["params/stack/attn/wq"][-1] == "model"
    assert specs["params/embed/tok"][0] == "model"
    assert "model" not in specs["params/final_norm/scale"]
    # KH 2 on a model axis of 4: the KV projections are written whole
    assert ("model" in specs["params/stack/attn/wk"]) == (m == 2)
    trainer, batch, _ = _trainer(CKPT_ARCH)
    state = trainer.restore_state(path)
    assert state.step == 2
    _, tail, tail_g = _train(trainer, batch, state, start=2)
    want = worlds[case[1]][0][case]
    assert abs(tail[0] - want["losses"][2]) <= RESUME_TOL
    assert abs(tail_g[0] - want["gnorms"][2]) <= RESUME_TOL


def test_one_process_save_resumes_at_model_axis_2(worlds, one_process):
    """The one-process save after step 2 restored at model axis 2: step 2
    within 1e-5 of the one-process run's, on every rank."""
    want = one_process[0][CKPT_ARCH]
    for r in worlds["m2"]:
        got = r["resume-one"]
        assert got["step"] == 2
        assert abs(got["losses"][0] - want["losses"][2]) <= RESUME_TOL
        assert abs(got["gnorms"][0] - want["gnorms"][2]) <= RESUME_TOL
