"""Port parity for pipeline and tensor parallelism together (``--pp`` with
``--model-axis``, Megatron-DeepSpeed's data x pipe x model layout): gloo
worlds of pipe 2 x model 2 (the flat and the interleaved 1F1B schedule)
and data 2 x pipe 2 x model 2 at ZeRO 3, against the one-process
``Trainer`` on the same params (seed 0) and batches, for the smoke
configs of the ViT (its class head split over the model group on the
last stage, its eval counts) and ChatGLM3-6B (the vocab-parallel
embedding on the first stage, the vocab-parallel loss on the last);
``Trainer._reduce_sq``'s counting of each kind of leaf; checkpoints saved
at pipe 2 x model 2 restored in one process, at ``--pp 2`` alone and at
``--model-axis 2`` alone, and a one-process save restored at pipe 2 x
model 2; the CLI.

Tolerances: the reference's tensor-parallel bound for losses and grad
norms (3e-4, ``tests/test_engine_distributed.py:92-101``), 2e-4 for each
leaf's first-step gradient gathered whole, 1e-5 for the resume parity
(``tests/test_torch_checkpoint.py``) and for the squared norms. The
spawned ranks import this module, so it imports no JAX.
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
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.launch.specs import concrete_batch  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

TP_TOL, GRAD_TOL, RESUME_TOL, SQ_TOL = 3e-4, 2e-4, 1e-5, 1e-5
STEPS, BATCH, ACCUM, SEQ, LAYERS = 3, 8, 2, 32, 4
EVAL_SIZE, EVAL_BATCH = 40, 8
DEADLINE_S = 240
# layout -> (world size, pipeline stages, model axis)
LAYOUTS = {"pp2-m2": (4, 2, 2), "dp2-pp2-m2": (8, 2, 2)}
# (arch, layout, ZeRO stage, interleave)
CASES = [(arch, "pp2-m2", 0, v) for arch in ("vit-b16", "chatglm3-6b")
         for v in (1, 2)] + \
    [(arch, "dp2-pp2-m2", 3, 1) for arch in ("vit-b16", "chatglm3-6b")]
CKPT = ("chatglm3-6b", "pp2-m2", 0, 1)
# the layouts that restore CKPT's save: (world size, pp, model)
RESTORES = {"pp2": (2, 2, 1), "m2": (2, 1, 2)}
# the leaf of each kind _reduce_sq counts, in ChatGLM3's smoke config
SQ_LEAVES = {"stacked, model-split": "stack.attn.wq",
             "stacked, whole on every model rank": "stack.ln1.scale",
             "not stacked, model-split": "embed.tok",
             "not stacked, replicated": "final_norm.scale"}


def _name(case):
    return "-".join(map(str, case))


def _trainer(arch, *, zero=0, pp=1, v=1, model=1, world=None):
    """(trainer, host batch source, fresh params of seed 0), fp32 at
    LAYERS layers, batch 8 in 2 microbatches: procedural CIFAR-10 for the
    ViT, ``concrete_batch`` of 32 positions for ChatGLM3."""
    cfg = configs.get_smoke_config(arch).replace(dtype="float32",
                                                 num_layers=LAYERS)
    ecfg = EngineConfig(train_batch_size=BATCH,
                        gradient_accumulation_steps=ACCUM, zero_stage=zero,
                        lr=1e-3, total_steps=10, warmup_steps=1,
                        pipeline_stages=pp, pipeline_interleave=v)
    kw = {"device": "cpu", "world": world, "model_axis": model}
    if cfg.arch_type == "vit":
        source = CIFARSource("cifar10", resolution=32, eval_size=EVAL_SIZE)
        pipe = DataPipeline(global_batch=BATCH, source=source)
        trainer = Trainer(cfg, ecfg, preproc=source.preproc, **kw)

        def batch(step):
            return to_device(pipe.batch_at(0, step), "cpu")
    else:
        trainer = Trainer(cfg, ecfg, **kw)

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
    whole (gathered over the data, model and pipe groups)."""
    grads, _ = trainer.grads(state.params, batch(0))
    if trainer.data is not None and trainer.ecfg.zero_stage >= 2:
        grads = trainer._whole(grads, trainer.opt_dims)
    return {k: g.detach().numpy().copy() for k, g in
            trainer.pipe_whole(trainer.model_whole(grads)).items()}


def _sq(trainer, state):
    """Each leaf's sum of squares of the rank's params as the optimizer's
    norm counts it (``_reduce_sq``): the whole leaf's, on every rank."""
    sq = {k: (p.detach().to(torch.float64) ** 2).sum()
          for k, p in state.params.items()}
    if trainer.data is not None:
        sq = trainer._reduce_sq(sq)
    return {k: float(v) for k, v in sq.items()}


def _case(world, case, root):
    arch, lay, zero, v = case
    _, pp, model = LAYOUTS[lay]
    trainer, batch, params = _trainer(arch, zero=zero, pp=pp, v=v,
                                      model=model, world=world)
    state = trainer.init_state(params)
    sq = _sq(trainer, state)
    # the state's chunks gathered whole over data, model and pipe
    full = trainer.full_params(state)
    whole = set(full) == set(params) and \
        all(torch.equal(p, params[k]) for k, p in full.items())
    grads = _first_grads(trainer, state, batch)
    state, losses, gnorms = _train(
        trainer, batch, state,
        save=os.path.join(root, _name(case)) if case == CKPT else None)
    return {"losses": losses, "gnorms": gnorms, "sq": sq, "whole": whole,
            "grads": grads if world.rank == 0 else None,
            "grad_sums": {k: float(np.abs(g).sum())
                          for k, g in grads.items()},
            "eval": _eval(trainer, state) if arch == "vit-b16" else None}


def _resume(world, root, src, pp, model):
    """The save of ``src`` after step 2 restored at ``pp`` stages and
    model axis ``model``, then step 2."""
    trainer, batch, _ = _trainer(CKPT[0], pp=pp, model=model, world=world)
    state = trainer.restore_state(os.path.join(root, src))
    _, losses, gnorms = _train(trainer, batch, state, start=2)
    return {"step": state.step, "losses": losses, "gnorms": gnorms}


def _run_jobs(world, lay, root):
    out = {case: _case(world, case, root) for case in CASES
           if case[1] == lay}
    if lay == "pp2-m2":
        out["resume-one"] = _resume(world, root, "one", 2, 2)
    return out


def _restore_jobs(world, root):
    return {name: _resume(world, root, _name(CKPT), pp, model)
            for name, (_, pp, model) in RESTORES.items()}


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """{arch: the one-process run's losses, grad norms, first-step
    gradients, squared norms and (ViT) eval counts};
    ChatGLM3's run saves after step 2 under ``root/one``. Returns (runs,
    root)."""
    root = tmp_path_factory.mktemp("tp-pp-ckpt")
    out = {}
    for arch in ("vit-b16", "chatglm3-6b"):
        trainer, batch, params = _trainer(arch)
        state = trainer.init_state(params)
        sq = _sq(trainer, state)
        grads = _first_grads(trainer, state, batch)
        state, losses, gnorms = _train(
            trainer, batch, state,
            save=os.path.join(root, "one") if arch == CKPT[0] else None)
        out[arch] = {"losses": losses, "gnorms": gnorms, "grads": grads,
                     "sq": sq, "eval": _eval(trainer, state)
                     if arch == "vit-b16" else None}
    return out, root


@pytest.fixture(scope="module")
def worlds(one_process):
    """({layout: [each rank's results]}, [the restoring world's ranks]):
    the two layouts side by side, then the world of two that restores the
    pipe 2 x model 2 save at ``--pp 2`` and at ``--model-axis 2``."""
    root = str(one_process[1])
    with concurrent.futures.ThreadPoolExecutor(len(LAYOUTS)) as pool:
        runs = {lay: pool.submit(distributed.spawn, _run_jobs, size, lay,
                                 root, device="cpu", deadline_s=DEADLINE_S,
                                 timeout_s=60)
                for lay, (size, _, _) in LAYOUTS.items()}
        out = {lay: run.result() for lay, run in runs.items()}
    restores = distributed.spawn(_restore_jobs, 2, root, device="cpu",
                                 deadline_s=DEADLINE_S, timeout_s=60)
    return out, restores


# --- training against one process --------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_name)
def test_pipe_and_model_match_one_process(case, worlds, one_process):
    """Losses and grad norms within 3e-4 of one process's, the same on
    every rank; every leaf's first-step gradient, gathered whole over the
    data, model and pipe groups, within 2e-4 (and the same on every
    rank); ``full_params`` of the initial state equal to the params it
    was built from; the ViT's eval counts equal."""
    arch, lay = case[:2]
    ranks = [r[case] for r in worlds[0][lay]]
    want = one_process[0][arch]
    for r in ranks:
        assert np.max(np.abs(np.subtract(r["losses"],
                                         want["losses"]))) <= TP_TOL
        assert np.max(np.abs(np.subtract(r["gnorms"],
                                         want["gnorms"]))) <= TP_TOL
        assert r["losses"] == ranks[0]["losses"]
        assert r["grad_sums"] == ranks[0]["grad_sums"]
        assert r["eval"] == want["eval"]
        assert r["whole"]
    got = ranks[0]["grads"]
    assert set(got) == set(want["grads"])
    for k, g in got.items():
        assert g.shape == want["grads"][k].shape, k
        np.testing.assert_allclose(g, want["grads"][k], atol=GRAD_TOL,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("lay", list(LAYOUTS))
@pytest.mark.parametrize("kind", list(SQ_LEAVES))
def test_reduce_sq_counts_each_leaf_once(kind, lay, worlds, one_process):
    """``_reduce_sq`` gives every rank each leaf's whole sum of squares,
    counted once over data, pipe and model: a stacked leaf the model axis
    splits (stage-local and split: summed over the pipe and the model
    group), a stacked norm scale (stage-local, whole on every model rank:
    the pipe group only), a non-stacked leaf the model axis splits (the
    model group only), a replicated one (no group); at ZeRO 3 each of
    them data-split too. Every leaf within 1e-5, relative."""
    key = SQ_LEAVES[kind]
    case = next(c for c in CASES if c[0] == "chatglm3-6b" and c[1] == lay)
    want = one_process[0]["chatglm3-6b"]["sq"]
    for r in worlds[0][lay]:
        got = r[case]["sq"]
        assert set(got) == set(want)
        assert abs(got[key] - want[key]) <= SQ_TOL * want[key], key
        for k, s in got.items():
            assert abs(s - want[k]) <= SQ_TOL * max(want[k], 1.0), k


# --- checkpoints --------------------------------------------------------------

def test_pipe_and_model_checkpoint_resumes_elsewhere(worlds, one_process):
    """The pipe 2 x model 2 save after step 2: a stacked leaf written as
    blocks with ``"pipe"`` on L and ``"model"`` on its model dimension, the
    manifest's mesh data 1 x pipe 2 x model 2; restored in one process, at
    ``--pp 2`` alone and at ``--model-axis 2`` alone, step 2 within 1e-5
    of the world's own step 2 from the same state."""
    root = one_process[1]
    path = os.path.join(root, _name(CKPT))
    with open(os.path.join(path, "step_00000002", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["mesh"] == {"data": 1, "pipe": 2, "model": 2}
    specs = {k: v["spec"] for k, v in manifest["leaves"].items()}
    assert specs["params/stack/attn/wq"] == ["pipe", None, "model"]
    assert specs["params/stack/ln1/scale"] == ["pipe", None]
    assert specs["params/embed/tok"] == ["model", None]
    assert "model" not in specs["params/final_norm/scale"]
    want = worlds[0][CKPT[1]][0][CKPT]
    trainer, batch, _ = _trainer(CKPT[0])
    state = trainer.restore_state(path)
    assert state.step == 2
    _, tail, tail_g = _train(trainer, batch, state, start=2)
    runs = [{"losses": tail, "gnorms": tail_g}] + \
        [r[name] for r in worlds[1] for name in RESTORES]
    for got in runs:
        assert abs(got["losses"][0] - want["losses"][2]) <= RESUME_TOL
        assert abs(got["gnorms"][0] - want["gnorms"][2]) <= RESUME_TOL


def test_one_process_save_resumes_at_pipe_and_model(worlds, one_process):
    """The one-process save after step 2 restored at pipe 2 x model 2:
    step 2 within 1e-5 of the one-process run's, on every rank."""
    want = one_process[0][CKPT[0]]
    for r in worlds[0]["pp2-m2"]:
        got = r["resume-one"]
        assert got["step"] == 2
        assert abs(got["losses"][0] - want["losses"][2]) <= RESUME_TOL
        assert abs(got["gnorms"][0] - want["gnorms"][2]) <= RESUME_TOL


# --- the CLI -------------------------------------------------------------------

def _losses(rows):
    return [(r["loss"], r["grad_norm"]) for r in rows if "loss" in r]


@pytest.mark.parametrize("v", [1, 2])
def test_cli_pipe_and_model_matches_one_process(v):
    """``--devices 4 --pp 2 --model-axis 2`` (flat, and ``--pp-interleave
    2``) for ChatGLM3-6B's smoke config at 4 layers, fp32, 2 steps of batch
    8 in 2 microbatches: every loss and grad norm within 3e-4 of
    ``--devices 0``'s."""
    base = ["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
            "--steps", "2", "--seq", "32", "--batch", "8", "--accum", "2",
            "--layers", str(LAYERS), "--dtype", "float32", "--log-every",
            "1"]
    want = _losses(cli.main(base + ["--devices", "0"]))
    got = _losses(cli.main(base + ["--devices", "4", "--pp", "2",
                                   "--pp-interleave", str(v),
                                   "--model-axis", "2"]))
    assert len(got) == len(want) == 2
    assert np.max(np.abs(np.subtract(got, want))) <= TP_TOL
