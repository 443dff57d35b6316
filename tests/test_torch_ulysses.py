"""Port parity for Ulysses sequence parallelism (``--seq-parallel
ulysses``, ``core/ulysses.py``): the layout decision against the
reference's ``make_hints`` for every config; the all-to-all pair and the
row gather of ``models/shardctx.py`` on gloo worlds of 2 and 4 at uneven
sequence splits (65 and 197 rows); three fp32 training steps under the
Ulysses layout against the one-process ``Trainer`` on the same params
(seed 0) and batches, for the ViT (model 2 and 4, and data 2 x model 2 at
ZeRO 2), Qwen2.5 (model 2; and data 2 x model 4 at ZeRO 3, the reference
test's own case, which takes the tensor-parallel fallback: its 2 KV heads
do not split 4 ways), Gemma3 (its sliding window biting), HuBERT (the
masked-frame loss) and Granite-MoE (GShard and gather at model 2, GShard
at data 2 x model 2 under ZeRO 3 and at 33 rows: the MoE on the gathered
rows with E/M experts a rank, its aux counted once); the sequence
all-gather and reduce-scatter of ``shardctx`` with ranks as threads;
checkpoints between the Ulysses layout, one process and the
tensor-parallel layout (Qwen2.5 and Granite-MoE); the ViT's eval counts; a
NaN batch that every rank skips alike; the refusals.

Tolerances: the reference's tensor-parallel bound for losses and grad
norms (3e-4, ``tests/test_engine_distributed.py:79-101``), 2e-4 for each
leaf's first-step gradient (the data-parallel tests'), the resume parity
1e-5 of ``tests/test_torch_checkpoint.py``; the all-to-alls bitwise, the
eval counts exactly. The spawned ranks import this module, so it imports
no JAX at module level.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import concurrent.futures  # noqa: E402
import os  # noqa: E402
import threading  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.configs.base import EngineConfig  # noqa: E402
from repro_torch.core import distributed, ulysses  # noqa: E402
from repro_torch.core.engine import Evaluator, Trainer, \
    to_device  # noqa: E402
from repro_torch.data.datasets import CIFARSource  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.launch.specs import concrete_batch  # noqa: E402
from repro_torch.models import shardctx, transformer  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

TP_TOL, GRAD_TOL, RESUME_TOL = 3e-4, 2e-4, 1e-5
STEPS, BATCH, ACCUM = 3, 8, 2
EVAL_SIZE, EVAL_BATCH = 40, 8
DEADLINE_S = 240
A2A_SEQS = (65, 197)
A2A_HEADS, A2A_DIM = 8, 3
GRANITE = "granite-moe-3b-a800m"
# case -> (arch, tokens a sequence (None: the ViT's 65), world size,
# model axis, ZeRO stage[, the MoE's dispatch])
CASES = {
    "vit-m2": ("vit-b16", None, 2, 2, 0),
    "vit-m4": ("vit-b16", None, 4, 4, 0),
    "vit-dp2-m2-z2": ("vit-b16", None, 4, 2, 2),
    "qwen-m2": ("qwen2.5-14b", 33, 2, 2, 0),
    "qwen-dp2-m4-z3": ("qwen2.5-14b", 32, 8, 4, 3),
    "gemma3-m2": ("gemma3-12b", 129, 2, 2, 0),
    "hubert-m2": ("hubert-xlarge", 33, 2, 2, 0),
    "granite-m2": (GRANITE, 32, 2, 2, 0),
    "granite-gather-m2": (GRANITE, 32, 2, 2, 0, "gather"),
    "granite-dp2-m2-z3": (GRANITE, 32, 4, 2, 3),
    "granite-m2-s33": (GRANITE, 33, 2, 2, 0),
}
FALLBACK = {"qwen-dp2-m4-z3"}
CKPT_CASE = "qwen-m2"
# the cases whose step-2 save resumes elsewhere, and Granite's
CKPT_CASES = (CKPT_CASE, "granite-m2")
GRANITE_CASES = [n for n in CASES if CASES[n][0] == GRANITE]


def _trainer(arch, seq, *, zero=0, model=1, world=None, sp="ulysses",
             impl=None):
    """(trainer, host batch source, fresh params of seed 0), fp32, batch 8
    in 2 microbatches: procedural CIFAR-10 for the ViT, ``concrete_batch``
    of ``seq`` positions for the rest; ``impl`` the MoE's dispatch."""
    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    if impl is not None:
        cfg = cfg.replace(moe_impl=impl)
    ecfg = EngineConfig(train_batch_size=BATCH,
                        gradient_accumulation_steps=ACCUM, zero_stage=zero,
                        lr=1e-3, total_steps=10, warmup_steps=1,
                        sequence_parallel=sp)
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
            return to_device(concrete_batch(cfg, BATCH, seq, seed=step),
                             "cpu")
    return trainer, batch, transformer.init_params(cfg, seed=0,
                                                   device="cpu")


def _train(trainer, batch, state, start=0, save=None, auxes=None):
    losses, gnorms = [], []
    for i in range(start, STEPS):
        if i == 2 and save is not None:
            trainer.save_state(save, state)
        state, m = trainer.train_step(state, batch(i))
        assert m["step_ok"] == 1
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if auxes is not None:
            auxes.append(float(m["moe_aux"]))
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


# --- the spawned worlds ------------------------------------------------------

def _a2a(world, s):
    """The pair and the gather on ``s`` rows split over ``world``: each
    rank's outputs and the gradients their backwards give."""
    gen = np.random.default_rng(s)
    full = torch.from_numpy(gen.standard_normal(
        (2, s, A2A_HEADS, A2A_DIM)).astype(np.float32))
    cot = torch.from_numpy(gen.standard_normal(
        (2, s, A2A_HEADS, A2A_DIM)).astype(np.float32))
    with shardctx.use_sequence(world):
        split = shardctx.split_sequence(s)
        m, hm = world.rank, A2A_HEADS // world.size
        x = full[:, split.rows].clone().requires_grad_()
        y = shardctx.seq_to_heads(x, split)
        back = shardctx.heads_to_seq(y, split)
        # each backward against the other's forward on the same cotangent
        dy = cot[:, :, m * hm:(m + 1) * hm].contiguous()
        dx, = torch.autograd.grad(y, x, dy)
        y2 = y.detach().requires_grad_()
        dx_rows = cot[:, split.rows].contiguous()
        dy2, = torch.autograd.grad(shardctx.heads_to_seq(y2, split), y2,
                                   dx_rows)
        with torch.no_grad():
            fwd_h2s = shardctx.heads_to_seq(dy, split)
            fwd_s2h = shardctx.seq_to_heads(dx_rows, split)
        g = x.detach().requires_grad_()
        gathered = shardctx.gather_seq(g, split)
        dg, = torch.autograd.grad(gathered, g, cot)
    return {"rows": (split.rows.start, split.rows.stop), "sizes": split.sizes,
            "y": y.detach().numpy(), "back": back.detach().numpy(),
            "x": x.detach().numpy(), "dx": dx.numpy(),
            "fwd_h2s": fwd_h2s.numpy(), "dy2": dy2.numpy(),
            "fwd_s2h": fwd_s2h.numpy(), "gathered": gathered.detach().numpy(),
            "dg": dg.numpy(), "cot_rows": dx_rows.numpy()}


def _impl(name):
    return CASES[name][5] if len(CASES[name]) > 5 else None


def _experts(state):
    """The routed experts a rank holds (their E axis), or None."""
    w = state.params.get("moe_stack.moe.experts.w_gate")
    return None if w is None else w.shape[1]


def _case(world, name, root):
    arch, seq, _, m, zero = CASES[name][:5]
    trainer, batch, params = _trainer(arch, seq, zero=zero, model=m,
                                      world=world, impl=_impl(name))
    state = trainer.init_state(params)
    experts = _experts(state)
    grads = _first_grads(trainer, state, batch)
    auxes = []
    state, losses, gnorms = _train(
        trainer, batch, state,
        save=os.path.join(root, name) if name in CKPT_CASES else None,
        auxes=auxes)
    return {"ulysses": trainer.ulysses, "losses": losses, "gnorms": gnorms,
            "auxes": auxes, "experts": experts,
            "grads": grads if world.rank == 0 else None,
            "grad_sums": {k: float(np.abs(g).sum())
                          for k, g in grads.items()},
            "eval": _eval(trainer, state) if arch == "vit-b16" else None}


def _resume(world, path, sp, case=CKPT_CASE):
    """Restore ``path``'s step 2 of ``case``'s run under model axis 2
    (``sp``: the Ulysses or the tensor-parallel layout), then step 2."""
    arch, seq = CASES[case][:2]
    trainer, batch, _ = _trainer(arch, seq, model=2, world=world, sp=sp)
    state = trainer.restore_state(path)
    _, losses, gnorms = _train(trainer, batch, state, start=2)
    return {"ulysses": trainer.ulysses, "step": state.step,
            "losses": losses, "gnorms": gnorms}


def _nan_guard(world):
    """The ViT under Ulysses at model 2 on a float batch whose last image
    is NaN in its lower half (patches of model rank 1's rows only): every
    rank's guard skips, and the params stay as they were."""
    trainer, _, params = _trainer("vit-b16", None, model=2, world=world)
    state = trainer.init_state(params)
    images = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (BATCH, 32, 32, 3)).astype(np.float32))
    images[-1, 16:] = float("nan")
    before = {k: p.clone() for k, p in state.params.items()}
    state, m = trainer.train_step(state, {
        "images": images, "labels": torch.arange(BATCH) % 10})
    return {"step_ok": m["step_ok"], "step": state.step,
            "loss": float(m["loss"]),
            "unchanged": all(torch.equal(before[k], p)
                             for k, p in state.params.items())}


def _run_jobs(world, root):
    out = {name: _case(world, name, root) for name, c in CASES.items()
           if c[2] == world.size}
    if world.size in (2, 4):
        out["a2a"] = {s: _a2a(world, s) for s in A2A_SEQS}
    if world.size == 2:
        out["nan"] = _nan_guard(world)
        out["resume-tp"] = _resume(world, os.path.join(root, CKPT_CASE),
                                   "none")
        out["resume-ulysses"] = _resume(world, os.path.join(root, "one"),
                                        "ulysses")
        for case in CKPT_CASES[1:]:
            out[f"resume-tp:{case}"] = _resume(
                world, os.path.join(root, case), "none", case)
            out[f"resume-ulysses:{case}"] = _resume(
                world, os.path.join(root, _one_dir(case)), "ulysses", case)
    return out


def _one_key(name):
    arch, seq = CASES[name][:2]
    return arch, seq, _impl(name)


def _one_dir(case):
    """The directory of the one-process save of ``case``'s run."""
    return "one" if case == CKPT_CASE else f"one-{case}"


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """{(arch, seq, MoE dispatch): the one-process run's losses, grad
    norms, ``moe_aux``, first-step gradients and (ViT) eval counts}; the
    runs of CKPT_CASES save after step 2 under ``root/one`` (Qwen2.5's)
    and ``root/one-<case>``. Returns (runs, root)."""
    root = tmp_path_factory.mktemp("ulysses-ckpt")
    saves = {_one_key(c): _one_dir(c) for c in CKPT_CASES}
    out = {}
    for key in sorted({_one_key(n) for n in CASES}, key=str):
        arch, seq, impl = key
        trainer, batch, params = _trainer(arch, seq, sp="none", impl=impl)
        state = trainer.init_state(params)
        grads = _first_grads(trainer, state, batch)
        auxes = []
        state, losses, gnorms = _train(
            trainer, batch, state,
            save=os.path.join(root, saves[key]) if key in saves else None,
            auxes=auxes)
        out[key] = {"losses": losses, "gnorms": gnorms, "auxes": auxes,
                    "grads": grads, "experts": _experts(state),
                    "eval": _eval(trainer, state)
                    if arch == "vit-b16" else None}
    return out, root


@pytest.fixture(scope="module")
def worlds(one_process):
    """{world size: [each rank's results]}, the worlds side by side."""
    root = str(one_process[1])
    sizes = sorted({c[2] for c in CASES.values()} | {2, 4})
    with concurrent.futures.ThreadPoolExecutor(len(sizes)) as pool:
        runs = {n: pool.submit(distributed.spawn, _run_jobs, n, root,
                               device="cpu", deadline_s=DEADLINE_S,
                               timeout_s=60)
                for n in sizes}
        return {n: run.result() for n, run in runs.items()}


# --- (a) the layout decision ---------------------------------------------------

class _Mesh(SimpleNamespace):
    pass


@pytest.mark.parametrize("m", (2, 3, 4))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_layout_decision_matches_make_hints(arch, m):
    """``applies`` holds exactly where the reference's ``make_hints``
    returns the Ulysses hints (``attn_seq`` sequence-sharded on the model
    axis: M divides the query and the KV heads) and the family is one
    D8 names (Granite-MoE's plain attention blocks among them, its
    experts kept on the ``expert`` hint's model axis); the MLA, RWKV6 and
    Mamba2 families keep the tensor-parallel layout at every M."""
    from jax.sharding import PartitionSpec as P
    from repro import configs as ref_configs
    from repro.core.ulysses import make_hints

    mesh = _Mesh(axis_names=("data", "model"),
                 devices=np.empty((1, m), dtype=object))
    hints = make_hints(mesh, ref_configs.get_config(arch),
                       sequence_parallel="ulysses")
    cfg = configs.get_config(arch)
    ulysses_hints = hints.attn_seq == P("data", "model", None, None)
    d8 = cfg.arch_type in ("vit", "dense", "vlm", "audio", "moe") and \
        cfg.block_kind == "attn"
    assert ulysses.applies(cfg, m, "ulysses") == (ulysses_hints and d8)
    if cfg.has_moe:
        assert hints.expert == "model"
    if cfg.block_kind in ("mla", "rwkv6", "mamba2"):
        assert not ulysses.applies(cfg, m, "ulysses")
    assert not ulysses.applies(cfg, m, "none")
    assert not ulysses.applies(cfg, 1, "ulysses")
    none = make_hints(mesh, ref_configs.get_config(arch))
    assert none.attn_seq != P("data", "model", None, None)


# --- (b) the all-to-all pair and the gather ------------------------------------

@pytest.mark.parametrize("s", A2A_SEQS)
@pytest.mark.parametrize("size", (2, 4))
def test_seq_to_heads_is_the_plain_permute(size, s, worlds):
    """Rank m's (B, S_m, H, hd) rows become every row of its H/M heads,
    the rows split as ``tensor_split`` splits them (uneven: 65 and 197 do
    not divide by 2 or 4); ``heads_to_seq`` gives the rows back bitwise."""
    ranks = [r["a2a"][s] for r in worlds[size]]
    sizes = [len(range(*r["rows"])) for r in ranks]
    assert sizes == ranks[0]["sizes"] == [
        len(c) for c in np.array_split(np.arange(s), size)]
    assert len(set(sizes)) == 2
    x = np.concatenate([r["x"] for r in ranks], axis=1)
    hm = A2A_HEADS // size
    for m, r in enumerate(ranks):
        np.testing.assert_array_equal(r["y"], x[:, :, m * hm:(m + 1) * hm])
        np.testing.assert_array_equal(r["back"], r["x"])
    # the ranks' heads concatenated are the whole (B, S, H, hd)
    np.testing.assert_array_equal(
        np.concatenate([r["y"] for r in ranks], axis=2), x)


@pytest.mark.parametrize("s", A2A_SEQS)
@pytest.mark.parametrize("size", (2, 4))
def test_each_reshard_backward_is_the_other_forward(size, s, worlds):
    """``seq_to_heads``' backward is ``heads_to_seq``'s forward on the
    same cotangent and the other way round, bitwise; ``gather_seq``
    gathers every rank's rows and its backward takes this rank's rows."""
    ranks = [r["a2a"][s] for r in worlds[size]]
    x = np.concatenate([r["x"] for r in ranks], axis=1)
    for r in ranks:
        np.testing.assert_array_equal(r["dx"], r["fwd_h2s"])
        np.testing.assert_array_equal(r["dy2"], r["fwd_s2h"])
        np.testing.assert_array_equal(r["gathered"], x)
        np.testing.assert_array_equal(r["dg"], r["cot_rows"])


# --- (c) training, (e) eval ----------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_ulysses_matches_one_process(name, worlds, one_process):
    """Losses and grad norms within 3e-4 of one process's, the same on
    every rank; every leaf's first-step gradient within 2e-4 (the same
    on every rank); the layout is Ulysses but for the fallback case."""
    size = CASES[name][2]
    ranks = [r[name] for r in worlds[size]]
    want = one_process[0][_one_key(name)]
    for r in ranks:
        assert r["ulysses"] == (name not in FALLBACK)
        assert np.max(np.abs(np.subtract(r["losses"],
                                         want["losses"]))) <= TP_TOL
        assert np.max(np.abs(np.subtract(r["gnorms"],
                                         want["gnorms"]))) <= TP_TOL
        assert r["losses"] == ranks[0]["losses"]
        assert r["grad_sums"] == ranks[0]["grad_sums"]
    got = ranks[0]["grads"]
    assert set(got) == set(want["grads"])
    for k, g in got.items():
        assert g.shape == want["grads"][k].shape, k
        np.testing.assert_allclose(g, want["grads"][k], atol=GRAD_TOL,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("name", GRANITE_CASES)
def test_ulysses_moe_aux_counted_once(name, worlds, one_process):
    """Granite-MoE under Ulysses: every rank's ``moe_aux`` and loss (each
    the model group's sum) within 3e-4 of one process's at every step,
    so the aux, the same value on every rank, enters them once (counted
    M times it would add (M - 1)·moe_aux, ~0.01 here); each rank holds
    E/M of the routed experts, one process all E."""
    arch, _, size, m, _ = CASES[name][:5]
    want = one_process[0][_one_key(name)]
    e = configs.get_smoke_config(arch).moe.num_experts
    assert want["experts"] == e and min(want["auxes"]) > 1e-3
    for r in worlds[size]:
        got = r[name]
        assert got["ulysses"] and got["experts"] == e // m
        assert np.max(np.abs(np.subtract(got["auxes"],
                                         want["auxes"]))) <= TP_TOL
        assert np.max(np.abs(np.subtract(got["losses"],
                                         want["losses"]))) <= TP_TOL


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n][0] == "vit-b16"])
def test_ulysses_vit_eval_counts_equal_one_process(name, worlds,
                                                   one_process):
    """The ViT's eval after three steps: top-1, top-5 and count equal the
    one-process run's, on every rank (whole logits on every model rank)."""
    want = one_process[0][_one_key(name)]["eval"]
    for r in worlds[CASES[name][2]]:
        assert r[name]["eval"] == want


# --- (d) checkpoints across layouts --------------------------------------------

def test_ulysses_save_resumes_in_one_process(worlds, one_process):
    """The Ulysses save after step 2 (every leaf whole on the model axis,
    written by model rank 0), then step 2 in one process: within 1e-5 of
    the Ulysses run's own step 2."""
    root = one_process[1]
    arch, seq = CASES[CKPT_CASE][:2]
    trainer, batch, _ = _trainer(arch, seq, sp="none")
    state = trainer.restore_state(os.path.join(root, CKPT_CASE))
    assert state.step == 2
    _, tail, tail_g = _train(trainer, batch, state, start=2)
    want = worlds[2][0][CKPT_CASE]
    assert abs(tail[0] - want["losses"][2]) <= RESUME_TOL
    assert abs(tail_g[0] - want["gnorms"][2]) <= RESUME_TOL


def test_ulysses_save_resumes_under_tensor_parallelism(worlds):
    """The same save restored at model axis 2 in the tensor-parallel
    layout (each rank its model chunks): step 2 within 1e-5."""
    want = worlds[2][0][CKPT_CASE]
    for r in worlds[2]:
        got = r["resume-tp"]
        assert got["step"] == 2 and not got["ulysses"]
        assert abs(got["losses"][0] - want["losses"][2]) <= RESUME_TOL
        assert abs(got["gnorms"][0] - want["gnorms"][2]) <= RESUME_TOL


def test_one_process_save_resumes_under_ulysses(worlds, one_process):
    """The one-process save after step 2 restored under Ulysses at model
    axis 2: step 2 within 1e-5 of the one-process run's, on every rank."""
    want = one_process[0][_one_key(CKPT_CASE)]
    for r in worlds[2]:
        got = r["resume-ulysses"]
        assert got["step"] == 2 and got["ulysses"]
        assert abs(got["losses"][0] - want["losses"][2]) <= RESUME_TOL
        assert abs(got["gnorms"][0] - want["gnorms"][2]) <= RESUME_TOL


def test_granite_ulysses_save_resumes_in_one_process(worlds, one_process):
    """Granite-MoE's Ulysses save after step 2 (the experts as each model
    rank's E/M, every other leaf whole), then step 2 in one process:
    within 1e-5 of the Ulysses run's own step 2."""
    case = CKPT_CASES[1]
    arch, seq = CASES[case][:2]
    trainer, batch, _ = _trainer(arch, seq, sp="none")
    state = trainer.restore_state(os.path.join(one_process[1], case))
    assert state.step == 2
    _, tail, tail_g = _train(trainer, batch, state, start=2)
    want = worlds[2][0][case]
    assert abs(tail[0] - want["losses"][2]) <= RESUME_TOL
    assert abs(tail_g[0] - want["gnorms"][2]) <= RESUME_TOL


def test_granite_ulysses_save_resumes_under_tensor_parallelism(worlds):
    """The same save restored at model axis 2 in the tensor-parallel
    layout: step 2 within 1e-5 of the Ulysses run's."""
    case = CKPT_CASES[1]
    want = worlds[2][0][case]
    for r in worlds[2]:
        got = r[f"resume-tp:{case}"]
        assert got["step"] == 2 and not got["ulysses"]
        assert abs(got["losses"][0] - want["losses"][2]) <= RESUME_TOL
        assert abs(got["gnorms"][0] - want["gnorms"][2]) <= RESUME_TOL


def test_one_process_granite_save_resumes_under_ulysses(worlds,
                                                        one_process):
    """Granite-MoE's one-process save after step 2 restored under Ulysses
    at model axis 2 (each rank reads its experts' chunk): step 2 within
    1e-5 of the one-process run's, on every rank."""
    case = CKPT_CASES[1]
    want = one_process[0][_one_key(case)]
    for r in worlds[2]:
        got = r[f"resume-ulysses:{case}"]
        assert got["step"] == 2 and got["ulysses"]
        assert abs(got["losses"][0] - want["losses"][2]) <= RESUME_TOL
        assert abs(got["gnorms"][0] - want["gnorms"][2]) <= RESUME_TOL


# --- (g) the sequence all-gather and reduce-scatter ---------------------------

class _ThreadRank:
    """Rank ``rank`` of ranks run as threads of one process, with
    ``World.all_to_all``'s contract: block ``sends[i]`` to rank i, a block
    of ``shapes[i]`` back from each rank i, in rank order."""

    def __init__(self, rank, shared):
        self.rank, self.size, self.shared = rank, len(shared["slots"]), \
            shared

    def all_to_all(self, sends, shapes):
        slots, barrier = self.shared["slots"], self.shared["barrier"]
        slots[self.rank] = [t.clone() for t in sends]
        barrier.wait()
        got = [slots[i][self.rank] for i in range(self.size)]
        barrier.wait()
        assert [tuple(t.shape) for t in got] == [tuple(x) for x in shapes]
        return got


@pytest.mark.parametrize("s", A2A_SEQS)
@pytest.mark.parametrize("size", (2, 4))
def test_sequence_gather_and_reduce_scatter_are_adjoint(size, s):
    """``all_gather_seq`` joins every rank's rows (uneven: 65 and 197 do
    not divide by 2 or 4) and its backward is ``reduce_scatter_seq``'s
    forward on the same cotangents, bitwise; ``reduce_scatter_seq`` sums
    the ranks' rows of their partial sums (against numpy's sum, 1e-6)
    and its backward is ``all_gather_seq``'s forward, bitwise. Unlike
    ``gather_seq``, whose backward only slices, the gather's backward
    sums the ranks' gradients."""
    gen = np.random.default_rng(s + size)
    shape = (2, s, A2A_DIM)
    full = gen.standard_normal(shape).astype(np.float32)
    # a different cotangent of the whole rows (and partial sum) a rank
    parts = gen.standard_normal((size,) + shape).astype(np.float32)
    row_cot = gen.standard_normal(shape).astype(np.float32)
    shared = {"slots": [None] * size,
              "barrier": threading.Barrier(size, timeout=30)}
    got, errors = [None] * size, []

    def rank(m):
        try:
            split = shardctx.SeqSplit(_ThreadRank(m, shared),
                                      shardctx.seq_split(s, size))
            rows = split.rows
            x = torch.from_numpy(full[:, rows].copy()).requires_grad_()
            gathered = shardctx.all_gather_seq(x, split)
            dx, = torch.autograd.grad(gathered, x,
                                      torch.from_numpy(parts[m]))
            y = torch.from_numpy(parts[m].copy()).requires_grad_()
            reduced = shardctx.reduce_scatter_seq(y, split)
            dy, = torch.autograd.grad(reduced, y, torch.from_numpy(
                row_cot[:, rows].copy()))
            with torch.no_grad():
                fwd_rs = shardctx.reduce_scatter_seq(
                    torch.from_numpy(parts[m]), split)
                fwd_ag = shardctx.all_gather_seq(torch.from_numpy(
                    row_cot[:, rows].copy()), split)
            got[m] = {"rows": rows, "gathered": gathered.detach().numpy(),
                      "dx": dx.numpy(), "fwd_rs": fwd_rs.numpy(),
                      "reduced": reduced.detach().numpy(),
                      "dy": dy.numpy(), "fwd_ag": fwd_ag.numpy()}
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            shared["barrier"].abort()
    threads = [threading.Thread(target=rank, args=(m,)) for m in range(size)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    assert len({r["rows"].stop - r["rows"].start for r in got}) == 2
    total = parts.sum(0)
    for r in got:
        np.testing.assert_array_equal(r["gathered"], full)
        np.testing.assert_array_equal(r["dx"], r["fwd_rs"])
        np.testing.assert_allclose(r["reduced"], total[:, r["rows"]],
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(r["reduced"], r["fwd_rs"])
        np.testing.assert_array_equal(r["dy"], r["fwd_ag"])
        np.testing.assert_array_equal(r["fwd_ag"], row_cot)


# --- (f) the guard and the refusals --------------------------------------------

def test_nan_rows_on_one_rank_are_skipped_by_every_rank(worlds):
    """NaN in the patches of model rank 1's rows only: the attention
    spreads it, the loss is NaN on both ranks, and both skip the
    update with the params bitwise unchanged."""
    for r in worlds[2]:
        got = r["nan"]
        assert got["step_ok"] == 0 and got["step"] == 0
        assert np.isnan(got["loss"]) and got["unchanged"]


def test_ulysses_refusals():
    """Ulysses with a pipeline is refused, as the reference refuses it
    (the mirror of ``tests/test_pipeline.py:157``); so is a value other
    than "none" or "ulysses" (the reference reads it as "none": caveat
    R6), by the engine config and by the CLI, before any rank starts."""
    ecfg = EngineConfig(train_batch_size=16, gradient_accumulation_steps=4,
                        pipeline_stages=2, sequence_parallel="ulysses")
    with pytest.raises(ValueError, match="sequence parallelism"):
        ecfg.validate(2)
    with pytest.raises(ValueError, match="sequence_parallel must be"):
        EngineConfig(sequence_parallel="ulyses").validate(1)
    EngineConfig(train_batch_size=16, gradient_accumulation_steps=4,
                 pipeline_stages=2).validate(2)
    with pytest.raises(SystemExit, match="does not compose with Ulysses"):
        cli.main(["--smoke", "--steps", "1", "--accum", "2", "--pp", "2",
                  "--seq-parallel", "ulysses", "--device", "cpu"])
    with pytest.raises(SystemExit, match="sequence_parallel must be"):
        cli.main(["--smoke", "--steps", "1", "--seq-parallel", "ring",
                  "--devices", "2", "--model-axis", "2", "--device",
                  "cpu"])
    with pytest.raises(ValueError, match="plain attention families"):
        with shardctx.use_sequence(SimpleNamespace(size=2, rank=0)):
            cfg = configs.get_smoke_config("rwkv6-7b")
            transformer.forward(cfg, transformer.init_params(
                cfg, device="cpu"), {"tokens": torch.zeros(
                    (1, 8), dtype=torch.int64)})
