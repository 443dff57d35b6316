"""Port parity for data parallelism: the ZeRO sharding table against the
reference's ``param_specs``, microbatch membership, and training,
evaluation, the anomaly guard and the batch invariant on gloo worlds of
1, 2 and 4 CPU processes, against the single-device ``Trainer`` and the
reference's pure functions; the MoE decoder's global load-balance loss
and its ZeRO-3 checkpoint, saved at world 2 and restored on one device;
Zamba2's shared attention block, whose gradient sums over its uses, at
ZeRO 0 and 3 (gathered once before the embed, not a stacked leaf); the
HuBERT encoder on its drawn audio batches.

One world per size is spawned for the whole module (``_worlds``); its ranks
run every job of ``JOBS`` in order and send back numpy results. The ranks
import this module (the spawn start method pickles ``_run_jobs`` by
reference), so it imports no JAX at module level: the two tests that hold
the port against the reference import it themselves. Every world has a
hard deadline and is killed at it. Tolerances: 2e-4 for losses, grad
norms, params and moments, as ``tests/test_engine_distributed.py:43``;
3e-4 between ZeRO stages, as its ``:59-60``; the MoE aux rtol 1e-5, as
``tests/test_perf_options.py``'s; eval counts and checkpoints bitwise.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import concurrent.futures  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import EngineConfig  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.engine import Evaluator, Trainer, to_device  # noqa: E402
from repro_torch.core.grad_accum import split_microbatches  # noqa: E402
from repro_torch.core.sharding import shard_dims  # noqa: E402
from repro_torch.data.augment import AugmentConfig  # noqa: E402
from repro_torch.data.datasets import CIFARSource  # noqa: E402
from repro_torch.data.pipeline import DataPipeline, rank_rows  # noqa: E402
from repro_torch.data.synthetic import DATASETS  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.launch.specs import concrete_batch  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import Transformer, \
    init_params  # noqa: E402

TOL = 2e-4
STAGE_TOL = 3e-4
AUX_RTOL = 1e-5
GRANITE = "granite-moe-3b-a800m"
STEPS, BATCH, ACCUM = 3, 8, 2
WORLDS = (1, 2, 4)
DEADLINE_S = 240

# name -> (arch, zero stage, optimizer, augment, data[, remat]); "synthetic"
# is the fp32 stream, "cifar" procedural uint8 CIFAR-10, "tokens" the LM
# stream; remat checkpoints each layer (so ZeRO-3 gathers it again in the
# backward's recompute); "<arch>:gather" takes the MoE's gather dispatch
# at a capacity factor of 8, where no rank drops a token (deviation D4)
TRAIN_JOBS = {
    "vit-z0": ("vit-b16", 0, "adamw", False, "cifar"),
    "vit-z1": ("vit-b16", 1, "adamw", False, "cifar"),
    "vit-z2": ("vit-b16", 2, "adamw", False, "cifar"),
    "vit-z3": ("vit-b16", 3, "adamw", False, "cifar"),
    "vit-z3-lamb": ("vit-b16", 3, "lamb", False, "cifar"),
    "vit-z0-aug": ("vit-b16", 0, "adamw", True, "cifar"),
    "vit-z3-aug": ("vit-b16", 3, "adamw", True, "cifar"),
    "chatglm3-z3": ("chatglm3-6b", 3, "adamw", False, "tokens"),
    "rwkv6-z3": ("rwkv6-7b", 3, "adamw", False, "tokens"),
    "gemma3-z3": ("gemma3-12b", 3, "adamw", False, "tokens"),
    "gemma3-z3-block": ("gemma3-12b", 3, "adamw", False, "tokens", "block"),
    "gemma3-z3-dots": ("gemma3-12b", 3, "adamw", False, "tokens", "dots"),
    "granite-z0": (GRANITE, 0, "adamw", False, "tokens"),
    "granite-z1": (GRANITE, 1, "adamw", False, "tokens"),
    "granite-z2": (GRANITE, 2, "adamw", False, "tokens"),
    "granite-z3": (GRANITE, 3, "adamw", False, "tokens"),
    "granite-gather-z3": (GRANITE + ":gather", 3, "adamw", False, "tokens"),
    "deepseek-z3": ("deepseek-v3-671b", 3, "adamw", False, "tokens"),
    "zamba2-z3": ("zamba2-2.7b", 3, "adamw", False, "tokens"),
    "hubert-z3": ("hubert-xlarge", 3, "adamw", False, "audio"),
}
# the hybrid's gradients of one batch, whole, at each ZeRO stage here
HYBRID_GRAD_STAGES = (0, 3)
GRANITE_JOBS = [j for j in TRAIN_JOBS if j.startswith("granite")]
# the MoE decoders: Granite's jobs, and DeepSeek's smoke config at ZeRO-3
# (MLA, the MTP head, a shared expert and a leading dense layer, with every
# non-stacked mtp.* leaf gathered before the embed)
MOE_JOBS = GRANITE_JOBS + ["deepseek-z3"]
GUARD_STAGES = (1, 3)
EVAL_SIZE, EVAL_BATCH = 50, 8       # the last batch has 2 real rows


def _cfg(arch):
    arch, _, impl = arch.partition(":")
    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    if impl == "gather":
        cfg = cfg.replace(moe_impl="gather", moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    if arch == "rwkv6-7b":
        # fp32 RWKV6 gradients are ill-conditioned at the model's eps (the
        # repo's convention: tests/test_torch_rwkv6.py)
        cfg = cfg.replace(norm_eps=1e-3)
    return cfg


def _setup(job, world, init=None):
    """(trainer, pipeline, fresh params) of a ``TRAIN_JOBS`` entry, on a
    world or (None) on one device."""
    arch, zero, opt, augment, data, *remat = job
    cfg = _cfg(arch).replace(remat=remat[0] if remat else "none")
    ecfg = EngineConfig(train_batch_size=BATCH,
                        gradient_accumulation_steps=ACCUM,
                        zero_stage=zero if world is not None else 0,
                        optimizer=opt, lr=1e-3, total_steps=10,
                        warmup_steps=1)
    preproc = None
    if data == "tokens":
        pipe = DataPipeline(kind="token", global_batch=BATCH,
                            vocab=cfg.vocab_size, seq_len=32,
                            epoch_size=BATCH * STEPS)
    elif data == "audio":       # the CLI's audio feed: drawn by the step
        pipe = types.SimpleNamespace(batch_at=lambda _, i: concrete_batch(
            cfg, BATCH, 32, seed=i))
    elif data == "cifar":
        source = CIFARSource("cifar10", resolution=32, eval_size=8)
        preproc = source.preproc
        pipe = DataPipeline(global_batch=BATCH, source=source)
    else:
        pipe = DataPipeline(global_batch=BATCH, dataset=DATASETS["cifar10"],
                            resolution=32)
    aug = AugmentConfig(num_classes=cfg.num_classes) if augment else None
    trainer = Trainer(cfg, ecfg, preproc=preproc, device="cpu", aug=aug,
                      world=world)
    params = params_from_numpy(init) if init is not None else \
        init_params(cfg, seed=0, device="cpu")
    return trainer, pipe, params


def _np(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _train(trainer, pipe, params):
    state = trainer.init_state(params)
    shapes = {"params": {k: tuple(p.shape) for k, p in state.params.items()},
              "mu": {k: tuple(p.shape) for k, p in
                     state.opt_state.mu.items()}}
    losses, gnorms, auxes = [], [], []
    for i in range(STEPS):
        state, m = trainer.train_step(state, to_device(pipe.batch_at(0, i),
                                                       "cpu"))
        assert m["step_ok"] == 1
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        auxes.append(float(m["moe_aux"]))
    opt = trainer.full_opt_state(state)
    return {"losses": losses, "gnorms": gnorms, "auxes": auxes,
            "params": _np(trainer.full_params(state)), "mu": _np(opt.mu),
            "nu": _np(opt.nu), "shapes": shapes}


def _eval_counts(world, gather_stage=3):
    """Counts of the initial smoke ViT on a ragged, padded eval split; on
    a world, from a ZeRO-3 state, so the forward gathers its chunks."""
    cfg = _cfg("vit-b16")
    source = CIFARSource("cifar10", resolution=32, eval_size=EVAL_SIZE)
    ecfg = EngineConfig(train_batch_size=BATCH,
                        zero_stage=gather_stage if world else 0)
    trainer = Trainer(cfg, ecfg, preproc=source.preproc, device="cpu",
                      world=world)
    state = trainer.init_state(init_params(cfg, seed=0, device="cpu"))
    ev = Evaluator(cfg, Transformer(cfg, state.params), ecfg=ecfg,
                   preproc=source.preproc, device="cpu", trainer=trainer)
    return ev.evaluate(source.eval_batches(EVAL_BATCH))


def _guard(world, zero):
    """One healthy step, then a batch with a NaN pixel in the LAST rank's
    rows only: every rank must skip with its state bitwise unchanged, and
    take the next healthy step."""
    trainer, pipe, params = _setup(("vit-b16", zero, "adamw", False,
                                    "synthetic"), world)
    state = trainer.init_state(params)
    good = to_device(pipe.batch_at(0, 0), "cpu")
    state, m = trainer.train_step(state, good)
    snap = [_np(state.params), _np(state.opt_state.mu),
            _np(state.opt_state.nu)]
    bad = dict(good, images=good["images"].clone())
    last = world.size - 1 if world is not None else 0
    row = rank_rows(BATCH // ACCUM, last,
                    world.size if world is not None else 1).start
    bad["images"][row, 0, 0, 0] = float("nan")
    new, m_bad = trainer.train_step(state, bad)
    same = all(np.array_equal(a[k], b[k], equal_nan=True)
               for a, b in zip(snap, [_np(new.params), _np(new.opt_state.mu),
                                      _np(new.opt_state.nu)]) for k in a)
    _, m_next = trainer.train_step(new, good)
    return {"ok": [m["step_ok"], m_bad["step_ok"], m_next["step_ok"]],
            "unchanged": same, "step": new.step,
            "opt_step": new.opt_state.step}


def _invariant(world):
    """Two ways to break the batch invariant; every rank must raise."""
    out = []
    try:
        Trainer(_cfg("vit-b16"), EngineConfig(train_batch_size=16,
                                              micro_batch_per_gpu=3),
                device="cpu", world=world)
        out.append(None)
    except ValueError as e:
        out.append(str(e))
    trainer, pipe, params = _setup(("vit-b16", 3, "adamw", False,
                                    "synthetic"), world)
    state = trainer.init_state(params)
    batch = {k: v[:6] for k, v in to_device(pipe.batch_at(0, 0),
                                            "cpu").items()}
    try:
        trainer.train_step(state, batch)
        out.append(None)
    except ValueError as e:
        out.append(str(e))
    return out


def _collectives(world):
    """reduce_scatter / all_gather of a (4, 8, 12) tensor along each
    dimension: rank r's chunk of the sum, and the whole back."""
    out = {}
    t = torch.arange(4 * 8 * 12, dtype=torch.float32).reshape(4, 8, 12)
    for d in range(3):
        rs, = world.reduce_scatter_many([t * (world.rank + 1)], [d])
        whole, = world.all_gather_many([rs], [d])
        out[d] = (rs.numpy(), whole.numpy())
    # several leaves of two dtypes in one call each
    many = [x * (world.rank + 1) for x in (t[0], t.double(), t[:, :4])]
    rs = world.reduce_scatter_many(many, [1, 2, 0])
    out["many"] = [g.numpy() for g in world.all_gather_many(rs, [1, 2, 0])]
    return out


def _moe_gather(world):
    """ZeRO-3's gather of layer 0's slices of every ``moe_stack`` leaf (this
    rank's chunks) against the whole leaves' layer 0: True where equal."""
    trainer, _, params = _setup(TRAIN_JOBS["granite-z3"], world)
    whole = {k: v.clone() for k, v in params.items()}
    state = trainer.init_state(params)
    keys = [k for k in state.params if k.startswith("moe_stack.")]
    got = trainer.gather({k: state.params[k][0] for k in keys})
    sharded = [k for k in keys if trainer.param_dims[k] is not None]
    return {"sharded": sharded,
            "equal": {k: bool(torch.equal(got[k], whole[k][0]))
                      for k in keys}}


def _hybrid_grads(world, zero):
    """Loss and every gradient, whole, of zamba2-smoke's first batch from
    fresh params at ZeRO ``zero`` (one device: None)."""
    trainer, pipe, params = _setup(("zamba2-2.7b", zero, "adamw", False,
                                    "tokens"), world)
    state = trainer.init_state(params)
    grads, m = trainer.grads(state.params,
                             to_device(pipe.batch_at(0, 0), "cpu"))
    if world is not None:
        grads = trainer._whole(grads, trainer.opt_dims)
    return {"loss": float(m["loss"]), "grads": _np(grads)}


def _moe_ckpt(world, root):
    """Two granite-smoke steps at ZeRO-3, saved under ``root``; returns the
    whole state."""
    trainer, pipe, params = _setup(TRAIN_JOBS["granite-z3"], world)
    state = trainer.init_state(params)
    for i in range(2):
        state, _ = trainer.train_step(state, to_device(pipe.batch_at(0, i),
                                                       "cpu"))
    trainer.save_state(os.path.join(root, "granite-z3"), state)
    opt = trainer.full_opt_state(state)
    return {"params": _np(trainer.full_params(state)), "mu": _np(opt.mu),
            "nu": _np(opt.nu), "step": state.step}


def _run_jobs(world, jobs, init, root):
    """Every rank's body: run ``jobs`` in order, send back rank 0's
    results (and every rank's, where they must agree across ranks)."""
    out = {}
    for name in jobs:
        if name in TRAIN_JOBS:
            out[name] = _train(*_setup(TRAIN_JOBS[name], world))
        elif name == "reference":
            out[name] = _train(*_setup(("vit-b16", 3, "adamw", False,
                                        "synthetic"), world, init))
        elif name == "eval":
            out[name] = _eval_counts(world)
        elif name.startswith("guard"):
            out[name] = _guard(world, int(name[-1]))
        elif name == "invariant":
            out[name] = _invariant(world)
        elif name == "collectives":
            out[name] = _collectives(world)
        elif name == "moe-gather":
            out[name] = _moe_gather(world)
        elif name == "moe-ckpt":
            out[name] = _moe_ckpt(world, root)
        elif name.startswith("hybrid-grads"):
            out[name] = _hybrid_grads(world, int(name[-1]))
    return out


def _jobs(size):
    jobs = list(TRAIN_JOBS) + ["eval", "collectives"] + \
        [f"guard{z}" for z in GUARD_STAGES] + \
        [f"hybrid-grads{z}" for z in HYBRID_GRAD_STAGES]
    if size > 1:
        jobs += ["invariant", "moe-gather"]
    if size == 2:
        jobs += ["reference", "moe-ckpt"]
    return jobs


@pytest.fixture(scope="module")
def ref_init():
    """The reference's smoke ViT params (fp32), as numpy."""
    import jax
    from repro import configs as ref_configs
    from repro.models import transformer as ref_model
    cfg = ref_configs.get_smoke_config("vit-b16").replace(dtype="float32")
    params = jax.jit(lambda k: ref_model.init_params(cfg, k))(
        jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return tmp_path_factory.mktemp("dp-ckpt")


@pytest.fixture(scope="module")
def _worlds(ref_init, ckpt_root):
    """{world size: [each rank's results]}, one spawned world per size,
    the worlds side by side."""
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {size: pool.submit(
            distributed.spawn, _run_jobs, size, _jobs(size), ref_init[2],
            str(ckpt_root), device="cpu", deadline_s=DEADLINE_S,
            timeout_s=60)
            for size in WORLDS}
        return {size: run.result() for size, run in runs.items()}


@pytest.fixture(scope="module")
def single():
    """The single-device Trainer's results for every train job."""
    return {name: _train(*_setup(job, None))
            for name, job in TRAIN_JOBS.items()}


def _close(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0,
                                   err_msg=f"{what} {k}")


# --- the sharding table ----------------------------------------------------

def _flat_specs(tree, prefix=""):
    from jax.sharding import PartitionSpec
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, PartitionSpec):
            out[prefix + name] = leaf
        else:
            out.update(_flat_specs(leaf, f"{prefix}{name}."))
    return out


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("arch", ["vit-b16", "chatglm3-6b", "rwkv6-7b",
                                  "deepseek-v3-671b", "hubert-xlarge",
                                  "zamba2-2.7b"])
def test_shard_dims_match_reference(arch, world):
    """At full size, for params at ZeRO-3 and the optimizer state at
    stages 1-3, the port's sharded dimension of every key is where the
    reference's ``param_specs`` (``tensor_parallel=False``, a stand-in mesh
    with only ``axis_names`` and ``devices``) puts ``data``."""
    import jax
    from repro import configs as ref_configs
    from repro.core.sharding import param_specs
    from repro.models import transformer as ref_model
    ref_cfg = ref_configs.get_config(arch)
    shapes = jax.eval_shape(lambda: ref_model.init_params(
        ref_cfg, jax.random.PRNGKey(0)))
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((world, 1)))
    port = {k: tuple(p.shape) for k, p in init_params(
        configs.get_config(arch), device="meta").items()}
    for stage, for_opt in ((3, False), (1, True), (2, True), (3, True),
                           (0, True), (1, False)):
        specs = _flat_specs(param_specs(
            shapes, zero_stage=stage, tensor_parallel=False, mesh=mesh,
            for_opt_state=for_opt))
        want = {k: (list(s).index("data") if "data" in s else None)
                for k, s in specs.items()}
        got = shard_dims(port, zero_stage=stage, world=world,
                         for_opt_state=for_opt)
        assert got == want, (stage, for_opt)


def test_shard_dims_of_vit_b16_at_zero3():
    """The layout the reference gives ViT-B/16 at ZeRO-3: replicated
    leaves the world does not divide, last-dimension norms and biases,
    input-dimension projections."""
    shapes = {k: tuple(p.shape) for k, p in init_params(
        configs.get_config("vit-b16"), device="meta").items()}
    for world in (2, 4):
        d = shard_dims(shapes, zero_stage=3, world=world)
        assert d["embed.cls"] is None and d["stack.mlp.b_up"] is None
        assert d["head.b"] == (0 if world == 2 else None)
        for k in ("embed.patch_w", "embed.pos", "stack.attn.wo",
                  "stack.mlp.w_out", "stack.ln1.scale", "stack.ln2.bias",
                  "stack.mlp.b_out"):
            assert d[k] == len(shapes[k]) - 1, k
        for k in ("stack.attn.wq", "stack.attn.wk", "stack.attn.wv",
                  "stack.mlp.w_up"):
            assert d[k] == 1, k
        assert d["head.w"] == 0
    assert set(shard_dims(shapes, zero_stage=2, world=2).values()) == {None}
    assert shard_dims(shapes, zero_stage=0, world=2,
                      for_opt_state=True)["head.w"] is None


def test_zero_stage_is_checked():
    assert EngineConfig().zero_stage == 0
    for bad in (-1, 4):
        with pytest.raises(ValueError, match="zero_stage"):
            EngineConfig(zero_stage=bad)
    with pytest.raises(ValueError, match="needs a data-parallel world"):
        Trainer(_cfg("vit-b16"), EngineConfig(zero_stage=1), device="cpu")


# --- microbatch membership -------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 4])
def test_rank_rows_of_the_global_microbatches(world):
    """Microbatch i of rank r is rows [i*m + r*m/w, i*m + (r+1)*m/w) of the
    global batch: the ranks' parts of microbatch i together are the
    reference's global microbatch i (``split_microbatches``), which
    ``local_shard`` followed by a split does not give."""
    from repro.core.grad_accum import split_microbatches as ref_split
    batch = {"x": np.arange(16 * 3).reshape(16, 3), "y": np.arange(16)}
    ref = ref_split(batch, 4)
    mbs = split_microbatches({k: torch.from_numpy(v) for k, v in
                              batch.items()}, 4)
    parts = [[{k: v[rank_rows(4, r, world)] for k, v in mb.items()}
              for mb in mbs] for r in range(world)]
    for i in range(4):
        for k in batch:
            got = torch.cat([p[i][k] for p in parts]).numpy()
            np.testing.assert_array_equal(got, np.asarray(ref[k][i]))
    pipe = DataPipeline(global_batch=16, dataset=DATASETS["cifar10"],
                        resolution=32)
    if world > 1:
        shard_first = split_microbatches(
            {k: torch.from_numpy(v) for k, v in
             pipe.local_shard(batch, 0, world).items()}, 4)
        assert shard_first[1]["y"].tolist() != parts[0][1]["y"].tolist()
    with pytest.raises(ValueError, match="not divisible by world"):
        rank_rows(6, 0, 4)


# --- the spawned worlds ----------------------------------------------------

def test_collective_layouts(_worlds):
    """A leaf sharded on dimension d: rank r gets chunk r of the sum, and
    the gather puts the chunks back in place."""
    for size, ranks in _worlds.items():
        t = np.arange(4 * 8 * 12, dtype=np.float32).reshape(4, 8, 12)
        total = t * sum(range(1, size + 1))
        for r, res in enumerate(ranks):
            for d in range(3):
                rs, whole = res["collectives"][d]
                np.testing.assert_array_equal(
                    rs, np.split(total, size, axis=d)[r])
                np.testing.assert_array_equal(whole, total)
            many = res["collectives"]["many"]
            for got, want in zip(many, (total[0], total, total[:, :4])):
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("job", [j for j in TRAIN_JOBS
                                 if TRAIN_JOBS[j][0] == "vit-b16"])
def test_vit_dp_matches_single_device(_worlds, single, world, job):
    """Smoke ViT, fp32, 3 steps of accum 2: losses, grad norms, gathered
    params and moments of every rank within 2e-4 of the single-device
    Trainer, at every ZeRO stage, with LAMB, and augmented."""
    want = single[job]
    for rank, res in enumerate(_worlds[world]):
        got = res[job]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=TOL)
        np.testing.assert_allclose(got["gnorms"], want["gnorms"], atol=TOL)
        for part in ("params", "mu", "nu"):
            _close(got[part], want[part], f"{job} world {world} rank "
                   f"{rank} {part}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("job", ["chatglm3-z3", "rwkv6-z3", "gemma3-z3",
                                 "gemma3-z3-block", "gemma3-z3-dots",
                                 "zamba2-z3", "hubert-z3"])
def test_decoders_at_zero3_match_single_device(_worlds, single, world, job):
    """A decoder's ZeRO-3 run against the single-device one; with remat
    against the single device's run without it (the layer's gather runs
    again in the recompute)."""
    want = single[job.replace("-block", "").replace("-dots", "")]
    got = _worlds[world][0][job]
    np.testing.assert_allclose(got["losses"], want["losses"], atol=TOL)
    np.testing.assert_allclose(got["gnorms"], want["gnorms"], atol=TOL)
    for part in ("params", "mu", "nu"):
        _close(got[part], want[part], f"{job} world {world} {part}")


@pytest.mark.parametrize("world", WORLDS)
def test_zero3_state_holds_a_chunk_of_each_sharded_leaf(_worlds, world):
    """Each rank's persistent params and moments hold 1/world of every
    sharded leaf (its own chunk), and replicated leaves whole."""
    for job in ("vit-z3", "chatglm3-z3", "rwkv6-z3", "deepseek-z3",
                "zamba2-z3"):
        full = {k: v.shape for k, v in _worlds[world][0][job]["params"]
                .items()}
        dims = shard_dims(full, zero_stage=3, world=world)
        assert any(d is not None for d in dims.values())
        for res in _worlds[world]:
            for part in ("params", "mu"):
                for k, shape in res[job]["shapes"][part].items():
                    want = list(full[k])
                    if dims[k] is not None:
                        want[dims[k]] //= world
                    assert list(shape) == want, (job, part, k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("job", MOE_JOBS)
def test_moe_dp_matches_one_process(_worlds, single, world, job):
    """Granite smoke (and DeepSeek smoke at ZeRO-3), fp32, 3 steps of
    global batch 8 x 32 (accum 2): every rank's losses, grad norms,
    gathered params and moments within 2e-4 of the one-process run, and
    the load-balance loss (``moe_aux``) within rtol 1e-5. Each rank holds 1 or 2 rows of a microbatch: its own routed
    fractions would give another aux, so this holds only with the global
    fractions (``Trainer.forward_reduce``). The gather dispatch runs at a
    capacity factor of 8, where a rank's local capacity drops nothing."""
    want = single[job]
    for rank, res in enumerate(_worlds[world]):
        got = res[job]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=TOL)
        np.testing.assert_allclose(got["gnorms"], want["gnorms"], atol=TOL)
        np.testing.assert_allclose(got["auxes"], want["auxes"],
                                   rtol=AUX_RTOL)
        assert all(a > 0 for a in got["auxes"])
        for part in ("params", "mu", "nu"):
            _close(got[part], want[part], f"{job} world {world} rank "
                   f"{rank} {part}")


@pytest.mark.parametrize("world", WORLDS)
def test_moe_zero_stages_agree(_worlds, world):
    """ZeRO 1, 2 and 3 against ZeRO 0 on the same world (granite smoke):
    losses, grad norms and params within 3e-4."""
    want = _worlds[world][0]["granite-z0"]
    for stage in (1, 2, 3):
        got = _worlds[world][0][f"granite-z{stage}"]
        for key in ("losses", "gnorms"):
            np.testing.assert_allclose(got[key], want[key], atol=STAGE_TOL)
        for k in want["params"]:
            np.testing.assert_allclose(got["params"][k], want["params"][k],
                                       atol=STAGE_TOL, rtol=0,
                                       err_msg=f"zero{stage} {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_zero3_gathers_a_moe_stack_leaf_whole(_worlds, world):
    """A ``moe_stack`` leaf's layer slice is gathered along its own sharded
    dimension (one less than the stacked leaf's): the whole slice."""
    for res in _worlds[world]:
        g = res["moe-gather"]
        assert "moe_stack.moe.experts.w_gate" in g["sharded"]
        assert "moe_stack.moe.experts.w_out" in g["sharded"]
        assert all(g["equal"].values()), g["equal"]


def test_moe_zero3_checkpoint_restores_on_one_device(_worlds, ckpt_root):
    """Granite smoke saved at world 2 under ZeRO-3 (``(L, E, d, f)``
    expert leaves in chunks) restores on one device bitwise; the saved
    keys are the reference pytree's paths (``params/moe_stack/moe/experts
    /w_gate``, ...)."""
    from repro import configs as ref_configs
    from repro.models import transformer as ref_model
    import jax
    saved = _worlds[2][0]["moe-ckpt"]
    root = ckpt_root / "granite-z3"
    trainer, _, _ = _setup(TRAIN_JOBS["granite-z3"], None)
    state = trainer.restore_state(str(root))
    assert state.step == saved["step"] == 2
    opt = trainer.full_opt_state(state)
    for part, tree in (("params", state.params), ("mu", opt.mu),
                       ("nu", opt.nu)):
        for k, v in tree.items():
            assert np.array_equal(v.numpy(), saved[part][k]), (part, k)
    manifest = json.loads((root / "step_00000002" / "manifest.json")
                          .read_text())
    cfg = ref_configs.get_smoke_config(GRANITE)
    shapes = jax.eval_shape(lambda: ref_model.init_params(
        cfg, jax.random.PRNGKey(0)))
    paths = {"params/" + k.replace(".", "/")
             for k in _flat_tree(shapes)}
    assert {k for k in manifest["leaves"] if k.startswith("params/")} == \
        paths
    assert "params/moe_stack/moe/experts/w_gate" in paths
    leaf = manifest["leaves"]["params/moe_stack/moe/experts/w_gate"]
    assert leaf["shape"] == [2, 4, 128, 64] and len(leaf["shards"]) == 2


def test_world2_zero3_matches_reference(_worlds, ref_init):
    """World-2 ZeRO-3 ViT against the reference's pure functions on the
    same global batches: ``accumulate_gradients`` over ``loss_fn`` with
    ``jax.value_and_grad``, the optimizer ``update`` and ``make_schedule``."""
    import jax
    import jax.numpy as jnp
    from repro.core import grad_accum as ref_grad_accum
    from repro.data import DATASETS as REF_DATASETS
    from repro.data import DataPipeline as RefPipeline
    from repro.models import transformer as ref_model
    from repro.optim import make_optimizer as ref_make_optimizer
    from repro.optim import make_schedule as ref_make_schedule
    cfg, params, _ = ref_init
    pipe = RefPipeline(kind="image", global_batch=BATCH,
                       dataset=REF_DATASETS["cifar10"], resolution=32)
    opt = ref_make_optimizer("adamw")
    sched = ref_make_schedule("cosine", 1e-3, 1, 10)
    opt_state = opt.init(params)
    grads_of = jax.jit(lambda p, b: ref_grad_accum.accumulate_gradients(
        lambda q, mb: ref_model.loss_fn(cfg, q, mb), p, b, ACCUM))
    update = jax.jit(opt.update)
    losses, gnorms = [], []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(0, i).items()}
        grads, metrics = grads_of(params, batch)
        params, opt_state, gnorm = update(grads, opt_state, params,
                                          sched(i))
        losses.append(float(metrics["loss"]))
        gnorms.append(float(gnorm))
    want = params_from_numpy({k: np.asarray(v) for k, v in
                              _flat_tree(params).items()})
    for res in _worlds[2]:
        got = res["reference"]
        np.testing.assert_allclose(got["losses"], losses, atol=TOL)
        np.testing.assert_allclose(got["gnorms"], gnorms, atol=TOL)
        _close(got["params"], {k: v.numpy() for k, v in want.items()},
               "reference params")


def _flat_tree(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat_tree(leaf, f"{prefix}{name}."))
        else:
            out[prefix + name] = leaf
    return out


def test_eval_counts_are_layout_invariant(_worlds):
    """Integer counts bitwise equal at world 1, 2 and 4 (a ZeRO-3 state,
    so the forward gathers) and on one device, on a ragged split padded
    to the batch; the NLL sum within fp32 rounding."""
    want = _eval_counts(None)
    assert want["eval_count"] == EVAL_SIZE
    for size, ranks in _worlds.items():
        for res in ranks:
            got = res["eval"]
            for k in ("eval_top1_count", "eval_top5_count", "eval_count"):
                assert got[k] == want[k], (size, k)
            np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                                       rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("zero", GUARD_STAGES)
def test_guard_agrees_across_ranks(_worlds, world, zero):
    """A NaN in one rank's rows: step_ok 0 on every rank and the state
    bitwise unchanged, then the next healthy step is taken."""
    for res in _worlds[world]:
        g = res[f"guard{zero}"]
        assert g["ok"] == [1, 0, 1]
        assert g["unchanged"] and g["step"] == 1 and g["opt_step"] == 1


@pytest.mark.parametrize("world", [2, 4])
def test_batch_invariant_raises_on_every_rank(_worlds, world):
    for res in _worlds[world]:
        ctor, step = res["invariant"]
        assert ctor is not None and "invariant" in ctor
        assert step is not None and "not divisible by world" in step


# --- the spawner and the CLI -----------------------------------------------

def _hang(world):
    if world.rank == 0:
        time.sleep(600)
    return world.rank


def _fail_on_last(world):
    if world.rank == world.size - 1:
        raise RuntimeError("boom on the last rank")
    world.all_reduce(torch.ones(1))         # would wait for the last rank
    return world.rank


def test_spawn_kills_a_world_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        distributed.spawn(_hang, 2, device="cpu", deadline_s=4)
    assert time.monotonic() - t0 < 60


def test_spawn_ends_the_world_when_a_rank_fails():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="boom on the last rank"):
        distributed.spawn(_fail_on_last, 2, device="cpu", deadline_s=60,
                          timeout_s=30)
    assert time.monotonic() - t0 < 30


def test_cli_devices_matches_one_device(tmp_path, capsys):
    """``--devices 2 --zero 2 --augment`` on gloo: rank 0's rows (losses,
    grad norms, eval counts) equal the one-device run's within 2e-4; the
    header names dp and zero."""
    base = ["--smoke", "--steps", "2", "--batch", "8", "--accum", "2",
            "--log-every", "1", "--dtype", "float32", "--augment",
            "--eval-every", "2", "--eval-size", "20", "--eval-batch", "4",
            "--device", "cpu"]
    want = cli.main(base)
    assert "dp=1" in capsys.readouterr().out
    out = tmp_path / "m.json"
    got = cli.main(base + ["--devices", "2", "--zero", "2",
                           "--metrics-out", str(out)])
    assert out.exists() and len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "eval_loss"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], atol=TOL)
        for k in ("eval_top1_count", "eval_count", "step_ok"):
            assert g.get(k) == w.get(k)


def test_cli_refuses_a_world_it_cannot_build():
    with pytest.raises(SystemExit, match="--zero needs a data-parallel"):
        cli.main(["--smoke", "--steps", "1", "--zero", "3", "--device",
                  "cpu"])
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("this host has two GPUs")
    with pytest.raises(RuntimeError, match=re.escape("GPU")):
        cli.main(["--smoke", "--steps", "1", "--devices", "2"])


@pytest.mark.parametrize("zero", HYBRID_GRAD_STAGES)
@pytest.mark.parametrize("world", WORLDS)
def test_hybrid_shared_block_gradient_matches_one_process(_worlds, world,
                                                          zero):
    """Zamba2's shared attention block (one unstacked leaf set, used after
    every group, its gradient summed over the uses) and every other
    gradient of one batch at worlds 1, 2 and 4 under ZeRO 0 and 3 against
    the single-device ``Trainer``'s: within 2e-4, on every rank."""
    want = _hybrid_grads(None, 0)
    shared = [k for k in want["grads"] if k.startswith("shared_attn.")]
    assert shared and all(np.abs(want["grads"][k]).max() > 0
                          for k in shared)
    for rank, res in enumerate(_worlds[world]):
        got = res[f"hybrid-grads{zero}"]
        assert abs(got["loss"] - want["loss"]) <= TOL
        _close(got["grads"], want["grads"], f"world {world} zero {zero} "
               f"rank {rank}")
