"""Port parity for pipeline parallelism (``repro_torch.core.pipeline``):
the 1F1B schedule, flat and interleaved, task for task against the
reference's simulator; the one-process staged executor against the
reference's ``pipelined_value_and_grad(pipe_axis=None)`` and ``loss_fn``
on the same params and batch; the executed schedule's accounting and its
in-flight residuals; the augmented ViT's pipelined gradients against the
data-parallel path on the same seeds; the refusals; the CLI; and gloo
worlds whose pipe groups hand activations and cotangents over real
send/recv, at ZeRO 0 and 3, with checkpoints that resume across pp
layouts.

The reference oracles are computed once per module (``jax.jit`` of the
reference's executor at smoke size). The spawned ranks import this module
(the spawn start method pickles ``_run_jobs`` by reference), so it imports
no JAX at module level. Tolerances: the reference's own for the executor
(``tests/test_pipeline.py:206-258``: loss 2e-5, fp32 grads 1e-4), its
pp-vs-dp bound 3e-4 for the pipe worlds against one process
(``tests/test_pipeline.py:357``), and the resume parity 1e-5 of
``tests/test_torch_checkpoint.py``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import concurrent.futures  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import EngineConfig  # noqa: E402
from repro_torch.core import distributed, pipeline  # noqa: E402
from repro_torch.core.engine import Evaluator, Trainer, \
    to_device  # noqa: E402
from repro_torch.core.sharding import shard_dims, stage_chunks  # noqa: E402
from repro_torch.data.augment import AugmentConfig  # noqa: E402
from repro_torch.data.datasets import CIFARSource  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.launch.mesh import make_layout  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

LOSS_TOL, GRAD_TOL = 2e-5, 1e-4
PP_TOL = 3e-4
RESUME_TOL = 1e-5
FLAT = [(2, 2), (4, 2), (4, 4), (8, 4), (6, 3)]
INTERLEAVED = [(4, 2, 2), (8, 2, 3), (8, 4, 2)]
# (arch, layers (0: the smoke config's), stages, interleave); microbatch 4
EXEC_CASES = [("vit-b16", 0, 2, 1), ("qwen2.5-14b", 0, 2, 1),
              ("vit-b16", 4, 2, 2)]
STEPS, BATCH, ACCUM = 3, 16, 4
DEADLINE_S = 240


def _tasks(sched):
    return [[None if t is None else (t.kind, t.micro, t.chunk) for t in row]
            for row in sched]


# --- the schedule ------------------------------------------------------------

@pytest.mark.parametrize("micro,stages,v", [(m, s, 1) for m, s in FLAT]
                         + INTERLEAVED)
def test_schedule_equals_reference(micro, stages, v):
    """Task for task and tick for tick, with the same accounting."""
    from repro.core import pipeline as ref
    assert _tasks(pipeline.one_f_one_b(micro, stages, v)) == \
        _tasks(ref.one_f_one_b(micro, stages, v))
    assert pipeline.schedule_accounting(micro, stages, v) == \
        ref.schedule_accounting(micro, stages, v)
    assert pipeline.simulated_bubble_fraction(micro, stages, v) == \
        ref.simulated_bubble_fraction(micro, stages, v)
    assert pipeline.bubble_fraction(micro, stages) == \
        ref.bubble_fraction(micro, stages)
    sched = pipeline.one_f_one_b(micro, stages, v)
    assert [pipeline.bubble_count(sched, d) for d in range(stages)] == \
        [ref.bubble_count(ref.one_f_one_b(micro, stages, v), d)
         for d in range(stages)]


@pytest.mark.parametrize("layers,stages", [(12, 4), (2, 1), (12, 5),
                                           (12, 0), (48, 6)])
def test_stage_partition_equals_reference(layers, stages):
    from repro.core import pipeline as ref
    try:
        want = ref.stage_partition(layers, stages)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            pipeline.stage_partition(layers, stages)
        return
    assert pipeline.stage_partition(layers, stages) == want


@pytest.mark.parametrize("args", [(2, 4), (6, 4, 2), (4, 2, 0), (3, 2, 2)])
def test_schedule_refusals_equal_reference(args):
    """The same bad inputs raise the same ``ValueError``."""
    from repro.core import pipeline as ref
    with pytest.raises(ValueError) as want:
        ref.one_f_one_b(*args)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        pipeline.one_f_one_b(*args)


def test_stage_chunks_place_chunks_round_robin():
    """Chunk c of S * v on stage c % S, in chunk order; together the
    stages hold every layer once."""
    assert stage_chunks(8, 2, 2, 0) == [(0, 2), (4, 6)]
    assert stage_chunks(8, 2, 2, 1) == [(2, 4), (6, 8)]
    assert stage_chunks(12, 4, 1, 3) == [(9, 12)]
    held = sorted(r for p in range(3) for r in stage_chunks(12, 3, 2, p))
    assert held == pipeline.stage_partition(12, 6)
    with pytest.raises(ValueError, match="not divisible"):
        stage_chunks(12, 5, 1, 0)


# --- refusals ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ["vit-b16", "qwen2.5-14b", "gemma3-12b",
                                  "chatglm3-6b", "glm4-9b", "hubert-xlarge",
                                  "granite-moe-3b-a800m", "rwkv6-7b",
                                  "qwen2-vl-72b", "deepseek-v3-671b",
                                  "zamba2-2.7b"])
def test_check_supported_equals_reference(arch):
    """What the reference's ``check_supported`` refuses (RWKV6 and Mamba2
    stacks, MoE, vlm/M-RoPE) the port refuses with the same message."""
    from repro import configs as ref_configs
    from repro.core import pipeline as ref
    try:
        ref.check_supported(ref_configs.get_smoke_config(arch))
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            pipeline.check_supported(configs.get_smoke_config(arch))
        return
    pipeline.check_supported(configs.get_smoke_config(arch))


def test_mtp_head_is_refused():
    """A multi-token prediction head is refused (the reference's MTP
    branch: DeepSeek-V3 without its experts)."""
    cfg = configs.get_smoke_config("deepseek-v3-671b").replace(moe=None)
    assert cfg.mtp_depth > 0
    with pytest.raises(ValueError, match="MTP"):
        pipeline.check_supported(cfg)


@pytest.mark.parametrize("kw,dp,match", [
    ({"train_batch_size": 16, "gradient_accumulation_steps": 2,
      "pipeline_stages": 4}, 2, "microbatch count >= pipeline"),
    ({"train_batch_size": 16, "gradient_accumulation_steps": 4,
      "pipeline_stages": 2, "pipeline_interleave": 0}, 2,
     "pipeline_interleave must be"),
    ({"train_batch_size": 16, "gradient_accumulation_steps": 4,
      "pipeline_interleave": 2}, 4, "requires pipeline_stages"),
    ({"train_batch_size": 12, "gradient_accumulation_steps": 3,
      "pipeline_stages": 2, "pipeline_interleave": 2}, 2, "divisible by"),
    ({"train_batch_size": 16, "gradient_accumulation_steps": 4,
      "pipeline_stages": 4}, 2, None),
    ({"train_batch_size": 16, "gradient_accumulation_steps": 4,
      "pipeline_stages": 2, "pipeline_interleave": 2,
      "cast_params_bf16": True}, 2, None),
])
def test_engine_config_validation_equals_reference(kw, dp, match):
    """``EngineConfig.validate``'s pipeline rules, message for message
    (``tests/test_pipeline.py:147-198``)."""
    from repro.configs import EngineConfig as RefEngineConfig
    if match is None:
        RefEngineConfig(**kw).validate(dp)
        EngineConfig(**kw).validate(dp)
        return
    with pytest.raises(ValueError, match=match) as want:
        RefEngineConfig(**kw).validate(dp)
    with pytest.raises(ValueError, match=match) as got:
        EngineConfig(**kw).validate(dp)
    assert str(got.value) == str(want.value)


def test_layout_refusals():
    """The model axis cites item 16; a world the stages do not divide
    raises before any group is made."""
    world = distributed.World(rank=0, size=3, local_rank=0,
                              device=torch.device("cpu"))
    with pytest.raises(ValueError, match="item 16"):
        make_layout(world, 1, model=2)
    with pytest.raises(ValueError, match="not a multiple of 2"):
        make_layout(world, 2)
    one = distributed.World(rank=0, size=1, local_rank=0,
                            device=torch.device("cpu"))
    layout = make_layout(one, 4)
    assert layout.data is one and layout.pipe is None


def test_trainer_checks_layers_against_chunks():
    cfg = configs.get_smoke_config("vit-b16")        # 2 layers
    with pytest.raises(ValueError, match="not divisible"):
        Trainer(cfg, EngineConfig(train_batch_size=8,
                                  gradient_accumulation_steps=4,
                                  pipeline_stages=2, pipeline_interleave=2),
                device="cpu")


@pytest.mark.parametrize("arch", ["rwkv6-7b", "granite-moe-3b-a800m",
                                  "deepseek-v3-671b", "zamba2-2.7b",
                                  "qwen2-vl-72b"])
def test_cli_refuses_pp_where_the_reference_does(arch):
    with pytest.raises(ValueError, match="pipeline_stages > 1 unsupported"):
        cli.main(["--arch", arch, "--smoke", "--steps", "1", "--seq", "32",
                  "--batch", "4", "--accum", "2", "--pp", "2", "--device",
                  "cpu"])


def test_stage_local_specs_match_reference():
    """The reference's ``param_specs(pipeline_axis="pipe")`` on a data 2 x
    pipe 2 mesh: ``pipe`` leads exactly the stacked leaves, and ``data``
    sits where the port's ZeRO-3 table puts it on a data group of 2."""
    import jax
    from jax.sharding import PartitionSpec
    from repro import configs as ref_configs
    from repro.core.sharding import param_specs
    from repro.models import transformer as ref_model
    ref_cfg = ref_configs.get_config("vit-b16")
    shapes = jax.eval_shape(lambda: ref_model.init_params(
        ref_cfg, jax.random.PRNGKey(0)))
    mesh = types.SimpleNamespace(axis_names=("data", "pipe", "model"),
                                 devices=np.empty((2, 2, 1)))

    def flat(tree, prefix=""):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, PartitionSpec):
                out[prefix + name] = leaf
            else:
                out.update(flat(leaf, f"{prefix}{name}."))
        return out
    specs = flat(param_specs(shapes, zero_stage=3, tensor_parallel=False,
                             mesh=mesh, pipeline_axis="pipe"))
    port = {k: tuple(p.shape) for k, p in transformer.init_params(
        configs.get_config("vit-b16"), device="meta").items()}
    dims = shard_dims(port, zero_stage=3, world=2)
    for k, spec in specs.items():
        spec = list(spec) + [None] * (len(port[k]) - len(spec))
        assert (spec[0] == "pipe") == k.startswith("stack."), k
        assert (spec.index("data") if "data" in spec else None) == \
            dims[k], k


# --- the one-process executor against the reference ------------------------

def _flat(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat(leaf, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def oracle():
    """{case: (numpy params, numpy batch, reference loss_fn loss, the
    reference executor's loss and metrics keys, its grads, and its
    ``pipelined_loss``)}, fp32 smoke configs, batch 8 in 4 microbatches."""
    import jax
    from repro import configs as ref_configs
    from repro.core import pipeline as ref
    from repro.launch.specs import concrete_batch
    from repro.models import transformer as ref_model
    out = {}
    for arch, layers, stages, v in EXEC_CASES:
        cfg = ref_configs.get_smoke_config(arch).replace(dtype="float32")
        if layers:
            cfg = cfg.replace(num_layers=layers)
        params = jax.jit(lambda k: ref_model.init_params(cfg, k))(
            jax.random.PRNGKey(0))
        batch = concrete_batch(cfg, 8, 32, seed=0)
        ref_loss, _ = jax.jit(lambda p, b: ref_model.loss_fn(cfg, p, b))(
            params, batch)
        (loss, metrics), grads = jax.jit(
            lambda p, b: ref.pipelined_value_and_grad(
                cfg, p, b, stages=stages, num_micro=4, interleave=v,
                pipe_axis=None))(params, batch)
        fwd, _ = jax.jit(lambda p, b: ref.pipelined_loss(
            cfg, p, b, stages=stages, num_micro=4, interleave=v,
            pipe_axis=None))(params, batch)
        out[(arch, layers, stages, v)] = (
            _flat(params), {k: np.array(x) for k, x in batch.items()},
            float(ref_loss), float(loss), set(metrics), _flat(grads),
            float(fwd), {k: str(x.dtype) for k, x in _flat(grads).items()})
    return out


def _port_case(arch, layers):
    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    return cfg.replace(num_layers=layers) if layers else cfg


@pytest.mark.parametrize("case", EXEC_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_executor_matches_reference(case, oracle):
    """Loss within 2e-5 of the reference executor's and of its
    ``loss_fn``; every gradient fp32 and within 1e-4 of the reference
    executor's; the forward-only loss equal to the reference's."""
    arch, layers, stages, v = case
    params, batch, ref_loss, loss_ref, keys, grads_ref, fwd_ref, dtypes = \
        oracle[case]
    assert set(dtypes.values()) == {"float32"}
    cfg = _port_case(arch, layers)
    p = params_from_numpy(params)
    b = to_device(batch, "cpu")
    (loss, metrics), grads = pipeline.pipelined_value_and_grad(
        cfg, p, b, stages=stages, num_micro=4, interleave=v)
    assert abs(float(loss) - loss_ref) <= LOSS_TOL
    assert abs(float(loss) - ref_loss) <= LOSS_TOL
    assert set(metrics) == keys
    assert set(grads) == set(grads_ref)
    for k, g in grads.items():
        assert g.dtype == torch.float32, k
        err = np.max(np.abs(g.numpy() - grads_ref[k]))
        assert err <= GRAD_TOL, (k, err)
    fwd, fwd_metrics = pipeline.pipelined_loss(
        cfg, p, b, stages=stages, num_micro=4, interleave=v)
    assert abs(float(fwd) - fwd_ref) <= LOSS_TOL
    assert set(fwd_metrics) == keys


def test_executor_leaves_the_params_alone(oracle):
    """The executor reads the params and writes no gradient into them."""
    case = EXEC_CASES[0]
    p = params_from_numpy(oracle[case][0])
    before = {k: t.clone() for k, t in p.items()}
    pipeline.pipelined_value_and_grad(
        _port_case(*case[:2]), p, to_device(oracle[case][1], "cpu"),
        stages=2, num_micro=4)
    assert all(torch.equal(before[k], t) and t.grad is None
               for k, t in p.items())


@pytest.mark.parametrize("stages,v,micro", [(2, 1, 4), (2, 2, 4), (4, 1, 4),
                                            (2, 1, 8), (2, 2, 8)])
def test_executed_schedule_matches_accounting(stages, v, micro):
    """The executed F/B/idle counts and makespan equal the simulator's,
    and the live residuals per stage stay within the 1F1B caps: S - d
    flat, the warmup depth + 1 interleaved, flat in M."""
    cfg = _port_case("vit-b16", 4)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"images": torch.randn(micro * 2, 32, 32, 3, generator=g),
             "labels": torch.randint(0, cfg.num_classes, (micro * 2,),
                                     generator=g)}
    out = {}
    pipeline.pipelined_value_and_grad(cfg, params, batch, stages=stages,
                                      num_micro=micro, interleave=v,
                                      schedule_out=out)
    ref = pipeline.schedule_accounting(micro, stages, v)
    assert out["ticks"] == ref["ticks"]
    assert out["executed"] == {"F": ref["F"], "B": ref["B"],
                               "idle": ref["idle"]}
    caps = [stages - d if v == 1 else
            min(2 * (stages - d - 1) + (v - 1) * stages, v * micro) + 1
            for d in range(stages)]
    assert all(0 < n <= cap for n, cap in zip(out["in_flight"], caps)), \
        (out["in_flight"], caps)


def test_rngs_reach_each_microbatch():
    """Microbatch m is finished with ITS seed wherever it is materialised:
    a ``microbatch_fn`` that scales the images by a draw of the seed gives
    the loss of the same transformation applied microbatch by microbatch
    outside the pipe (the reference's ``tests/test_pipeline.py:283``)."""
    from repro_torch.core.grad_accum import split_microbatches
    cfg = _port_case("vit-b16", 2)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"images": torch.randn(8, 32, 32, 3, generator=g),
             "labels": torch.randint(0, cfg.num_classes, (8,), generator=g)}
    rngs = [11, 12, 13, 14]

    def mb_fn(mb, r):
        scale = torch.rand((), generator=torch.Generator().manual_seed(r))
        return dict(mb, images=mb["images"] * scale)
    loss, _ = pipeline.pipelined_loss(cfg, params, batch, stages=2,
                                      num_micro=4, rngs=rngs,
                                      microbatch_fn=mb_fn)
    (loss2, _), _ = pipeline.pipelined_value_and_grad(
        cfg, params, batch, stages=2, num_micro=4, rngs=rngs,
        microbatch_fn=mb_fn)
    want = np.mean([float(transformer.loss_fn(cfg, params, mb_fn(mb, r))[0])
                    for mb, r in zip(split_microbatches(batch, 4), rngs)])
    assert abs(float(loss) - want) <= LOSS_TOL
    assert abs(float(loss2) - want) <= LOSS_TOL
    with pytest.raises(ValueError, match="microbatches >= stages"):
        pipeline.pipelined_loss(cfg, params, batch, stages=2, num_micro=1)


def test_metric_names_are_the_loss_keys():
    for arch in ("vit-b16", "qwen2.5-14b", "hubert-xlarge"):
        cfg = configs.get_smoke_config(arch)
        logits = torch.zeros(2, 4, cfg.vocab_size) if arch != "vit-b16" \
            else torch.zeros(2, cfg.num_classes)
        batch = {"labels": torch.zeros(2, dtype=torch.long)} \
            if arch == "vit-b16" else {
                "tokens": torch.zeros(2, 4, dtype=torch.long),
                "labels": torch.zeros(2, 4, dtype=torch.long),
                "mask": torch.ones(2, 4, dtype=torch.bool)}
        _, metrics = transformer.loss_from_logits(cfg, logits, batch)
        assert set(metrics) == set(transformer.metric_names(cfg))


# --- the trainer: pp against the data-parallel path ------------------------

def _trainer(arch, layers, pp, v=1, *, zero=0, opt="adamw", aug=False,
             world=None):
    """(trainer, data pipeline, fresh params of seed 0) at batch 16 in 4
    microbatches: procedural CIFAR-10 for the ViT, the token stream of 128
    tokens for a decoder."""
    cfg = _port_case(arch, layers)
    ecfg = EngineConfig(train_batch_size=BATCH,
                        gradient_accumulation_steps=ACCUM, zero_stage=zero,
                        optimizer=opt, lr=1e-3, total_steps=10,
                        warmup_steps=1, pipeline_stages=pp,
                        pipeline_interleave=v)
    if cfg.arch_type == "vit":
        source = CIFARSource("cifar10", resolution=32, eval_size=8)
        pipe = DataPipeline(global_batch=BATCH, source=source)
        preproc = source.preproc
    else:
        pipe = DataPipeline(kind="token", global_batch=BATCH,
                            vocab=cfg.vocab_size, seq_len=128,
                            epoch_size=BATCH * STEPS)
        preproc = None
    trainer = Trainer(cfg, ecfg, preproc=preproc, device="cpu",
                      aug=AugmentConfig(num_classes=cfg.num_classes)
                      if aug else None, world=world)
    return trainer, pipe, transformer.init_params(cfg, seed=0, device="cpu")


def test_augmented_pp_equals_the_dp_path():
    """The augmented ViT's pipelined gradients on the step's seeds equal
    the data-parallel path's (same crops, flips and Mixup/CutMix draws),
    flat and interleaved."""
    out = {}
    for pp, v in ((1, 1), (2, 1), (2, 2)):
        trainer, pipe, params = _trainer("vit-b16", 4, pp, v, aug=True)
        state = trainer.init_state(params)
        batch = to_device(pipe.batch_at(0, 0), "cpu")
        out[(pp, v)] = trainer.grads(state.params, batch,
                                     trainer._step_rngs(state))
    grads, metrics = out[(1, 1)]
    for key in ((2, 1), (2, 2)):
        g, m = out[key]
        assert abs(float(m["loss"]) - float(metrics["loss"])) <= LOSS_TOL
        for k in grads:
            err = float((g[k] - grads[k]).abs().max())
            assert err <= GRAD_TOL, (key, k, err)


@pytest.mark.parametrize("arch", ["gemma3-12b", "hubert-xlarge",
                                  "chatglm3-6b", "glm4-9b"])
def test_pp_grads_equal_the_dp_path(arch):
    """A decoder's and the audio encoder's pipelined gradients equal the
    data-parallel path's: Gemma3's tied embedding takes its gradient at
    both ends of the pipe, and its windows ride with their layers;
    HuBERT's loss is over each microbatch's masked frames; ChatGLM3 and
    GLM-4 take RMSNorm (K4/K5's plain path here), GQA and rope."""
    from repro_torch.launch.specs import concrete_batch
    cfg = _port_case(arch, 4)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    batch = to_device(concrete_batch(cfg, 8, 128, seed=3), "cpu")
    out = {}
    for pp in (1, 2):
        trainer = Trainer(cfg, EngineConfig(
            train_batch_size=8, gradient_accumulation_steps=4,
            pipeline_stages=pp, pipeline_interleave=pp), device="cpu")
        out[pp] = trainer.grads(params, batch)
    (g1, m1), (g2, m2) = out[1], out[2]
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= LOSS_TOL
    assert set(g1) == set(g2)
    for k in g1:
        err = float((g2[k] - g1[k]).abs().max())
        assert err <= GRAD_TOL, (k, err)
    if cfg.tie_embeddings:
        assert float(g2["embed.tok"].abs().max()) > 0


def test_cli_trains_with_pp(capsys):
    rows = cli.main(["--smoke", "--steps", "3", "--batch", "16", "--accum",
                     "4", "--pp", "2", "--device", "cpu", "--log-every",
                     "1"])
    ref = cli.main(["--smoke", "--steps", "3", "--batch", "16", "--accum",
                    "4", "--device", "cpu", "--log-every", "1"])
    printed = capsys.readouterr().out
    assert "dp=1 pp=2 micro_batch=4 accum=4" in printed
    for r, w in zip(rows, ref):
        assert r["step_ok"] == 1 and np.isfinite(r["loss"])
        assert abs(r["loss"] - w["loss"]) <= PP_TOL
        assert abs(r["grad_norm"] - w["grad_norm"]) <= PP_TOL


def test_cli_trains_a_pipe_world(capfd):
    """``--devices 2 --pp 2 --pp-interleave 2`` on gloo: one replica of a
    two-stage pipe, two chunks a stage; rank 0's rows within 3e-4 of the
    one-process ``--pp 1`` run's."""
    base = ["--smoke", "--layers", "4", "--steps", "2", "--batch", "16",
            "--accum", "4", "--device", "cpu", "--log-every", "1"]
    rows = cli.main(base + ["--pp", "2", "--pp-interleave", "2",
                            "--devices", "2"])
    ref = cli.main(base)
    # the spawned ranks print to the fd
    assert "dp=1 pp=2 interleave=2 micro_batch=4" in capfd.readouterr().out
    assert [r["step"] for r in rows] == [0, 1]
    for r, w in zip(rows, ref):
        assert r["step_ok"] == 1
        assert abs(r["loss"] - w["loss"]) <= PP_TOL
        assert abs(r["grad_norm"] - w["grad_norm"]) <= PP_TOL


def test_cast_params_bf16_keeps_fp32_grads_under_pp():
    """bf16 compute params through the pipeline: every gradient comes
    back fp32 (the accumulator's policy) and equals the data-parallel
    path's on the same bf16 view within its rounding."""
    cfg = _port_case("vit-b16", 4)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(2)
    batch = {"images": torch.randn(8, 32, 32, 3, generator=g),
             "labels": torch.randint(0, cfg.num_classes, (8,), generator=g)}
    out = {}
    for pp in (1, 2):
        trainer = Trainer(cfg, EngineConfig(
            train_batch_size=8, gradient_accumulation_steps=4,
            pipeline_stages=pp, cast_params_bf16=True), device="cpu")
        out[pp] = trainer.grads(params, batch)
    for k, grad in out[2][0].items():
        assert grad.dtype == torch.float32, k
        err = float((grad - out[1][0][k]).abs().max())
        assert err <= 1e-3 * max(1.0, float(out[1][0][k].abs().max())), k


# --- gloo pipe worlds ----------------------------------------------------------

# name -> (world, arch, layers, stages, interleave, zero, optimizer, aug)
WORLD_JOBS = {
    "pp2": (2, "vit-b16", 4, 2, 1, 0, "adamw", False),
    "pp2-v2": (2, "vit-b16", 4, 2, 2, 0, "adamw", False),
    "gemma3-pp2": (2, "gemma3-12b", 2, 2, 1, 0, "adamw", False),
    "dp2-pp2-z0": (4, "vit-b16", 4, 2, 1, 0, "adamw", False),
    "dp2-pp2-z1": (4, "vit-b16", 4, 2, 1, 1, "adamw", False),
    "dp2-pp2-z2": (4, "vit-b16", 4, 2, 1, 2, "adamw", False),
    "dp2-pp2-z3": (4, "vit-b16", 4, 2, 1, 3, "adamw", False),
    "dp2-pp2-v2-z3-lamb": (4, "vit-b16", 4, 2, 2, 3, "lamb", False),
    "dp2-pp2-z0-aug": (4, "vit-b16", 4, 2, 1, 0, "adamw", True),
}
# the checkpoints saved after step 2, resumed at --pp 1 in one process
SAVED = ("pp2", "pp2-v2", "dp2-pp2-z3")
EVAL_SIZE, EVAL_BATCH = 40, 8


def _train(trainer, pipe, params, steps=STEPS, state=None, start=0,
           save=None):
    state = trainer.init_state(params) if state is None else state
    losses, gnorms = [], []
    for i in range(start, steps):
        if i == 2 and save is not None:
            trainer.save_state(save, state)
        state, m = trainer.train_step(state, to_device(pipe.batch_at(0, i),
                                                       "cpu"))
        assert m["step_ok"] == 1
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return state, losses, gnorms


def _eval(trainer, state, world=None):
    """Eval counts of ``state`` on a ragged, padded split."""
    source = CIFARSource("cifar10", resolution=32, eval_size=EVAL_SIZE)
    ev = Evaluator(trainer.cfg, Transformer(trainer.cfg, state.params),
                   ecfg=trainer.ecfg, preproc=source.preproc, device="cpu",
                   trainer=trainer)
    return ev.evaluate(source.eval_batches(EVAL_BATCH))


def _world_job(world, name, root):
    _, arch, layers, pp, v, zero, opt, aug = WORLD_JOBS[name]
    trainer, pipe, params = _trainer(arch, layers, pp, v, zero=zero,
                                     opt=opt, aug=aug, world=world)
    state, losses, gnorms = _train(
        trainer, pipe, params,
        save=os.path.join(root, name) if name in SAVED else None)
    whole = {k: t.numpy().copy()
             for k, t in trainer.full_params(state).items()}
    return {"losses": losses, "gnorms": gnorms, "params": whole,
            "in_flight": trainer.schedule_out["in_flight"],
            "eval": _eval(trainer, state) if arch == "vit-b16" else None}


def _resume_job(world, root):
    """A --pp 1 save after step 2 restored into data 2 x pipe 2 at ZeRO 3
    (each rank reads its blocks), then step 2."""
    trainer, pipe, _ = _trainer("vit-b16", 4, 2, zero=3, world=world)
    state = trainer.restore_state(os.path.join(root, "pp1"))
    _, losses, gnorms = _train(trainer, pipe, None, state=state, start=2)
    return {"step": state.step, "losses": losses, "gnorms": gnorms}


def _never_sent(world):
    """Rank 0 runs the pipelined step over a pipe group whose other rank
    never joins it: its first receive raises at the group's timeout."""
    layout = make_layout(world, 2, timeout_s=3)
    if world.rank == 1:
        time.sleep(8)
        return None
    cfg = _port_case("vit-b16", 2)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    params = {k: t[0:1] if k.startswith("stack.") else t
              for k, t in params.items()}
    batch = {"images": torch.zeros(8, 32, 32, 3),
             "labels": torch.zeros(8, dtype=torch.long)}
    t0 = time.monotonic()
    try:
        pipeline.pipelined_value_and_grad(cfg, params, batch, stages=2,
                                          num_micro=4, pipe=layout.pipe)
    except RuntimeError as e:
        return {"raised": str(e)[:300], "after_s": time.monotonic() - t0}
    return {"raised": None}


def _run_jobs(world, jobs, root):
    if jobs == ["never-sent"]:
        return _never_sent(world)
    out = {name: _world_job(world, name, root) for name in jobs
           if name in WORLD_JOBS}
    if "resume" in jobs:
        out["resume"] = _resume_job(world, root)
    return out


def _key(spec):
    """The one-process run a world job is held against: pp 1 with the
    same model, optimizer and augmentation."""
    _, arch, layers, _, _, _, opt, aug = spec
    return arch, layers, opt, aug


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """{_key: the one-process --pp 1 run's losses, grad norms, whole
    params and (ViT) eval counts}; the ViT's run saves a checkpoint after
    step 2 under ``root/pp1``. Returns (runs, root)."""
    root = tmp_path_factory.mktemp("pp-ckpt")
    out = {}
    for spec in WORLD_JOBS.values():
        key = _key(spec)
        if key in out:
            continue
        arch, layers, opt, aug = key
        trainer, pipe, params = _trainer(arch, layers, 1, opt=opt, aug=aug)
        first = key == ("vit-b16", 4, "adamw", False)
        state, losses, gnorms = _train(
            trainer, pipe, params,
            save=os.path.join(root, "pp1") if first else None)
        out[key] = {"losses": losses, "gnorms": gnorms,
                    "params": {k: t.detach().numpy().copy()
                               for k, t in state.params.items()},
                    "eval": _eval(trainer, state)
                    if arch == "vit-b16" else None}
    return out, root


@pytest.fixture(scope="module")
def worlds(one_process):
    """{world size or "never-sent": [each rank's results]}, the worlds
    side by side (world 4 also resumes the one-process save)."""
    root = str(one_process[1])
    plan = {2: [j for j, spec in WORLD_JOBS.items() if spec[0] == 2],
            4: [j for j, spec in WORLD_JOBS.items() if spec[0] == 4]
            + ["resume"],
            "never-sent": ["never-sent"]}
    with concurrent.futures.ThreadPoolExecutor(len(plan)) as pool:
        runs = {key: pool.submit(
            distributed.spawn, _run_jobs, 2 if key == "never-sent" else key,
            jobs, root, device="cpu", deadline_s=DEADLINE_S, timeout_s=60)
            for key, jobs in plan.items()}
        return {key: run.result() for key, run in runs.items()}


@pytest.mark.parametrize("name", list(WORLD_JOBS))
def test_pipe_world_matches_one_process(name, worlds, one_process):
    """Losses and grad norms within 3e-4 of one process's, every rank
    agreeing on them; the whole params (gathered over the data and pipe
    groups) the same on every rank and within 2e-4 of one process's; the
    eval counts equal; each rank's residuals its own stage's."""
    spec = WORLD_JOBS[name]
    size, pp = spec[0], spec[3]
    ranks = [r[name] for r in worlds[size]]
    want = one_process[0][_key(spec)]
    for r in ranks:
        assert np.max(np.abs(np.subtract(r["losses"],
                                         want["losses"]))) <= PP_TOL
        assert np.max(np.abs(np.subtract(r["gnorms"],
                                         want["gnorms"]))) <= PP_TOL
        assert r["losses"] == ranks[0]["losses"]
        assert r["eval"] == ranks[0]["eval"]
        for k, t in r["params"].items():
            assert np.array_equal(t, ranks[0]["params"][k]), k
            np.testing.assert_allclose(t, want["params"][k], atol=2e-4,
                                       rtol=0, err_msg=k)
    if want["eval"] is not None:
        keys = ("eval_top1_count", "eval_top5_count", "eval_count")
        assert [ranks[0]["eval"][k] for k in keys] == \
            [want["eval"][k] for k in keys]
        assert ranks[0]["eval"]["eval_count"] == EVAL_SIZE
    for rank, r in enumerate(ranks):
        stage = rank % pp
        assert [n is not None for n in r["in_flight"]] == \
            [d == stage for d in range(pp)]


@pytest.mark.parametrize("name", SAVED)
def test_pipe_world_checkpoint_resumes_at_pp1(name, worlds, one_process):
    """A pipe world's save after step 2 (stage-local blocks: one per chunk
    interleaved, split over the data group at ZeRO 3), then step 2 at
    --pp 1 in one process: within 1e-5 of the uninterrupted --pp 1 run."""
    runs, root = one_process
    assert name in worlds[WORLD_JOBS[name][0]][0]
    want = runs[_key(WORLD_JOBS[name])]
    trainer, pipe, _ = _trainer("vit-b16", 4, 1)
    state = trainer.restore_state(os.path.join(root, name))
    assert state.step == 2
    _, tail, tail_g = _train(trainer, pipe, None, state=state, start=2)
    assert abs(tail[0] - want["losses"][2]) <= RESUME_TOL
    assert abs(tail_g[0] - want["gnorms"][2]) <= RESUME_TOL


def test_pipe_world_resumes_a_pp1_save(worlds, one_process):
    """A one-process --pp 1 save restored into data 2 x pipe 2 at ZeRO 3:
    step 2 within 1e-5 of the uninterrupted run on every rank."""
    want = one_process[0][("vit-b16", 4, "adamw", False)]
    for r in worlds[4]:
        got = r["resume"]
        assert got["step"] == 2
        assert abs(got["losses"][0] - want["losses"][2]) <= RESUME_TOL
        assert abs(got["gnorms"][0] - want["gnorms"][2]) <= RESUME_TOL


def test_one_process_pp2_resumes_a_pp1_save(one_process):
    runs, root = one_process
    want = runs[("vit-b16", 4, "adamw", False)]
    for v in (1, 2):
        trainer, pipe, _ = _trainer("vit-b16", 4, 2, v)
        state = trainer.restore_state(os.path.join(root, "pp1"))
        _, tail, tail_g = _train(trainer, pipe, None, state=state, start=2)
        assert abs(tail[0] - want["losses"][2]) <= RESUME_TOL
        assert abs(tail_g[0] - want["gnorms"][2]) <= RESUME_TOL


def test_a_receive_that_never_arrives_raises(worlds):
    got = worlds["never-sent"][0]
    assert got["raised"] is not None
    assert "Timed out" in got["raised"] or "timeout" in got["raised"].lower()
    assert got["after_s"] < 30
