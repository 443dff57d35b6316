"""Port parity for tensor parallelism's pieces (``--model-axis``): the
data x pipe x model rank layout of ``launch/mesh.py`` on gloo worlds of 1,
2, 4 and 8; each leaf's model-axis dimension (``core/sharding.py::
model_dims``) against the reference's ``param_specs(...,
tensor_parallel=True)`` at full size, with the D6 leaves named; the
vocab-parallel cross-entropy (``models/shardctx.py``) and its gradient
against the reference's ``_xent`` on the same logits split M ways; the
refusals; and the CLI's model axis against one rank. With a pipe axis
too, each leaf's pipe and model dimensions against the reference's
``param_specs(pipeline_axis="pipe", tensor_parallel=True)``.

The spawned ranks import this module (the spawn start method pickles
``_run_jobs`` by reference), so it imports no JAX at module level.
Tolerances: 1e-5 for the cross-entropy, 3e-4 for the CLI's losses
against one rank (the reference's tensor-parallel bound,
``tests/test_engine_distributed.py:92-101``).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import concurrent.futures  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import EngineConfig  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.engine import Trainer  # noqa: E402
from repro_torch.core.sharding import check_model_axis, is_stacked, \
    model_dims, model_summed, shard_dims, whole_blocks  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.launch.mesh import make_layout  # noqa: E402
from repro_torch.models import shardctx, transformer  # noqa: E402

XENT_TOL = 1e-5
TP_TOL = 3e-4
DEADLINE_S = 240
WORLDS = (1, 2, 4, 8)
# this slice's families at full size
SPEC_ARCHS = ("vit-b16", "hubert-xlarge", "chatglm3-6b", "glm4-9b",
              "qwen2.5-14b", "gemma3-12b", "qwen2-vl-72b",
              "deepseek-v3-671b")
# the families the pipeline takes (pipeline.check_supported)
PIPE_ARCHS = ("vit-b16", "hubert-xlarge", "chatglm3-6b", "glm4-9b",
              "qwen2.5-14b", "gemma3-12b")
# D6: the KV projections the port keeps whole where the reference splits
# them into part-heads (KH 2 on a model axis of 4)
D6 = {("chatglm3-6b", 4), ("glm4-9b", 4)}
D6_LEAVES = {"stack.attn.wk", "stack.attn.wv", "stack.attn.bk",
             "stack.attn.bv"}


def _layouts(size):
    """Every (pp, model) whose product divides a world of ``size``."""
    return [(pp, m) for pp in WORLDS for m in WORLDS
            if pp * m <= size and size % (pp * m) == 0]


# --- the spawned worlds ------------------------------------------------------

def _ranks(w):
    return None if w is None else tuple(w.ranks) if w.ranks is not None \
        else tuple(range(w.size))


def _layout_job(world):
    out = {}
    for pp, m in _layouts(world.size):
        try:
            lay = make_layout(world, pp, m)
        except ValueError as e:
            out[pp, m] = str(e)
            continue
        out[pp, m] = tuple(_ranks(w) for w in (lay.data, lay.pipe,
                                                lay.model))
    return out


def _xent_inputs(masked):
    rng = np.random.default_rng(7 + masked)
    logits = 3.0 * rng.standard_normal((3, 5, 24)).astype(np.float32)
    labels = rng.integers(0, 24, (3, 5)).astype(np.int32)
    mask = rng.random((3, 5)) < 0.6 if masked else None
    return logits, labels, mask


def _xent_job(world):
    out = {}
    for masked in (False, True):
        logits, labels, mask = _xent_inputs(masked)
        n = logits.shape[-1] // world.size
        local = torch.tensor(logits[..., world.rank * n:(world.rank + 1) * n],
                             requires_grad=True)
        with shardctx.use(world):
            loss = transformer._xent(
                local, torch.from_numpy(labels),
                None if mask is None else torch.from_numpy(mask),
                vocab_parallel=True)
        loss.backward()
        out[masked] = (float(loss), local.grad.numpy().copy())
    return out


def _run_jobs(world, jobs):
    out = {"layouts": _layout_job(world)}
    if "xent" in jobs:
        out["xent"] = _xent_job(world)
    return out


@pytest.fixture(scope="module")
def worlds():
    """{world size: [each rank's results]}, the worlds side by side."""
    plan = {2: ["xent"], 4: ["xent"], 8: []}
    with concurrent.futures.ThreadPoolExecutor(len(plan)) as pool:
        runs = {n: pool.submit(distributed.spawn, _run_jobs, n, jobs,
                               device="cpu", deadline_s=DEADLINE_S,
                               timeout_s=60)
                for n, jobs in plan.items()}
        return {n: run.result() for n, run in runs.items()}


# --- the layout --------------------------------------------------------------

@pytest.mark.parametrize("size,pp,m", [(n, pp, m) for n in WORLDS
                                       for pp, m in _layouts(n)])
def test_layout_groups_follow_the_rank_formula(size, pp, m, worlds):
    """Rank ``(d * S + p) * M + m``: its data group the ranks of the same
    (p, m), its pipe group those of the same (d, m), its model group those
    of the same (d, p); a world of one runs every stage, with M 1 only."""
    if size == 1:
        one = distributed.World(rank=0, size=1, local_rank=0,
                                device=torch.device("cpu"))
        if m > 1:
            with pytest.raises(ValueError, match="world of one"):
                make_layout(one, pp, m)
            return
        lay = make_layout(one, pp, m)
        assert lay.data is one and lay.pipe is None and lay.model is None
        return
    grid = np.arange(size).reshape(size // (pp * m), pp, m)
    for r, got in enumerate(w["layouts"][pp, m] for w in worlds[size]):
        d, p, mm = (int(i[0]) for i in np.nonzero(grid == r))
        data, pipe, model = got
        assert data == tuple(grid[:, p, mm])
        assert pipe == (tuple(grid[d, :, mm]) if pp > 1 else None)
        assert model == (tuple(grid[d, p, :]) if m > 1 else None)


def test_layout_refusals():
    three = distributed.World(rank=0, size=3, local_rank=0,
                              device=torch.device("cpu"))
    with pytest.raises(ValueError, match="3 ranks is not a multiple of 2 "
                                         "pipeline stages x 2 model"):
        make_layout(three, 2, model=2)
    with pytest.raises(ValueError, match="3 ranks is not a multiple of 1 "
                                         "pipeline stages x 2 model"):
        make_layout(three, 1, model=2)
    with pytest.raises(ValueError, match=">= 1"):
        make_layout(three, 1, model=0)


# --- the model dims against the reference's specs ----------------------------

def _ref_specs(arch, axes, extents, **kw):
    """The reference's ``param_specs(..., zero_stage=3,
    tensor_parallel=True, **kw)`` of ``arch`` at full size on a mesh of
    ``axes`` and ``extents``, as ``{dotted key: spec tuple}``, and the
    port's ``{key: shape}`` with its config."""
    import jax
    from repro import configs as ref_configs
    from repro.core.sharding import _keystr, param_specs
    from repro.models import transformer as ref_model
    rcfg = ref_configs.get_config(arch)
    shapes = jax.eval_shape(lambda: ref_model.init_params(
        rcfg, jax.random.PRNGKey(0)))
    mesh = SimpleNamespace(axis_names=axes,
                           devices=np.empty(extents, object))
    specs = param_specs(shapes, zero_stage=3, tensor_parallel=True,
                        mesh=mesh, **kw)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {_keystr(p).replace("/", "."): tuple(s) for p, s in flat}
    cfg = configs.get_config(arch)
    port = {k: t.shape for k, t in transformer.init_params(
        cfg, device="meta").items()}
    assert set(port) == set(want)
    return want, port, cfg


def _axis_dim(spec, axis):
    return spec.index(axis) if axis in spec else None


@pytest.mark.parametrize("arch", SPEC_ARCHS)
@pytest.mark.parametrize("m", [2, 4])
def test_model_dims_match_reference_specs(arch, m):
    """Each leaf's model dimension is where the reference's
    ``param_specs(..., tensor_parallel=True)`` puts ``"model"`` on a data
    2 x model M mesh, but for the D6 leaves, kept whole; the ZeRO-3 data
    dimension is the reference's too. DeepSeek-V3's MLA up-projections
    split by whole heads, so none of its leaves differs."""
    want, port, cfg = _ref_specs(arch, ("data", "model"), (2, m))
    got = model_dims(port, cfg, m)
    data = shard_dims(port, zero_stage=3, world=2)
    differ = set()
    for k, spec in want.items():
        if got[k] != _axis_dim(spec, "model"):
            differ.add(k)
        assert data[k] == _axis_dim(spec, "data"), k
    assert differ == (D6_LEAVES & set(port) if (arch, m) in D6 else set())
    for k in differ:
        assert got[k] is None and want[k][-1] == "model"


@pytest.mark.parametrize("arch", PIPE_ARCHS)
def test_pipe_and_model_dims_match_reference_specs(arch):
    """On a data 2 x pipe 2 x model 2 mesh the reference's
    ``param_specs(..., tensor_parallel=True, pipeline_axis="pipe")`` puts
    ``"pipe"`` on the L axis of every stacked leaf (a stage's layers) and
    of no other, ``"model"`` where the port's ``model_dims`` puts it and
    ``"data"`` where ``shard_dims`` does: the three axes of a leaf fall on
    three different dimensions, as the engine lays them out."""
    want, port, cfg = _ref_specs(arch, ("data", "pipe", "model"), (2, 2, 2),
                                 pipeline_axis="pipe")
    got = model_dims(port, cfg, 2)
    data = shard_dims(port, zero_stage=3, world=2)
    for k, spec in want.items():
        assert _axis_dim(spec, "pipe") == (0 if is_stacked(k) else None), k
        assert got[k] == _axis_dim(spec, "model"), k
        assert data[k] == _axis_dim(spec, "data"), k
        dims = [d for d in (0 if is_stacked(k) else None, got[k], data[k])
                if d is not None]
        assert len(dims) == len(set(dims)), k


def test_model_dims_keep_whole_heads():
    """ChatGLM3-6B at M 4: ``wk`` (L, 4096, 256) holds KH 2 heads of 128;
    the reference gives each rank half a head, the port keeps it whole
    (D6); ``wq`` goes to 8 of 32 heads a rank."""
    cfg = configs.get_config("chatglm3-6b")
    shapes = {k: t.shape for k, t in transformer.init_params(
        cfg, device="meta").items()}
    dims = model_dims(shapes, cfg, 4)
    assert dims["stack.attn.wk"] is None and dims["stack.attn.bv"] is None
    assert dims["stack.attn.wq"] == 2 and dims["stack.attn.wo"] == 1
    assert dims["embed.tok"] == 0 and dims["head.w"] == 1
    assert model_dims(shapes, cfg, 2)["stack.attn.wk"] == 2


# --- the vocab-parallel cross-entropy ----------------------------------------

@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_vocab_parallel_xent_matches_reference(m, masked, worlds):
    """Each rank's loss and its gradient slice, joined over the vocabulary,
    against ``repro.models.transformer._xent`` and ``jax.grad`` of it on
    the whole logits: within 1e-5."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as ref
    logits, labels, mask = _xent_inputs(masked)
    loss_ref, grad_ref = jax.value_and_grad(lambda x: ref._xent(
        x, jnp.asarray(labels), None if mask is None
        else jnp.asarray(mask)))(jnp.asarray(logits))
    got = [w["xent"][masked] for w in worlds[m]]
    for loss, _ in got:
        assert abs(loss - float(loss_ref)) <= XENT_TOL
    grad = np.concatenate([g for _, g in got], axis=-1)
    np.testing.assert_allclose(grad, np.asarray(grad_ref), atol=XENT_TOL,
                               rtol=0)


def test_shardctx_is_the_identity_without_a_group():
    """With no group, or a group of one, every operator returns its input;
    ``use`` installs a group for its block only."""
    x = torch.randn(2, 3, 8, requires_grad=True)
    assert shardctx.active() is None
    for op in (shardctx.copy_to_model, shardctx.reduce_from_model,
               shardctx.gather_from_model):
        assert op(x) is x
    one = distributed.World(rank=0, size=1, local_rank=0,
                            device=torch.device("cpu"))
    two = SimpleNamespace(rank=0, size=2)
    with shardctx.use(one):
        assert shardctx.active() is None
        assert shardctx.copy_to_model(x) is x
        with shardctx.use(two):
            assert shardctx.active() is two
        assert shardctx.active() is None
    assert shardctx.active() is None


# --- refusals ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "rwkv6-7b",
                                  "zamba2-2.7b", "deepseek-v3-671b"])
def test_families_without_tensor_parallelism_are_refused(arch):
    """The families the model axis once refused, the MoE, RWKV6, the
    Mamba2 hybrid and DeepSeek-V3's MLA, all ported since, train one fp32
    step at ``--devices 2 --model-axis 2``: loss and grad norm within 3e-4
    of ``--devices 0``'s."""
    one = ["--arch", arch, "--smoke", "--steps", "1", "--device", "cpu"]
    argv = one + ["--devices", "2", "--model-axis", "2"]
    cfg = configs.get_smoke_config(arch)
    check_model_axis(cfg, 1)
    run = ["--seq", "32", "--batch", "4", "--log-every", "1", "--dtype",
           "float32"]
    got = _losses(cli.main(argv + run))
    want = _losses(cli.main(one + run))
    assert len(got) == len(want) == 1
    assert np.max(np.abs(np.subtract(got, want))) <= TP_TOL
    check_model_axis(cfg, 2)


@pytest.mark.parametrize("argv,match", [
    (["--arch", "granite-moe-3b-a800m", "--pp", "2", "--accum", "2",
      "--devices", "4", "--model-axis", "2"], "MoE"),
    (["--devices", "4", "--model-axis", "8"], "not a multiple of "
                                              "--model-axis 8"),
    (["--model-axis", "2"], "without a world.*item 16.1"),
    (["--devices", "2", "--model-axis", "0"], ">= 1"),
])
def test_model_axis_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["--smoke", "--steps", "1", "--device", "cpu"] + argv)


@pytest.mark.parametrize("arch", ["vit-b16", "qwen2.5-14b",
                                  "granite-moe-3b-a800m",
                                  "deepseek-v3-671b", "zamba2-2.7b"])
def test_model_axis_that_divides_nothing_matches_one_process(arch):
    """ROADMAP F2: at ``--devices 3 --model-axis 3`` the smoke configs'
    counts (4 or 8 query heads, 8 SSM heads, 4 experts, d_ff 256 or 512,
    vocab 512) do not divide by 3, where the model axis once refused
    them. Each such block now runs whole on every model rank
    (``sharding.whole_blocks``), as the reference's ``_sanitize``
    replicates what the axis does not divide: two fp32 steps within 3e-4
    of one process's losses and grad norms."""
    cfg = configs.get_smoke_config(arch)
    assert whole_blocks(cfg, 3) and not whole_blocks(cfg, 2)
    check_model_axis(cfg, 3)
    one = ["--arch", arch, "--smoke", "--steps", "2", "--device", "cpu",
           "--seq", "32", "--batch", "6", "--log-every", "1", "--dtype",
           "float32"]
    want = _losses(cli.main(one))
    got = _losses(cli.main(one + ["--devices", "3", "--model-axis", "3"]))
    assert len(got) == len(want) == 2
    assert np.max(np.abs(np.subtract(got, want))) <= TP_TOL


def test_whole_blocks_at_the_production_model_axis():
    """At the reference's model axis of 16 the full configs' blocks whose
    counts 16 does not divide run whole (F2): Qwen2.5-14B's 40 query heads
    (its attention leaves whole on every rank, D10; its MLP still split),
    Granite-MoE's 40 experts and 24 heads; the model dims then leave those
    leaves unsplit and nothing of them is summed over the group."""
    qwen = configs.get_config("qwen2.5-14b")
    granite = configs.get_config("granite-moe-3b-a800m")
    assert whole_blocks(qwen, 16) == {"attn"}
    assert whole_blocks(granite, 16) == {"attn", "moe"}
    assert whole_blocks(configs.get_config("chatglm3-6b"), 16) == set()
    shapes = {k: v.shape for k, v in transformer.init_params(
        qwen, device="meta").items()}
    dims = model_dims(shapes, qwen, 16)
    assert all(dims[k] is None for k in shapes if ".attn." in k)
    assert dims["stack.mlp.w_up"] == 2 and dims["stack.mlp.w_out"] == 1
    assert not any(model_summed(k, qwen, 16) for k in shapes)
    shapes = {k: v.shape for k, v in transformer.init_params(
        granite, device="meta").items()}
    assert not any(model_summed(k, granite, 16) for k in shapes)
    assert all(d is None for k, d in model_dims(shapes, granite, 16).items()
               if ".moe." in k or ".attn." in k)


def test_more_ranks_than_cards_are_refused(monkeypatch):
    """On cuda the CLI keeps one rank a card: ``--devices 2 --model-axis
    2`` on one card raises before any rank starts; only an explicit
    ``backend="gloo"`` lets ranks share it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 GPUs"):
        cli.main(["--smoke", "--steps", "1", "--devices", "2",
                  "--model-axis", "2"])
    assert distributed._backend(torch.device("cuda"), "gloo") == "gloo"
    assert distributed._backend(torch.device("cuda"), None) == "nccl"
    with pytest.raises(ValueError, match="backend 'nccl' on cpu"):
        distributed._backend(torch.device("cpu"), "nccl")


def test_trainer_refusals():
    cfg = configs.get_smoke_config("vit-b16")
    with pytest.raises(ValueError, match="needs a world"):
        Trainer(cfg, EngineConfig(train_batch_size=8), device="cpu",
                model_axis=2)
    with pytest.raises(ValueError, match="model axis must be >= 1"):
        Trainer(cfg, EngineConfig(train_batch_size=8), device="cpu",
                model_axis=0)
    # a model axis that divides none of DeepSeek's counts is no refusal
    # (F2: those blocks run whole), but it still needs a world
    with pytest.raises(ValueError, match="model_axis 3 needs a world"):
        Trainer(configs.get_smoke_config("deepseek-v3-671b"),
                EngineConfig(train_batch_size=8), device="cpu", model_axis=3)


# --- the CLI -----------------------------------------------------------------

def _losses(rows):
    return [(r["loss"], r["grad_norm"]) for r in rows if "loss" in r]


def test_cli_model_axis_matches_one_rank():
    """``--devices 4 --model-axis 2 --zero 3`` (data 2 x model 2) against
    ``--devices 1``, the ViT smoke config at batch 16, 3 steps: in fp32
    every loss and grad norm within 3e-4; in the config's bf16 every loss
    finite (the row-parallel partial products round to bf16 on each rank
    before their sum)."""
    base = ["--arch", "vit-b16", "--smoke", "--device", "cpu", "--steps",
            "3", "--batch", "16", "--log-every", "1"]
    tp = ["--devices", "4", "--model-axis", "2", "--zero", "3"]
    f32 = ["--dtype", "float32"]
    want = _losses(cli.main(base + f32 + ["--devices", "1"]))
    got = _losses(cli.main(base + f32 + tp))
    assert len(got) == len(want) == 3
    assert np.max(np.abs(np.subtract(got, want))) <= TP_TOL
    bf16 = _losses(cli.main(base + tp))
    assert np.all(np.isfinite(bf16))
