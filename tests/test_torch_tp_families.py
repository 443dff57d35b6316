"""Port parity for tensor parallelism in the Mamba2 hybrid, the MoE and
RWKV6 families (``--model-axis``): gloo worlds at model axis 2, model axis
4 and data 2 x model 2, at ZeRO 0 and 3, against the one-process
``Trainer`` on the same params (seed 0) and batches, for the smoke
configs of Zamba2-2.7B (D7: the whole ``w_in``/conv/head vectors sliced
by heads, the split-row inner RMSNorm, the shared attention block),
Granite-MoE-3B-A800M (expert parallelism, GShard and gather; a variant at
vocabulary 511, which no model axis divides, keeps its tied embedding
whole) and RWKV6-7B (heads); each leaf's model dimension against the
reference's ``param_specs(..., tensor_parallel=True)`` at full size, the
D7 leaves named; the split-row plain RMSNorm against the JAX package's
``ref_rmsnorm`` and its gradient; the load-balance aux's gradient counted
once over a model group; checkpoints of a model group resumed in one
process; a prefill into the Mamba2 and RWKV6 caches on the model axis
against one rank's.

Tolerances: the reference's tensor-parallel bound for losses and grad
norms (3e-4, ``tests/test_engine_distributed.py:92-101``), 2e-4 for each
leaf's first-step gradient gathered whole, the split-row norm 1e-4 in
fp32, the resume parity 1e-5 of ``tests/test_torch_checkpoint.py``, the
aux gradient 1e-6. RWKV6's fp32 gradients are gated at the group norm's
eps 1e-3, as ``tests/test_torch_rwkv6.py`` and ``test_torch_dp.py`` do.
The spawned ranks import this module, so it imports no JAX at module
level.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import concurrent.futures  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import EngineConfig  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.engine import Trainer, to_device  # noqa: E402
from repro_torch.core.sharding import model_dims, shard_dims  # noqa: E402
from repro_torch.kernels.ref import ref_rmsnorm_apply, \
    ref_rmsnorm_bwd_apply, ref_rmsnorm_bwd_dot, \
    ref_rmsnorm_sumsq  # noqa: E402
from repro_torch.launch.specs import concrete_batch  # noqa: E402
from repro_torch.models import moe, shardctx, transformer  # noqa: E402

TP_TOL, GRAD_TOL, RESUME_TOL, RMS_TOL, AUX_TOL = 3e-4, 2e-4, 1e-5, 1e-4, \
    1e-6
STEPS, BATCH, ACCUM, SEQ = 3, 8, 2, 32
DEADLINE_S = 240
GRANITE = "granite-moe-3b-a800m"
# layout -> (world size, model axis)
LAYOUTS = {"m2": (2, 2), "m4": (4, 4), "dp2-m2": (4, 2)}
ZEROS = (0, 3)
# arch[:variant] -> the layouts it runs on. The gather path counts capacity
# per data rank (ROADMAP deviation D4), which a model group does not
# change: at the config's capacity on model groups alone, at capacity 8
# (no drops) with data parallelism beside them. ":vocab511": a tied
# embedding no model axis divides, kept whole (one case)
ARCHS = {"zamba2-2.7b": tuple(LAYOUTS), GRANITE: tuple(LAYOUTS),
         GRANITE + ":gather": ("m2", "m4"),
         GRANITE + ":gather8": ("dp2-m2",), "rwkv6-7b": tuple(LAYOUTS),
         GRANITE + ":vocab511": ("m2",)}
CASES = [(arch, lay, z) for arch, lays in ARCHS.items() for lay in lays
         for z in ZEROS if not (arch.endswith("vocab511") and z)]
# the world cases that save after step 2 (resumed in one process)
SAVED = [("zamba2-2.7b", "m2", 0), (GRANITE, "dp2-m2", 3)]
# D7: the Mamba2 leaves the reference splits by contiguous columns and
# the port keeps whole (each rank slices its heads' columns)
D7_LEAVES = {"stack.mamba.w_in", "stack.mamba.conv_w",
             "stack.mamba.conv_b"}
SPEC_ARCHS = ("zamba2-2.7b", GRANITE, "rwkv6-7b")


def _name(case):
    return "-".join(map(str, case))


def _cfg(arch):
    arch, _, variant = arch.partition(":")
    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    if variant.startswith("gather"):
        cfg = cfg.replace(moe_impl="gather")
    if variant == "gather8":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    if variant == "vocab511":
        cfg = cfg.replace(vocab_size=511)
    if arch == "rwkv6-7b":
        cfg = cfg.replace(norm_eps=1e-3)
    return cfg


def _trainer(arch, *, zero=0, model=1, world=None):
    """(trainer, host batch source, fresh params of seed 0), fp32, batch 8
    in 2 microbatches of ``concrete_batch``'s 32 positions."""
    cfg = _cfg(arch)
    # RWKV6 trains with SGD: AdamW's first step is lr·sign(g), and the
    # smoke model's near-zero gradients take either sign under two orders
    # of summation (ROADMAP "RWKV6 fp32 conditioning")
    ecfg = EngineConfig(train_batch_size=BATCH,
                        gradient_accumulation_steps=ACCUM, zero_stage=zero,
                        optimizer="sgd" if cfg.block_kind == "rwkv6"
                        else "adamw", lr=1e-3, total_steps=10,
                        warmup_steps=1)
    trainer = Trainer(cfg, ecfg, device="cpu", world=world, model_axis=model)

    def batch(step):
        return to_device(concrete_batch(cfg, BATCH, SEQ, seed=step), "cpu")
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
    _, losses, gnorms = _train(
        trainer, batch, state,
        save=os.path.join(root, _name(case)) if case in SAVED else None)
    return {"losses": losses, "gnorms": gnorms,
            # the whole gradients travel from rank 0; every rank sends
            # their sums, which must agree
            "grads": grads if world.rank == 0 else None,
            "grad_sums": {k: float(np.abs(g).sum())
                          for k, g in grads.items()},
            "summed": sorted(trainer.model_summed)}


def _aux_inputs(impl):
    """One smoke Granite MoE layer's params (whole) and input, fp32."""
    cfg = _cfg(GRANITE + (":gather" if impl == "gather" else ""))
    params = transformer.init_params(cfg, seed=3, device="cpu")
    layer = {k[len("moe_stack.moe."):]: v[0] for k, v in params.items()
             if k.startswith("moe_stack.moe.")}
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model))
                         .astype(np.float32))
    return cfg, layer, x


def _aux_grad(impl, world=None):
    """The router's gradient of the layer's aux term alone: over a model
    group each rank's, summed over the group as the engine sums it."""
    cfg, layer, x = _aux_inputs(impl)
    if world is not None:
        n = cfg.moe.num_experts // world.size
        layer = {k: v[world.rank * n:(world.rank + 1) * n]
                 if k.startswith("experts.") else v
                 for k, v in layer.items()}
    layer = {k: v.clone().requires_grad_() for k, v in layer.items()}
    fn = moe.moe_ffn_gather if impl == "gather" else moe.moe_ffn
    with shardctx.use(world):
        _, aux = fn(layer, x, cfg)
    # model rank 0 alone holds the aux's gradient
    if aux.requires_grad:
        aux.backward()
    g = layer["router"].grad
    if g is None:
        g = torch.zeros_like(layer["router"])
    if world is not None:
        world.all_reduce(g, "sum")
    return float(aux.detach()), g.numpy().copy()


def _serve_prefill(arch, world=None):
    """A prefill of 2 x 12 tokens into a 16-row cache on this rank's model
    chunks of the seed-0 params, under ``world`` as the model group: the
    last position's logits gathered whole, and the cache leaves every
    rank holds whole (the RWKV6 shifts)."""
    cfg = _cfg(arch)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    size = 1 if world is None else world.size
    if world is not None:
        dims = model_dims({k: v.shape for k, v in params.items()}, cfg, size)
        params = {k: world.chunk(v, dims[k]) if dims[k] is not None else v
                  for k, v in params.items()}
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 12)))
    cache = transformer.init_cache(cfg, 2, 16, dtype=torch.float32,
                                   device="cpu", model=size)
    with torch.inference_mode(), shardctx.use(world):
        logits, cache, _ = transformer.forward(
            cfg, params, {"tokens": tokens}, mode="prefill", cache=cache)
        logits = shardctx.gather_from_model(logits[:, -1])
    return {"logits": logits.numpy(),
            "whole": {k: v.numpy() for k, v in cache["layers"].items()
                      if k.endswith("shift")} if "layers" in cache else {}}


def _run_jobs(world, lay, root):
    out = {case: _case(world, case, root) for case in CASES
           if case[1] == lay}
    if lay == "m2":
        out["aux"] = {impl: _aux_grad(impl, world)
                      for impl in ("gshard", "gather")}
        out["serve"] = {arch: _serve_prefill(arch, world)
                        for arch in ("zamba2-2.7b", "rwkv6-7b")}
    return out


@pytest.fixture(scope="module")
def one_process():
    """{arch: the one-process run's losses, grad norms and first-step
    gradients}."""
    out = {}
    for arch in ARCHS:
        trainer, batch, params = _trainer(arch)
        state = trainer.init_state(params)
        grads = _first_grads(trainer, state, batch)
        state, losses, gnorms = _train(trainer, batch, state)
        out[arch] = {"losses": losses, "gnorms": gnorms, "grads": grads}
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """({layout: [each rank's results]}, the checkpoint root): the three
    worlds side by side."""
    root = str(tmp_path_factory.mktemp("tp-families-ckpt"))
    with concurrent.futures.ThreadPoolExecutor(len(LAYOUTS)) as pool:
        runs = {lay: pool.submit(distributed.spawn, _run_jobs, size, lay,
                                 root, device="cpu", deadline_s=DEADLINE_S,
                                 timeout_s=60)
                for lay, (size, _) in LAYOUTS.items()}
        return {lay: run.result() for lay, run in runs.items()}, root


# --- training against one process --------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_name)
def test_model_axis_matches_one_process(case, worlds, one_process):
    """Losses and grad norms within 3e-4 of one process's, the same on
    every rank; every leaf's first-step gradient, gathered whole, within
    2e-4 (and the same on every rank); the whole leaves whose gradients
    the model group sums are D7's (Zamba2), the router (Granite) or none
    (RWKV6)."""
    arch, lay, _ = case
    ranks = [r[case] for r in worlds[0][lay]]
    want = one_process[arch]
    for r in ranks:
        assert np.max(np.abs(np.subtract(r["losses"],
                                         want["losses"]))) <= TP_TOL
        assert np.max(np.abs(np.subtract(r["gnorms"],
                                         want["gnorms"]))) <= TP_TOL
        assert r["losses"] == ranks[0]["losses"]
        assert r["grad_sums"] == ranks[0]["grad_sums"]
    summed = set(ranks[0]["summed"])
    if arch.startswith("zamba2"):
        assert summed == D7_LEAVES | {f"stack.mamba.{k}" for k in
                                      ("A_log", "dt_bias", "D", "norm")}
    elif arch.startswith(GRANITE):
        # and D6's KV projections at M 4 (KH 2)
        d6 = {f"moe_stack.attn.{k}" for k in ("wk", "wv")} \
            if LAYOUTS[lay][1] == 4 else set()
        assert summed == {"moe_stack.moe.router"} | d6
    else:
        assert summed == set()
    got = ranks[0]["grads"]
    assert set(got) == set(want["grads"])
    for k, g in got.items():
        assert g.shape == want["grads"][k].shape, k
        np.testing.assert_allclose(g, want["grads"][k], atol=GRAD_TOL,
                                   rtol=0, err_msg=k)


def test_whole_tied_embedding_is_not_split():
    """Vocabulary 511 (and Granite-MoE's 49,155) no model axis divides:
    the tied ``embed.tok`` stays whole on every model rank, as the
    reference's sanitised spec leaves it."""
    for cfg, m in ((_cfg(GRANITE + ":vocab511"), 2),
                   (configs.get_config(GRANITE), 2),
                   (configs.get_config(GRANITE), 4)):
        shapes = {k: t.shape for k, t in transformer.init_params(
            cfg, device="meta").items()}
        assert cfg.tie_embeddings and "head.w" not in shapes
        assert model_dims(shapes, cfg, m)["embed.tok"] is None


@pytest.mark.parametrize("impl", ["gshard", "gather"])
def test_aux_gradient_counted_once(impl, worlds):
    """The load-balance aux is the same value on every rank of a model
    group; its gradient into the router, summed over the group, is one
    process's (not M times it): model rank 0 keeps it, the others
    detach it."""
    want_aux, want = _aux_grad(impl)
    assert np.abs(want).max() > 0
    for r in worlds[0]["m2"]:
        aux, got = r["aux"][impl]
        assert abs(aux - want_aux) <= AUX_TOL
        np.testing.assert_allclose(got, want, atol=AUX_TOL, rtol=0)


# --- checkpoints ---------------------------------------------------------------

@pytest.mark.parametrize("case", SAVED, ids=_name)
def test_model_axis_checkpoint_resumes_in_one_process(case, worlds):
    """A model group's save after step 2 (the D7 leaves and the router
    whole, by model rank 0; the experts by their E chunks, and under
    ZeRO 3 their data chunks of those), then step 2 in one process: within
    1e-5 of the world's own step 2 from the same state."""
    results, root = worlds
    path = os.path.join(root, _name(case))
    with open(os.path.join(path, "step_00000002", "manifest.json")) as f:
        manifest = json.load(f)
    size, m = LAYOUTS[case[1]]
    assert manifest["mesh"] == {"data": size // m, "pipe": 1, "model": m}
    specs = {k: v["spec"] for k, v in manifest["leaves"].items()}
    if case[0].startswith("zamba2"):
        assert "model" not in specs["params/stack/mamba/w_in"]
        assert specs["params/stack/mamba/w_out"][1] == "model"
    else:
        assert specs["params/moe_stack/moe/experts/w_up"][1] == "model"
        assert "model" not in specs["params/moe_stack/moe/router"]
    trainer, batch, _ = _trainer(case[0])
    state = trainer.restore_state(path)
    assert state.step == 2
    _, tail, tail_g = _train(trainer, batch, state, start=2)
    want = results[case[1]][0][case]
    assert abs(tail[0] - want["losses"][2]) <= RESUME_TOL
    assert abs(tail_g[0] - want["gnorms"][2]) <= RESUME_TOL


# --- the model dims against the reference's specs ------------------------------

@pytest.mark.parametrize("arch", SPEC_ARCHS)
@pytest.mark.parametrize("m", [2, 4])
def test_model_dims_match_reference_specs(arch, m):
    """Each leaf's model dimension is where the reference's
    ``param_specs(..., tensor_parallel=True)`` puts ``"model"`` on a data
    2 x model M mesh, but for the D7 leaves, kept whole; the ZeRO-3 data
    dimension is the reference's too."""
    import jax
    from repro import configs as ref_configs
    from repro.core.sharding import _keystr, param_specs
    from repro.models import transformer as ref_model
    rcfg = ref_configs.get_config(arch)
    shapes = jax.eval_shape(lambda: ref_model.init_params(
        rcfg, jax.random.PRNGKey(0)))
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty((2, m), object))
    specs = param_specs(shapes, zero_stage=3, tensor_parallel=True,
                        mesh=mesh)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {_keystr(p).replace("/", "."): tuple(s) for p, s in flat}
    cfg = configs.get_config(arch)
    port = {k: t.shape for k, t in transformer.init_params(
        cfg, device="meta").items()}
    assert set(port) == set(want)
    got = model_dims(port, cfg, m)
    data = shard_dims(port, zero_stage=3, world=2)
    differ = set()
    for k, spec in want.items():
        ref_dim = spec.index("model") if "model" in spec else None
        if got[k] != ref_dim:
            differ.add(k)
        assert data[k] == (spec.index("data") if "data" in spec else None), k
    assert differ == (D7_LEAVES if arch == "zamba2-2.7b" else set())
    for k in differ:
        assert got[k] is None and want[k][-1] == "model"


# --- the split-row RMSNorm -----------------------------------------------------

@pytest.mark.parametrize("m", [2, 4])
def test_split_row_rmsnorm_matches_reference(m):
    """The split-row plain RMSNorm over M column parts, each part's
    partial sums summed as the all-reduce sums them: its output, dx and
    dscale joined over the parts against the JAX package's ``ref_rmsnorm``
    and ``jax.grad`` of it on whole rows (a cotangent drawn with numpy),
    within 1e-4 in fp32."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.ref import ref_rmsnorm
    rng = np.random.default_rng(5 + m)
    rows, width, eps = 24, 160, 1e-5
    x = rng.standard_normal((rows, width)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(width)).astype(np.float32)
    dy = rng.standard_normal((rows, width)).astype(np.float32)
    out_ref, vjp = jax.vjp(lambda a, s: ref_rmsnorm(a, s, eps),
                           jnp.asarray(x), jnp.asarray(scale))
    dx_ref, ds_ref = vjp(jnp.asarray(dy))
    parts = [slice(i * width // m, (i + 1) * width // m) for i in range(m)]
    xs = [torch.from_numpy(x[:, c]) for c in parts]
    ss_ = [torch.from_numpy(scale[c]) for c in parts]
    dys = [torch.from_numpy(dy[:, c]) for c in parts]
    sumsq = sum(ref_rmsnorm_sumsq(p) for p in xs)
    outs = [ref_rmsnorm_apply(p, s, sumsq, width, eps) for p, s in
            zip(xs, ss_)]
    rinv = outs[0][1]
    dot = sum(ref_rmsnorm_bwd_dot(p, s, g) for p, s, g in zip(xs, ss_, dys))
    grads = [ref_rmsnorm_bwd_apply(p, s, rinv, g, dot, width)
             for p, s, g in zip(xs, ss_, dys)]
    for got, want in ((torch.cat([o for o, _ in outs], -1), out_ref),
                      (torch.cat([g for g, _ in grads], -1), dx_ref),
                      (torch.cat([d for _, d in grads]), ds_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=RMS_TOL, rtol=0)


@pytest.mark.parametrize("kernels", [True, False])
def test_split_rmsnorm_function_matches_whole_row(kernels):
    """``ops.split_rmsnorm`` over two parts (the reduce adding the other
    part's sums, as a model group of two would) against the whole-row
    ``fused_rmsnorm`` on the CPU, forward and autograd gradients, in
    fp32, within 1e-5: on the wrappers' CPU path (``kernels``) and on the
    plain versions."""
    from repro_torch.kernels.ops import fused_rmsnorm, split_rmsnorm
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(3, 5, 64, generator=gen, requires_grad=True)
    scale = (1 + 0.1 * torch.randn(64, generator=gen)).requires_grad_()
    dy = torch.randn(3, 5, 64, generator=gen)
    want = fused_rmsnorm(x, scale, eps=1e-5)
    want_dx, want_ds = torch.autograd.grad(want, (x, scale), dy)
    halves = (slice(0, 32), slice(32, 64))

    def part(i):
        # the reduce adds the other part's partial sums: the forward's,
        # then the backward's
        o = halves[1 - i]
        xo, so, go = x.detach()[..., o], scale.detach()[o], dy[..., o]
        extra = [ref_rmsnorm_sumsq(xo), ref_rmsnorm_bwd_dot(xo, so, go)]
        out = split_rmsnorm(x[..., halves[i]], scale[halves[i]], eps=1e-5,
                            width=64, reduce=lambda t: t + extra.pop(0),
                            kernels=kernels)
        dx, ds = torch.autograd.grad(out, (x, scale), dy[..., halves[i]])
        assert not extra
        return out, dx, ds
    outs = [part(i) for i in range(2)]
    torch.testing.assert_close(torch.cat([o for o, _, _ in outs], -1),
                               want, atol=1e-5, rtol=0)
    torch.testing.assert_close(outs[0][1] + outs[1][1], want_dx, atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(outs[0][2] + outs[1][2], want_ds, atol=1e-5,
                               rtol=0)


# --- serving ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-7b"])
def test_serving_refused_on_the_model_axis(arch, worlds):
    """A Mamba2 or RWKV6 prefill into a cache under a model group of 2
    (each rank its heads of the SSD or WKV state, the conv state its
    heads' x channels and the B and C channels; ROADMAP D9) runs, and its
    logits, gathered whole, and its cache leaves that stay whole on every
    rank match one rank's within 3e-4, the same on both ranks."""
    want = _serve_prefill(arch)
    ranks = worlds[0]["m2"]
    for rank, res in enumerate(ranks):
        got = res["serve"][arch]
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   atol=TP_TOL, rtol=0, err_msg=f"{rank}")
        np.testing.assert_array_equal(got["logits"],
                                      ranks[0]["serve"][arch]["logits"])
        for key, leaf in got["whole"].items():
            np.testing.assert_allclose(leaf, want["whole"][key],
                                       atol=TP_TOL, rtol=0, err_msg=key)
