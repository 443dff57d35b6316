"""Port parity for tensor parallelism in DeepSeek-V3 (``--model-axis`` on
MLA, its MoE layer with routed and shared experts, its dense first layer
and its MTP head): ``mla_block`` split over gloo model groups of 2 and 4
against the reference's ``mla_block`` (``repro.models.attention``) on the
same params, with its gradients against one process; the MTP head's
vocab-sharded logits gathered whole against one process's; the smoke
config's training on worlds of model 2, model 4 and data 2 x model 2 (at
ZeRO 0 and 3) against the one-process ``Trainer``; the CLI at ``--devices
2 --model-axis 2`` and ``--devices 4 --model-axis 4`` against
``--devices 0``; MLA's prefill and absorbed decode on the model axis
against one rank's.

Tolerances: ``tests/test_torch_mla.py``'s 1e-5 (absolute and relative)
for ``mla_block`` in fp32, and for its gradients against one process;
the reference's tensor-parallel bound for losses and grad norms (3e-4,
``tests/test_engine_distributed.py:92-101``); 2e-4 for each leaf's
first-step gradient gathered whole; the MTP logits 1e-5. The spawned
ranks import this module, so it imports no JAX at module level.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import concurrent.futures  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import EngineConfig  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.engine import Trainer, to_device  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.launch.specs import concrete_batch  # noqa: E402
from repro_torch.models import attention, shardctx, transformer  # noqa: E402

ARCH = "deepseek-v3-671b"
BLOCK_TOL, BLOCK_GRAD_TOL, MTP_TOL = 1e-5, 1e-5, 1e-5
TP_TOL, GRAD_TOL = 3e-4, 2e-4
STEPS, BATCH, ACCUM, SEQ = 3, 8, 2, 32
DEADLINE_S = 240
# layout -> (world size, model axis)
LAYOUTS = {"m2": (2, 2), "m4": (4, 4), "dp2-m2": (4, 2)}
CASES = [("m2", 0), ("m2", 3), ("m4", 0), ("dp2-m2", 3)]
ROUTES = ("kernels", "naive")
# the leaves MLA splits by heads over the model group: (dimension, heads)
SPLIT = {"w_uq": -1, "w_uk": -1, "w_uv": -1, "wo": 0}


def _name(case):
    return "-".join(map(str, case))


def _cfg(route="kernels"):
    return configs.get_smoke_config(ARCH).replace(
        dtype="float32", use_kernels=route == "kernels", attn_impl="naive")


# --- one MLA block -------------------------------------------------------------

def _block_inputs():
    """(numpy params of one MLA layer, x (2, SEQ, d), positions, the
    output's cotangent), drawn with numpy; the norm scales perturbed."""
    cfg = _cfg()
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    rng = np.random.default_rng(5)
    shapes = {"w_dq": (d, m.q_lora_rank), "w_uq": (m.q_lora_rank, h * qk),
              "w_dkv": (d, m.kv_lora_rank + m.qk_rope_head_dim),
              "w_uk": (m.kv_lora_rank, h * m.qk_nope_head_dim),
              "w_uv": (m.kv_lora_rank, h * m.v_head_dim),
              "wo": (h * m.v_head_dim, d)}
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    for k, n in (("q_norm", m.q_lora_rank), ("kv_norm", m.kv_lora_rank)):
        p[k] = (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    x = rng.standard_normal((2, SEQ, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ)[None], (2, SEQ)).astype(np.int32)
    dy = rng.standard_normal((2, SEQ, d)).astype(np.float32)
    return p, x, pos, dy


def _chunk(key, value, rank, size):
    """Model rank ``rank``'s chunk of an MLA leaf: its heads' columns of
    the up-projections, its rows of ``wo``; the rest whole."""
    if key not in SPLIT:
        return value
    return np.split(value, size, axis=SPLIT[key])[rank]


def _block(route, world=None):
    """``mla_block`` on this rank's chunks (whole params without a
    world): (output, dx, {leaf: gradient of this rank's chunk})."""
    p, x, pos, dy = _block_inputs()
    rank, size = (0, 1) if world is None else (world.rank, world.size)
    params = {k: torch.tensor(_chunk(k, v, rank, size), requires_grad=True)
              for k, v in p.items()}
    xt = torch.tensor(x, requires_grad=True)
    with shardctx.use(world):
        out = attention.mla_block(params, xt, _cfg(route),
                                  positions=torch.from_numpy(pos).long())
    out.backward(torch.from_numpy(dy))
    return (out.detach().numpy(), xt.grad.numpy(),
            {k: t.grad.numpy() for k, t in params.items()})


# --- the MTP head --------------------------------------------------------------

def _mtp_inputs():
    cfg = _cfg()
    params = transformer.init_params(cfg, seed=2, device="cpu")
    batch = to_device(concrete_batch(cfg, 2, SEQ, seed=4), "cpu")
    return cfg, params, batch


def _mtp(world=None):
    """The MTP head's logits, gathered whole over the vocabulary, and the
    loss with and without them, at the model chunks of ``world``."""
    cfg, params, batch = _mtp_inputs()
    if world is not None:
        trainer = Trainer(cfg, EngineConfig(train_batch_size=2),
                          device="cpu", world=world, model_axis=world.size)
        params = {k: world.chunk(v, d) if d is not None else v
                  for k, v in params.items()
                  for d in (trainer.model_dims[k],)}
    with torch.no_grad(), shardctx.use(world):
        logits, aux = transformer.forward(cfg, params, batch)
        both = transformer.loss_from_logits(cfg, logits, batch, aux)[0]
        main = transformer.loss_from_logits(cfg, logits, batch)[0]
        mtp = aux["mtp_logits"]
        if world is not None:
            mtp = world.all_gather_many([mtp], [mtp.ndim - 1])[0]
    return mtp.numpy(), float(both), float(main)


# --- training -----------------------------------------------------------------

def _trainer(*, zero=0, model=1, world=None):
    """(trainer, host batch source, fresh params of seed 0), fp32 smoke
    DeepSeek-V3 (one dense and one MoE layer with a shared expert, the
    MTP head), AdamW, batch 8 in 2 microbatches of 32 positions."""
    cfg = _cfg()
    ecfg = EngineConfig(train_batch_size=BATCH,
                        gradient_accumulation_steps=ACCUM, zero_stage=zero,
                        lr=1e-3, total_steps=10, warmup_steps=1)
    trainer = Trainer(cfg, ecfg, device="cpu", world=world, model_axis=model)

    def batch(step):
        return to_device(concrete_batch(cfg, BATCH, SEQ, seed=step), "cpu")
    return trainer, batch, transformer.init_params(cfg, seed=0,
                                                   device="cpu")


def _train(trainer, batch, state):
    losses, gnorms = [], []
    for i in range(STEPS):
        state, m = trainer.train_step(state, batch(i))
        assert m["step_ok"] == 1
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return losses, gnorms


def _first_grads(trainer, state, batch):
    """Every leaf's gradient of the first batch at the initial params,
    whole (gathered over the data and model groups)."""
    grads, _ = trainer.grads(state.params, batch(0))
    if trainer.data is not None and trainer.ecfg.zero_stage >= 2:
        grads = trainer._whole(grads, trainer.opt_dims)
    return {k: g.detach().numpy().copy()
            for k, g in trainer.model_whole(grads).items()}


def _case(world, case):
    lay, zero = case
    trainer, batch, params = _trainer(zero=zero, model=LAYOUTS[lay][1],
                                      world=world)
    state = trainer.init_state(params)
    grads = _first_grads(trainer, state, batch)
    losses, gnorms = _train(trainer, batch, state)
    return {"losses": losses, "gnorms": gnorms,
            "grads": grads if world.rank == 0 else None,
            "grad_sums": {k: float(np.abs(g).sum())
                          for k, g in grads.items()},
            "summed": sorted(trainer.model_summed)}


def _mla_serve(world=None):
    """``mla_block`` with a cache on this rank's chunks and, where the
    model axis divides its SEQ rows, its rows of the latents (installed
    as split, as ``Server`` installs it): a prefill of the first SEQ - 4
    rows, then 4 absorbed decode steps -> the outputs, summed over the
    model group (2, SEQ, d)."""
    p, x, pos, _ = _block_inputs()
    rank, size = (0, 1) if world is None else (world.rank, world.size)
    params = {k: torch.tensor(_chunk(k, v, rank, size))
              for k, v in p.items()}
    cfg = _cfg()
    cache = {k: v[0] for k, v in transformer.init_cache(
        cfg, 2, SEQ, dtype=torch.float32, device="cpu",
        model=size)["dense"].items()}
    x, pos = torch.from_numpy(x), torch.from_numpy(pos).long()
    s = SEQ - 4
    outs = []
    split = cache["c_kv"].shape[1] != SEQ
    with torch.inference_mode(), shardctx.use(world, latents=split):
        outs.append(attention.mla_block(params, x[:, :s], cfg,
                                        positions=pos[:, :s], cache=cache))
        for i in range(s, SEQ):
            outs.append(attention.mla_block(
                params, x[:, i:i + 1], cfg, positions=pos[:, i:i + 1],
                cache=cache, cache_index=i))
    return torch.cat(outs, 1).numpy()


def _run_jobs(world, lay):
    out = {case: _case(world, case) for case in CASES if case[0] == lay}
    if lay != "dp2-m2":
        out["block"] = {route: _block(route, world) for route in ROUTES}
        out["mtp"] = _mtp(world)
    if lay == "m2":
        out["serve"] = _mla_serve(world)
    return out


@pytest.fixture(scope="module")
def one_process():
    trainer, batch, params = _trainer()
    state = trainer.init_state(params)
    grads = _first_grads(trainer, state, batch)
    losses, gnorms = _train(trainer, batch, state)
    return {"losses": losses, "gnorms": gnorms, "grads": grads,
            "block": {route: _block(route) for route in ROUTES},
            "mtp": _mtp()}


@pytest.fixture(scope="module")
def worlds():
    """{layout: [each rank's results]}, the three worlds side by side."""
    with concurrent.futures.ThreadPoolExecutor(len(LAYOUTS)) as pool:
        runs = {lay: pool.submit(distributed.spawn, _run_jobs, size, lay,
                                 device="cpu", deadline_s=DEADLINE_S,
                                 timeout_s=60)
                for lay, (size, _) in LAYOUTS.items()}
        return {lay: run.result() for lay, run in runs.items()}


# --- MLA's block against the reference ----------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("lay", ["m2", "m4"])
def test_mla_block_across_ranks_matches_reference(lay, route, worlds):
    """``mla_block`` on each rank's heads (its column chunks of ``w_uq``,
    ``w_uk``, ``w_uv`` and row chunk of ``wo``), summed over the model
    group, against the reference's ``mla_block`` on the whole params
    within 1e-5, the same output on every rank (the kernel route is the
    plain attention on the CPU)."""
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro.models import attention as ref_attn
    p, x, pos, _ = _block_inputs()
    rcfg = ref_configs.get_smoke_config(ARCH).replace(dtype="float32",
                                                      attn_impl="naive")
    want, _ = ref_attn.mla_block({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), rcfg,
                                 positions=jnp.asarray(pos))
    outs = [r["block"][route][0] for r in worlds[lay]]
    for out in outs:
        np.testing.assert_allclose(out, np.asarray(want), atol=BLOCK_TOL,
                                   rtol=BLOCK_TOL)
        np.testing.assert_array_equal(out, outs[0])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("lay", ["m2", "m4"])
def test_mla_block_gradients_across_ranks(lay, route, worlds, one_process):
    """The block's gradients at model 2 and 4 against one process's
    within 1e-5: dx and the replicated leaves' (``w_dq``, ``q_norm``,
    ``w_dkv``, ``kv_norm``, summed through ``copy_to_model`` on the
    latents) whole on every rank; the head-split leaves' chunks joined
    over the ranks."""
    ranks = [r["block"][route] for r in worlds[lay]]
    _, want_dx, want = one_process["block"][route]
    for _, dx, grads in ranks:
        np.testing.assert_allclose(dx, want_dx, atol=BLOCK_GRAD_TOL,
                                   rtol=BLOCK_GRAD_TOL)
        for k in set(want) - set(SPLIT):
            np.testing.assert_allclose(grads[k], want[k],
                                       atol=BLOCK_GRAD_TOL,
                                       rtol=BLOCK_GRAD_TOL, err_msg=k)
    for k, axis in SPLIT.items():
        joined = np.concatenate([g[k] for _, _, g in ranks], axis=axis)
        np.testing.assert_allclose(joined, want[k], atol=BLOCK_GRAD_TOL,
                                   rtol=BLOCK_GRAD_TOL, err_msg=k)


def test_mla_decode_is_refused_on_the_model_axis(worlds):
    """MLA's prefill and absorbed decode at model axis 2, each rank its
    heads of ``w_uq``/``w_uk``/``w_uv``/``wo`` and its half of the latent
    cache's rows (split on the sequence, as the reference's
    ``cache_specs``; the decode's partial softmaxes merged over the
    group), summed over the group: within 1e-5 of one rank's, the same on
    both ranks."""
    want = _mla_serve()
    ranks = worlds["m2"]
    for rank, res in enumerate(ranks):
        np.testing.assert_allclose(res["serve"], want, atol=BLOCK_TOL,
                                   rtol=BLOCK_TOL, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(res["serve"], ranks[0]["serve"])


# --- the MTP head -------------------------------------------------------------

@pytest.mark.parametrize("lay", ["m2", "m4"])
def test_mtp_head_is_vocab_parallel(lay, worlds, one_process):
    """The MTP head's logits, each rank's vocabulary chunk gathered whole,
    and the loss with and without its 0.3-weighted term (the
    vocab-parallel NLL) against one process within 1e-5."""
    want, both, main = one_process["mtp"]
    assert both - main > 1.0            # the MTP term is in the loss
    for got, g_both, g_main in (r["mtp"] for r in worlds[lay]):
        np.testing.assert_allclose(got, want, atol=MTP_TOL, rtol=0)
        assert abs(g_both - both) <= MTP_TOL
        assert abs(g_main - main) <= MTP_TOL


# --- training against one process ---------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_name)
def test_model_axis_matches_one_process(case, worlds, one_process):
    """Losses and grad norms (AdamW, 3 steps) within 3e-4 of one
    process's, the same on every rank; every leaf's first-step gradient,
    gathered whole, within 2e-4: the dense first layer's, the MoE layer's
    routed and shared experts', the MTP head's; the router is the one
    leaf whose gradients the model group sums."""
    ranks = [r[case] for r in worlds[case[0]]]
    want = one_process
    for r in ranks:
        assert np.max(np.abs(np.subtract(r["losses"],
                                         want["losses"]))) <= TP_TOL
        assert np.max(np.abs(np.subtract(r["gnorms"],
                                         want["gnorms"]))) <= TP_TOL
        assert r["losses"] == ranks[0]["losses"]
        assert r["grad_sums"] == ranks[0]["grad_sums"]
        assert r["summed"] == ["moe_stack.moe.router"]
    got = ranks[0]["grads"]
    assert set(got) == set(want["grads"])
    for key in ("dense_stack.mlp.w_gate", "moe_stack.moe.shared.w_out",
                "moe_stack.moe.experts.w_up", "mtp.block.attn.w_uq",
                "mtp.proj"):
        assert np.abs(got[key]).sum() > 0, key
    for k, g in got.items():
        assert g.shape == want["grads"][k].shape, k
        np.testing.assert_allclose(g, want["grads"][k], atol=GRAD_TOL,
                                   rtol=0, err_msg=k)


def _losses(rows):
    return [(r["loss"], r["grad_norm"]) for r in rows if "loss" in r]


@pytest.mark.parametrize("m", [2, 4])
def test_cli_model_axis_matches_one_process(m):
    """``--arch deepseek-v3-671b --smoke --devices M --model-axis M``,
    AdamW, 2 steps of batch 8 in 2 microbatches, fp32: every loss and grad
    norm within 3e-4 of ``--devices 0``'s."""
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
            "--seq", "32", "--batch", "8", "--accum", "2", "--dtype",
            "float32", "--log-every", "1"]
    want = _losses(cli.main(base + ["--devices", "0"]))
    got = _losses(cli.main(base + ["--devices", str(m), "--model-axis",
                                   str(m)]))
    assert len(got) == len(want) == 2
    assert np.max(np.abs(np.subtract(got, want))) <= TP_TOL
