"""Port parity for ``embed_sharding="dmodel"`` (``EngineConfig``): the
token embedding ``embed.tok`` (V, d) split on its feature columns over
the model axis, with no ZeRO split, where "vocab" splits its rows.

- Each leaf's model and data dimensions against the reference's
  ``param_specs(..., embed_sharding="dmodel")`` for every decoder config
  at full size, at model 2, 4 and 16 and on the data 2 x pipe 2 x model 2
  mesh: the port differs from the reference on the same leaves as under
  "vocab" (D6, D7, and the blocks F2 runs whole), never on ``embed.tok``.
- ``EngineConfig`` and ``Server`` refuse any other layout (caveat R7).
- Training on gloo worlds at model 2 and 4 (Qwen2.5 untied, Gemma3 and
  Granite-MoE tied, DeepSeek-V3 with its MTP head, RWKV6), held against
  one process and against the reference's ``loss_fn`` on the same
  params: the first step's loss and every gradient, gathered whole, the
  params after 2 steps, and the reference's loss at those params. The
  tied heads give whole logits, the untied ones vocab-sharded.
- Tied Gemma3 in bf16 at model 2 and 4: "dmodel"'s logits, loss and
  gradients drift from one process's no further than "vocab"'s (the
  head's partial logits are summed in fp32 and rounded once).
- Gemma3 at model 3 (d 256: ``embed.tok`` whole) and at pipe 2 x model
  2 (stage 0's lookup, the last stage's tied head) against one process.
- Under Ulysses the layout has no effect: "dmodel" is bitwise "vocab".
- Qwen2.5 still learns (12 steps on a fixed batch, the reference's
  ``test_perf_option_training_still_learns[opt1]``) at world 1 and at
  model 2.
- Checkpoints at data 2 x model 2, ZeRO-3, written under one layout and
  restored under the other, both ways: every leaf bitwise, the next step
  within 1e-5 of the writer's own.
- A tied ``Server`` decode at model 2 against one rank.
- The collective bytes of a training step: a recording world's equal a
  gloo world's, and "dmodel" less "vocab" is the formula (the lookup's
  all-gather for its all-reduce; a tied head's logits all-reduced for
  the vocab-parallel NLL's three reductions). The dry run's ``--embed
  dmodel`` record and ``tools/profile_pair.py --embed dmodel``.

Tolerances: the reference's tensor-parallel bound (3e-4,
``tests/test_engine_distributed.py:92-101``) for losses, grad norms,
gradients, params and logits; the resume parity 1e-5 of
``tests/test_torch_checkpoint.py``; the bf16 bounds stated in
``test_tied_head_in_bf16_drifts_no_further_than_vocab``. RWKV6 trains with SGD at the group
norm's eps 1e-3, as ``tests/test_torch_tp_families.py`` does. The spawned
ranks import this module, so it imports no JAX at module level.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import concurrent.futures  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import EngineConfig  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.distributed import count_collectives, \
    recording_world, reset_collectives  # noqa: E402
from repro_torch.core.engine import Server, Trainer, \
    to_device  # noqa: E402
from repro_torch.core.sharding import is_stacked, model_dims, \
    model_summed, shard_dims  # noqa: E402
from repro_torch.launch.specs import concrete_batch  # noqa: E402
from repro_torch.models import shardctx, transformer  # noqa: E402

TOL, RESUME_TOL = 3e-4, 1e-5
STEPS, BATCH, ACCUM, SEQ = 3, 8, 2, 32
DEADLINE_S = 300
GEMMA, QWEN, GRANITE = "gemma3-12b", "qwen2.5-14b", "granite-moe-3b-a800m"
DEEPSEEK, RWKV = "deepseek-v3-671b", "rwkv6-7b"
TRAIN_ARCHS = (QWEN, GEMMA, GRANITE, DEEPSEEK, RWKV)
TIED = (GEMMA, GRANITE)
# layout -> (world size, data, pipe, model, ZeRO stage)
LAYOUTS = {"m2": (2, 1, 1, 2, 0), "m4": (4, 1, 1, 4, 0),
           "m3": (3, 1, 1, 3, 0), "pp2-m2": (4, 1, 2, 2, 0)}
CASES = [(arch, lay) for lay in ("m2", "m4") for arch in TRAIN_ARCHS] + \
    [(GEMMA, "m3"), (GEMMA, "pp2-m2")]
# every decoder config (the ViT and HuBERT have no token embedding)
DECODERS = ("chatglm3-6b", "glm4-9b", QWEN, GEMMA, "qwen2-vl-72b", DEEPSEEK,
            GRANITE, RWKV, "zamba2-2.7b")
PIPE_DECODERS = ("chatglm3-6b", "glm4-9b", QWEN, GEMMA)
# the data 2 x model 2 layout of the checkpoint and Ulysses jobs
DP2_M2 = (2, 2, 3)
LEARN_STEPS = 12


def _name(case):
    return "-".join(map(str, case))


def _fields(arch):
    """The config fields replaced in both packages: fp32, and RWKV6 at
    its group norm's gate eps."""
    return {"dtype": "float32", **({"norm_eps": 1e-3} if arch == RWKV
                                   else {})}


def _cfg(arch):
    return configs.get_smoke_config(arch).replace(**_fields(arch))


def _ecfg(arch, embed="dmodel", **kw):
    # RWKV6 trains with SGD (``tests/test_torch_tp_families.py``)
    return EngineConfig(**{
        "train_batch_size": BATCH, "gradient_accumulation_steps": ACCUM,
        "optimizer": "sgd" if arch == RWKV else "adamw", "lr": 1e-3,
        "total_steps": 10, "warmup_steps": 1, "embed_sharding": embed,
        **kw})


def _batch(cfg, step):
    return to_device(concrete_batch(cfg, BATCH, SEQ, seed=step), "cpu")


def _train(trainer, state, start=0, save=None):
    """Steps ``start``..STEPS-1 (saving before step 2 into ``save``):
    (state, losses, grad norms)."""
    losses, gnorms = [], []
    for i in range(start, STEPS):
        if i == 2 and save is not None:
            trainer.save_state(save, state)
        state, m = trainer.train_step(state, _batch(trainer.cfg, i))
        assert m["step_ok"] == 1
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return state, losses, gnorms


def _numpy(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _first_grads(trainer, state):
    """Every leaf's gradient of the first batch at the initial params,
    whole (gathered over the model group)."""
    grads, _ = trainer.grads(state.params, _batch(trainer.cfg, 0))
    return _numpy(trainer.model_whole(grads))


def _logits_width(trainer, state):
    """The last dimension of the logits a rank's forward gives under its
    model group: the vocabulary whole, or this rank's chunk of it."""
    with torch.no_grad(), trainer.group_context():
        logits, _ = transformer.forward(trainer.cfg, state.params,
                                        _batch(trainer.cfg, 0))
    return logits.shape[-1]


def _case(world, case):
    """One training case under "dmodel": the first step's whole gradients
    (pipe 2 x model 2: none), three steps, the whole params after two."""
    arch, lay = case
    _, _, pipe, model, zero = LAYOUTS[lay]
    cfg = _cfg(arch)
    trainer = Trainer(cfg, _ecfg(arch, zero_stage=zero,
                                 pipeline_stages=pipe), device="cpu",
                      world=world, model_axis=model)
    state = trainer.init_state(transformer.init_params(cfg, seed=0,
                                                       device="cpu"))
    grads = _first_grads(trainer, state) if pipe == 1 else {}
    width = _logits_width(trainer, state) if pipe == 1 else None
    losses, gnorms = [], []
    for i in range(STEPS):
        if i == 2:
            after2 = _numpy(trainer.full_params(state))
        state, m = trainer.train_step(state, _batch(cfg, i))
        assert m["step_ok"] == 1
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return {"losses": losses, "gnorms": gnorms, "width": width,
            "embed_dim": trainer.model_dims["embed.tok"],
            "summed": sorted(trainer.model_summed),
            # the whole tensors travel from rank 0; every rank sends their
            # sums, which must agree
            "grads": grads if world.rank == 0 else None,
            "params": after2 if world.rank == 0 else None,
            "grad_sums": {k: float(np.abs(g).sum()) for k, g in
                          grads.items()}}


def _ulysses(world):
    """Gemma3 under Ulysses at data 2 x model 2, ZeRO-3, under each
    layout: losses, grad norms, the whole params after three steps."""
    out = {}
    data, model, zero = DP2_M2
    for embed in ("vocab", "dmodel"):
        cfg = _cfg(GEMMA)
        trainer = Trainer(cfg, _ecfg(GEMMA, embed, zero_stage=zero,
                                     sequence_parallel="ulysses"),
                          device="cpu", world=world, model_axis=model)
        assert trainer.ulysses
        state = trainer.init_state(transformer.init_params(cfg, seed=0,
                                                           device="cpu"))
        state, losses, gnorms = _train(trainer, state)
        out[embed] = {"losses": losses, "gnorms": gnorms,
                      "params": _numpy(trainer.full_params(state)),
                      "dims": (trainer.model_dims["embed.tok"],
                               trainer.param_dims["embed.tok"])}
    return out


def _checkpoints(world, root):
    """At data 2 x model 2 under ZeRO-3: each layout trains three steps,
    saving before step 2, and keeps its whole state there; then the other
    layout restores that save and takes step 2."""
    _, model, zero = DP2_M2
    cfg = _cfg(GEMMA)
    runs = {}
    for embed in ("vocab", "dmodel"):
        trainer = Trainer(cfg, _ecfg(GEMMA, embed, zero_stage=zero),
                          device="cpu", world=world, model_axis=model)
        state = trainer.init_state(transformer.init_params(cfg, seed=0,
                                                           device="cpu"))
        seen = {}
        real = trainer.save_state

        def save(path, st, trainer=trainer, real=real, seen=seen):
            seen["params"] = _numpy(trainer.full_params(st))
            opt = trainer.full_opt_state(st)
            seen["mu"], seen["nu"] = _numpy(opt.mu), _numpy(opt.nu)
            return real(path, st)
        trainer.save_state = save
        _, losses, gnorms = _train(trainer, state,
                                   save=os.path.join(root, embed))
        runs[embed] = dict(seen, losses=losses, gnorms=gnorms)
    out = {}
    for wrote, read in (("vocab", "dmodel"), ("dmodel", "vocab")):
        trainer = Trainer(cfg, _ecfg(GEMMA, read, zero_stage=zero),
                          device="cpu", world=world, model_axis=model)
        state = trainer.restore_state(os.path.join(root, wrote))
        opt = trainer.full_opt_state(state)
        restored = {"params": _numpy(trainer.full_params(state)),
                    "mu": _numpy(opt.mu), "nu": _numpy(opt.nu)}
        _, losses, gnorms = _train(trainer, state, start=2)
        out[wrote, read] = {
            "step": state.step, "losses": losses, "gnorms": gnorms,
            "bitwise": all(np.array_equal(restored[t][k], runs[wrote][t][k])
                           for t in ("params", "mu", "nu")
                           for k in runs[wrote][t]),
            "writer": (runs[wrote]["losses"][2], runs[wrote]["gnorms"][2])}
    return out


def _learn(world=None):
    """The reference's ``test_perf_option_training_still_learns[opt1]``:
    Qwen2.5's smoke config in fp32 under "dmodel", 12 steps on a fixed
    batch; the losses."""
    cfg = _cfg(QWEN)
    ecfg = EngineConfig(train_batch_size=8, lr=3e-3, total_steps=20,
                        warmup_steps=2, embed_sharding="dmodel")
    trainer = Trainer(cfg, ecfg, device="cpu", world=world,
                      model_axis=2 if world is not None else 1)
    state = trainer.init_state(transformer.init_params(cfg, seed=0,
                                                       device="cpu"))
    batch = to_device(concrete_batch(cfg, 8, 32, seed=0), "cpu")
    losses = []
    for _ in range(LEARN_STEPS):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
    return losses


def _decode(world=None):
    """A tied Gemma3 ``Server`` under "dmodel" (at model 2 on ``world``):
    a prefill of 2 x 12 tokens into a 16-row cache and 3 teacher-forced
    decode steps; each step's logits (the vocabulary whole) and greedy
    tokens, and the embedding's model dimension."""
    cfg = _cfg(GEMMA)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    server = Server(cfg, params, device="cpu", world=world,
                    model_axis=2 if world is not None else 1,
                    embed_sharding="dmodel")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 15)))
    cache = server.init_cache(2, 16, torch.float32)
    last, cache = server.prefill({"tokens": tokens[:, :12]}, cache)
    logits, greedy = [last[:, 0]], []
    for i in range(12, 15):
        step, cache = server.decode_logits(cache, tokens[:, i:i + 1], i)
        logits.append(step[:, 0])
        greedy.append(step[:, -1].argmax(-1))
    return {"logits": torch.stack(logits, 1).numpy(),
            "tokens": torch.stack(greedy, 1).numpy(),
            "embed_dim": server.model_dims["embed.tok"]}


def _bf16(world=None):
    """Tied Gemma3 in bf16 (the compute dtype the program trains in)
    under each layout, at model 2 or 4 on ``world`` (one process without):
    the first batch's loss, every gradient gathered whole, and the logits
    gathered whole (rank 0's)."""
    cfg = configs.get_smoke_config(GEMMA).replace(dtype="bfloat16")
    model = 1 if world is None else world.size
    out = {}
    for embed in ("vocab", "dmodel"):
        trainer = Trainer(cfg, _ecfg(GEMMA, embed), device="cpu",
                          world=world, model_axis=model)
        state = trainer.init_state(transformer.init_params(cfg, seed=0,
                                                           device="cpu"))
        batch = _batch(cfg, 0)
        grads, m = trainer.grads(state.params, batch)
        with torch.no_grad(), trainer.group_context():
            logits, _ = transformer.forward(cfg, state.params, batch)
            if logits.shape[-1] != cfg.vocab_size:
                logits = shardctx.gather_from_model(logits)
        grads = _numpy({k: g.float() for k, g in
                        trainer.model_whole(grads).items()})
        first = world is None or world.rank == 0
        out[embed] = {"loss": float(m["loss"]),
                      "grads": grads if first else None,
                      "logits": logits.float().numpy() if first else None}
    return out


# the jobs whose one training step's collective bytes a gloo world and a
# recording world count: (arch, embed) at model 2
COUNT_JOBS = [(arch, embed) for arch in (QWEN, GEMMA)
              for embed in ("vocab", "dmodel")]


def _step_counts(job, world):
    """The collective bytes by kind of one training step of ``job`` on
    ``world`` (after the layout's own first collectives)."""
    arch, embed = job
    device = world.device.type
    cfg = _cfg(arch)
    trainer = Trainer(cfg, _ecfg(arch, embed,
                                 guard_anomalies=device != "meta"),
                      device=device, world=world, model_axis=2)
    state = trainer.init_state(transformer.init_params(cfg, device=device))
    batch = _batch(cfg, 0)
    if device == "meta":
        batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                 for k, v in batch.items()}
    reset_collectives()
    trainer.train_step(state, batch)
    return count_collectives()


def _run_jobs(world, lay, root):
    # the world of 4 runs the pipe 2 x model 2 case too
    out = {case: _case(world, case) for case in CASES
           if case[1] == lay or lay == "m4" and case[1] == "pp2-m2"}
    if lay in ("m2", "m4"):
        out["bf16"] = _bf16(world)
    if lay == "m2":
        out["learn"] = _learn(world)
        out["decode"] = _decode(world)
        out["counts"] = {job: _step_counts(job, world) for job in COUNT_JOBS}
    if lay == "m4":
        out["ulysses"] = _ulysses(world)
        out["ckpt"] = _checkpoints(world, root)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{layout: [each rank's results]}: the worlds of 2, 4 and 3 side by
    side (the world of 4 runs model 4, then pipe 2 x model 2)."""
    root = str(tmp_path_factory.mktemp("embed-dmodel-ckpt"))
    plan = {"m2": 2, "m4": 4, "m3": 3}
    with concurrent.futures.ThreadPoolExecutor(len(plan)) as pool:
        runs = {lay: pool.submit(distributed.spawn, _run_jobs, size, lay,
                                 root, device="cpu", deadline_s=DEADLINE_S,
                                 timeout_s=60)
                for lay, size in plan.items()}
        out = {lay: run.result() for lay, run in runs.items()}
    # the pipe job ran in the world of 4
    out["pp2-m2"] = out["m4"]
    out["root"] = root
    return out


@pytest.fixture(scope="module")
def one_process():
    """{arch: one process's first-step gradients, losses, grad norms and
    params after two steps}."""
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = _cfg(arch)
        trainer = Trainer(cfg, _ecfg(arch), device="cpu")
        params = transformer.init_params(cfg, seed=0, device="cpu")
        out[arch] = {"init": _numpy(params)}
        state = trainer.init_state(params)
        out[arch]["grads"] = _first_grads(trainer, state)
        for i in range(STEPS):
            if i == 2:
                out[arch]["params"] = _numpy(state.params)
            state, m = trainer.train_step(state, _batch(cfg, i))
            out[arch].setdefault("losses", []).append(float(m["loss"]))
            out[arch].setdefault("gnorms", []).append(
                float(m["grad_norm"]))
    return out


# --- the reference ------------------------------------------------------------

def _nest(flat):
    """Flat dotted keys -> the reference's nested param tree."""
    import jax.numpy as jnp
    tree = {}
    for key, value in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = jnp.asarray(value)
    return tree


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch):
    import jax
    from repro import configs as ref_configs
    from repro.models import transformer as ref_model
    rcfg = ref_configs.get_smoke_config(arch).replace(**_fields(arch))
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(rcfg, p, b)[0]))


def _ref_step(arch, params, step):
    """The reference's loss and gradients of batch ``step`` at ``params``
    (numpy, flat), as the port's accumulation takes them: the mean over
    its ACCUM microbatches of contiguous rows."""
    tree = _nest(params)
    tokens = concrete_batch(_cfg(arch), BATCH, SEQ, seed=step)["tokens"]
    rows = BATCH // ACCUM
    loss, grads = 0.0, {}
    for i in range(ACCUM):
        value, g = _ref_value_and_grad(arch)(
            tree, {"tokens": tokens[i * rows:(i + 1) * rows]})
        loss += float(value) / ACCUM
        for k, v in _flat(g).items():
            grads[k] = grads.get(k, 0.0) + np.asarray(v) / ACCUM
    return loss, grads


def _flat(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat(leaf, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = leaf
    return out


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=err_msg)


# --- the dims against the reference's specs ------------------------------------

def _differ(arch, axes, extents, model, embed, **kw):
    """The leaves whose model or (ZeRO-3, and optimizer-state at stages 1
    and 2) data dimension differs from the reference's ``param_specs(...,
    embed_sharding=embed)``, and the port's ``embed.tok`` dims."""
    from test_torch_tp import _axis_dim, _ref_specs
    want, port, cfg = _ref_specs(arch, axes, extents,
                                 embed_sharding=embed, **kw)
    got = model_dims(port, cfg, model, embed)
    data = {z: shard_dims(port, zero_stage=z, world=extents[0],
                          for_opt_state=z < 3, embed_sharding=embed)
            for z in (1, 2, 3)}
    differ = set()
    for k, spec in want.items():
        for z in (1, 2, 3):
            assert data[z][k] == _axis_dim(spec, "data"), (k, z)
        if "pipe" in axes:
            assert _axis_dim(spec, "pipe") == (0 if is_stacked(k) else None)
        if got[k] != _axis_dim(spec, "model"):
            # the port keeps whole what the reference splits (D6, D7, F2)
            assert got[k] is None, k
            differ.add(k)
    return differ, (got["embed.tok"], data[3]["embed.tok"])


@pytest.mark.parametrize("arch", DECODERS)
@pytest.mark.parametrize("m", [2, 4, 16])
def test_dims_match_reference_specs(arch, m):
    """On a data 2 x model M mesh ``embed.tok`` is ``(None, "model")``
    (model on its columns, no data split at ZeRO-3 or for the optimizer
    state at 1 and 2), as the reference's spec, where "vocab" has it
    ``("model", "data")``; every other leaf's dims are "vocab"'s, so the
    port differs from the reference on the same leaves in both layouts."""
    mesh = (("data", "model"), (2, m))
    differ, embed = _differ(arch, *mesh, m, "dmodel")
    vocab_differ, vocab_embed = _differ(arch, *mesh, m, "vocab")
    assert differ == vocab_differ and "embed.tok" not in differ
    assert embed == (1, None)
    vocab = configs.get_config(arch).vocab_size
    assert vocab_embed == ((0 if vocab % m == 0 else None), 1)


@pytest.mark.parametrize("arch", PIPE_DECODERS)
def test_pipe_dims_match_reference_specs(arch):
    """On the data 2 x pipe 2 x model 2 mesh too (``pipeline_axis``)."""
    mesh = (("data", "pipe", "model"), (2, 2, 2))
    differ, embed = _differ(arch, *mesh, 2, "dmodel",
                            pipeline_axis="pipe")
    assert not differ and embed == (1, None)


def test_layouts_are_refused_but_vocab_and_dmodel():
    """R7: the reference reads any value other than "vocab" as "dmodel";
    the port refuses it, in ``EngineConfig`` and in ``Server``."""
    assert EngineConfig().embed_sharding == "vocab"
    assert EngineConfig(embed_sharding="dmodel").embed_sharding == "dmodel"
    for bad in ("DMODEL", "dmodel ", ""):
        with pytest.raises(ValueError, match="embed_sharding must be one"):
            EngineConfig(embed_sharding=bad)
        with pytest.raises(ValueError, match="embed_sharding must be one"):
            Server(_cfg(GEMMA), {}, device="cpu", embed_sharding=bad)


def test_whole_where_the_model_axis_does_not_divide_d():
    """d_model 256 (Gemma3's smoke config) at model 3: ``embed.tok``
    stays whole, as the reference's ``_sanitize`` leaves it."""
    cfg = _cfg(GEMMA)
    shapes = {k: t.shape for k, t in transformer.init_params(
        cfg, device="meta").items()}
    assert model_dims(shapes, cfg, 3, "dmodel")["embed.tok"] is None
    assert model_dims(shapes, cfg, 2, "dmodel")["embed.tok"] == 1


# --- training against one process and the reference ----------------------------

@pytest.mark.parametrize("case", CASES, ids=_name)
def test_training_matches_one_process(case, worlds, one_process):
    """Losses and grad norms within 3e-4 of one process's and the same on
    every rank; the whole params after two steps within 3e-4; every
    leaf's first-step gradient, gathered whole, within 3e-4 (the same on
    every rank); ``embed.tok`` split on its columns (whole at model 3);
    the tied heads' logits whole, the untied ones vocab-sharded; the
    leaves summed over the group those "vocab" sums (the MoE routers,
    D6's KV projections), never ``embed.tok``."""
    arch, lay = case
    ranks = [r[case] for r in worlds[lay]]
    want = one_process[arch]
    model = LAYOUTS[lay][3]
    for r in ranks:
        _close(r["losses"], want["losses"], "losses")
        _close(r["gnorms"], want["gnorms"], "grad norms")
        assert r["losses"] == ranks[0]["losses"]
        assert r["grad_sums"] == ranks[0]["grad_sums"]
        assert r["embed_dim"] == (None if lay == "m3" else 1)
    got = ranks[0]
    for k, p in got["params"].items():
        assert p.shape == want["params"][k].shape, k
        _close(p, want["params"][k], k)
    for k, g in got["grads"].items():
        _close(g, want["grads"][k], k)
    if got["width"] is not None:
        vocab = _cfg(arch).vocab_size
        tied = arch in TIED or lay == "m3"
        assert got["width"] == (vocab if tied else vocab // model)
    cfg = _cfg(arch)
    assert set(got["summed"]) == {
        k for k in want["grads"] if model_summed(k, cfg, model)}
    assert "embed.tok" not in got["summed"]


@pytest.mark.parametrize("lay", ["m2", "m4"])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_training_matches_reference(arch, lay, worlds, one_process):
    """The world's first-step loss and every gradient, gathered whole,
    within 3e-4 of the reference's ``jax.value_and_grad(loss_fn)`` on the
    same seed-0 params (the mean over the microbatches), and its third
    step's loss within 3e-4 of the reference's ``loss_fn`` at the world's
    own params after two steps."""
    got = worlds[lay][0][(arch, lay)]
    loss, grads = _ref_step(arch, one_process[arch]["init"], 0)
    _close(got["losses"][0], loss, "first loss")
    assert set(grads) == set(got["grads"])
    for k, g in grads.items():
        _close(got["grads"][k], g, k)
    loss2, _ = _ref_step(arch, got["params"], 2)
    _close(got["losses"][2], loss2, "third loss")


def test_ulysses_ignores_the_layout(worlds):
    """Under Ulysses (D8) every leaf is whole on the model group: at data
    2 x model 2 under ZeRO-3 "dmodel" keeps "vocab"'s layout of
    ``embed.tok`` (no model split, its data split on the columns), and
    its losses, grad norms and params after three steps are "vocab"'s,
    bitwise, on every rank."""
    for r in worlds["m4"]:
        u = r["ulysses"]
        assert u["dmodel"]["dims"] == u["vocab"]["dims"] == (None, 1)
        assert u["dmodel"]["losses"] == u["vocab"]["losses"]
        assert u["dmodel"]["gnorms"] == u["vocab"]["gnorms"]
        for k, p in u["vocab"]["params"].items():
            np.testing.assert_array_equal(u["dmodel"]["params"][k], p, k)


def test_training_still_learns(worlds):
    """The reference's ``test_perf_option_training_still_learns[opt1]``:
    12 steps of Qwen2.5's fp32 smoke config on a fixed batch under
    "dmodel" take the loss down by more than 0.05, at world 1 and on
    every rank at model 2 (the same losses within 3e-4)."""
    one = _learn()
    for losses in [one] + [r["learn"] for r in worlds["m2"]]:
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0] - 0.05, losses
        _close(losses, one, "model 2 against world 1")


# --- checkpoints across the two layouts ----------------------------------------

def test_checkpoint_restores_across_layouts(worlds):
    """At data 2 x model 2 under ZeRO-3, a step written under "vocab" and
    restored under "dmodel", and the reverse: every param and moment,
    gathered whole, bitwise the writer's; the next step within 1e-5 of
    the writer's own uninterrupted step. The manifests' specs follow the
    layout: ``embed.tok`` ``["model", "data"]`` under "vocab", ``[None,
    "model"]`` under "dmodel"."""
    for r in worlds["m4"]:
        for (wrote, read), got in r["ckpt"].items():
            assert got["step"] == 2 and got["bitwise"], (wrote, read)
            loss, gnorm = got["writer"]
            assert abs(got["losses"][0] - loss) <= RESUME_TOL
            assert abs(got["gnorms"][0] - gnorm) <= RESUME_TOL
    want = {"vocab": ["model", "data"], "dmodel": [None, "model"]}
    for embed, spec in want.items():
        path = os.path.join(worlds["root"], embed, "step_00000002",
                            "manifest.json")
        with open(path) as f:
            leaves = json.load(f)["leaves"]
        for key in ("params/embed/tok", "opt_state/mu/embed/tok",
                    "opt_state/nu/embed/tok"):
            assert leaves[key]["spec"] == spec, (embed, key)


# --- bf16 ----------------------------------------------------------------------

def test_tied_head_in_bf16_drifts_no_further_than_vocab(worlds):
    """Tied Gemma3 in bf16 at model 2 and 4: the row-parallel head's
    partial logits summed in fp32 and rounded once, "dmodel"'s logits,
    loss and gradients lie as close to one process's as "vocab"'s do. Each
    layout against one process: the logits within 2^-6 of their largest
    magnitude (two bf16 steps), the loss within 1e-3, every gradient's
    cosine at least 0.9995 and its largest difference within 3e-2 of its
    largest magnitude; and "dmodel"'s largest logit and gradient
    differences at most 1.25 times "vocab"'s."""
    one = _bf16()
    for lay in ("m2", "m4"):
        got = worlds[lay][0]["bf16"]
        drift = {}
        for embed in ("vocab", "dmodel"):
            want, run = one[embed], got[embed]
            scale = np.abs(want["logits"]).max()
            d_logits = np.abs(run["logits"] - want["logits"]).max() / scale
            assert d_logits <= 2 ** -6, (lay, embed, d_logits)
            assert abs(run["loss"] - want["loss"]) <= 1e-3, (lay, embed)
            d_grads = 0.0
            for k, g in want["grads"].items():
                h = run["grads"][k]
                cos = float((g * h).sum() / (np.linalg.norm(g)
                                             * np.linalg.norm(h)))
                d = np.abs(h - g).max() / np.abs(g).max()
                assert cos >= 0.9995 and d <= 3e-2, (lay, embed, k, cos, d)
                d_grads = max(d_grads, d)
            drift[embed] = (d_logits, d_grads)
            # the readings, shown with ``pytest -s``
            print(f"bf16 {lay} {embed}: logits {d_logits:.3e} of their "
                  f"largest magnitude, loss "
                  f"{abs(run['loss'] - want['loss']):.3e}, largest gradient "
                  f"difference {d_grads:.3e}")
        assert drift["dmodel"][0] <= 1.25 * drift["vocab"][0], (lay, drift)
        assert drift["dmodel"][1] <= 1.25 * drift["vocab"][1], (lay, drift)


# --- serving ---------------------------------------------------------------------

def test_tied_server_decode_matches_one_rank(worlds):
    """A tied Gemma3 ``Server`` at model 2 under "dmodel" (each rank its
    feature columns of ``embed.tok``, the head a row-parallel product):
    the prefill's and each decode step's logits, whole, within 3e-4 of
    one rank's, and the same greedy tokens, on both ranks."""
    want = _decode()
    for r in worlds["m2"]:
        got = r["decode"]
        assert got["embed_dim"] == 1
        _close(got["logits"], want["logits"], "logits")
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


# --- the collective bytes and the dry run ------------------------------------------

@pytest.mark.parametrize("job", COUNT_JOBS, ids=_name)
def test_recording_world_counts_what_a_gloo_world_does(job, worlds):
    for rank in range(2):
        want = worlds["m2"][rank]["counts"][job]
        got = _step_counts(job, recording_world(rank, 2))
        assert got == want, (rank, got, want)


@pytest.mark.parametrize("arch", [QWEN, GEMMA])
def test_collective_bytes_follow_the_formula(arch, worlds):
    """One training step at model 2 (ACCUM microbatches of B rows, S
    positions, fp32): "dmodel" all-gathers the lookup's (B, S, d) rows
    where "vocab" all-reduces them; a tied head all-reduces its (B, S, V)
    logits where "vocab"'s NLL all-reduces three (B, S) fp32 rows (the
    maximum, the sum of exponentials, the gold logit). Nothing else
    moves differently."""
    counts = worlds["m2"][0]["counts"]
    vocab, dmodel = counts[arch, "vocab"], counts[arch, "dmodel"]
    cfg = _cfg(arch)
    b, s, el = BATCH // ACCUM, SEQ, 4
    rows = ACCUM * b * s * cfg.d_model * el
    head = ACCUM * (b * s * cfg.vocab_size * el - 3 * b * s * 4) \
        if cfg.tie_embeddings else 0
    delta = {k: dmodel[k] - vocab[k] for k in vocab}
    assert delta == dict(dict.fromkeys(vocab, 0), **{
        "all-gather": rows, "all-reduce": head - rows})


def test_dryrun_records_the_layout():
    """``launch/dryrun.py --embed dmodel`` counts the "dmodel" layout and
    says so: Gemma3-12B's decode_32k pair (a tied head at model 16) all-
    gathers the lookup's features and all-reduces the whole logits, where
    "vocab" all-reduces the lookup and all-gathers the vocabulary;
    ``tools/profile_pair.py --embed dmodel`` runs."""
    from repro_torch.launch.dryrun import parse_args, run_pair
    from repro_torch.tools import profile_pair
    assert parse_args(["--embed", "dmodel"]).embed == "dmodel"
    with pytest.raises(SystemExit):
        parse_args(["--embed", "Dmodel"])
    recs = {e: run_pair(GEMMA, "decode_32k", embed=e, verbose=False)
            for e in (None, "dmodel")}
    assert recs[None]["embed"] == "vocab"
    assert recs["dmodel"]["embed"] == "dmodel"
    assert recs["dmodel"]["options"]["embed"] == "dmodel"
    cfg = configs.get_config(GEMMA)
    # decode_32k's batch over the 16 data ranks
    b = configs.get_shape("decode_32k").global_batch // 16
    lookup = b * cfg.d_model
    logits = b * cfg.vocab_size
    vocab, dmodel = (recs[e]["collectives"] for e in (None, "dmodel"))
    # the lookup: fp32 rows all-reduced under "vocab", bf16 rows
    # all-gathered under "dmodel"; the head's logits all-gathered whole in
    # bf16 under "vocab", their partials all-reduced in fp32 under
    # "dmodel"
    assert vocab["all-reduce"] - 4 * lookup == dmodel["all-reduce"] - \
        4 * logits
    assert vocab["all-gather"] - 2 * logits == dmodel["all-gather"] - \
        2 * lookup
    assert profile_pair.main(["--arch", GEMMA, "--shape", "decode_32k",
                              "--embed", "dmodel", "--n", "3"]) == 0
