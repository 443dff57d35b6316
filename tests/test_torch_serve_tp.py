"""Port parity for serving across ranks (``engine.Server(world=,
model_axis=)``, ``launch/serve.py --devices/--model-axis``): gloo worlds
of 2 (model axis 2), 4 (model axis 4; data 2 x model 2) and 8 (data 2 x
model 4, the reference's ``test_decode_sharded_cache`` case: qwen2.5
smoke, batch 4, a 32-token prompt, 8 decode steps), each rank serving
its rows and heads from a cache split by ``core/sharding.py::cache_dims``
(ROADMAP deviation D9; MLA's latents on the sequence, as the reference's
``cache_specs``, decoded as a distributed flash-decoding). DeepSeek-V3
also runs with a cache 4x its prompt at model 4 (decode writes on rank 1,
ranks 2-3 hold no live row) and at an odd cache length at model 2 (the
latents whole); ``shardctx.combine_softmax`` is held against one whole
softmax in one process, its ranks as threads.

For every decoder family's smoke config in fp32 (MoE at capacity factor
8, DeepSeek-V3 without its MTP head, RWKV6 at the group norm's eps 1e-3,
Qwen2-VL with image embeddings and an M-RoPE grid), prefill a prompt and
run teacher-forced decode steps; the prefill's last logits and every
step's, gathered whole over the vocabulary and the data ranks, are held
against the port's one-process decode within 3e-4 (the reference's
tensor-parallel bound, ``tests/test_engine_distributed.py:92-101``) and
against the reference's ``forward(mode="train")`` on the same params
within 5e-4 (``tests/test_arch_smoke.py:80-85``). ``cache_dims`` is held
against the reference's ``cache_specs``; the serve CLI across ranks
against its one-process run. The spawned ranks import this module, so it
imports no JAX at module level.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import concurrent.futures  # noqa: E402
import dataclasses  # noqa: E402
import threading  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.engine import Server, greedy  # noqa: E402
from repro_torch.core.sharding import cache_dims, cache_shape, \
    check_serving, serving_rows, whole_blocks  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import shardctx, transformer  # noqa: E402
from repro_torch.models.attention import NEG_INF  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TP_TOL, TRAIN_TOL, GAP = 3e-4, 5e-4, 1e-4
DEADLINE_S = 240
ARCHS = ("qwen2.5-14b", "chatglm3-6b", "gemma3-12b", "granite-moe-3b-a800m",
         "deepseek-v3-671b", "qwen2-vl-72b", "rwkv6-7b", "zamba2-2.7b")
QWEN = "qwen2.5-14b"
DEEPSEEK = "deepseek-v3-671b"
# layout -> (data ranks, model ranks); "m4-long" a cache of 4x the prompt
# (96 rows), "m2-odd" one of 27 rows, which 2 does not divide
LAYOUTS = {"m2": (1, 2), "m4": (1, 4), "dp2-m2": (2, 2), "dp2-m4": (2, 4),
           "dp2-b3": (2, 1), "m4-long": (1, 4), "m2-odd": (1, 2)}
# every family at model 2; model 4 where the smoke heads allow it (D6: one
# KV head a rank); data 2 x model 2; the reference's own case; a batch of 3
# over data 2 (F2: every data rank serves every row); DeepSeek-V3's split
# latents at model 4, data 2 x model 2, with ranks that hold no live row,
# and whole at an odd cache length
CASES = [(a, "m2") for a in ARCHS] + \
    [(a, "m4") for a in (QWEN, "chatglm3-6b", "gemma3-12b")] + \
    [(QWEN, "dp2-m2"), (QWEN, "dp2-m4"), (QWEN, "dp2-b3")] + \
    [(DEEPSEEK, lay) for lay in ("m4", "dp2-m2", "m4-long", "m2-odd")]
# world size -> the layouts its ranks serve in turn
WORLDS = {2: ("m2", "dp2-b3", "m2-odd"), 4: ("m4", "dp2-m2", "m4-long"),
          8: ("dp2-m4",)}
# prompts past gemma3's smoke window of 64 and across zamba2's SSD chunks
# of 32
PROMPT = {"gemma3-12b": 72, "zamba2-2.7b": 70}
N_IMG = 8


def _name(case):
    return "-".join(case)


def _shape(arch, lay):
    """(batch, prompt tokens, decode steps) of a case."""
    if lay == "dp2-m4":
        return 4, 32, 8
    if lay == "dp2-b3":
        return 3, 24, 4
    if lay == "m2-odd":
        return 2, 24, 3
    return (4 if lay == "dp2-m2" else 2), PROMPT.get(arch, 24), 4


def _max_len(arch, lay):
    """The cache's rows: 4x the prompt for "m4-long", else the prompt and
    the decode steps."""
    _, s, steps = _shape(arch, lay)
    return 4 * s if lay == "m4-long" else s + steps


def _cfg(arch, ref=False):
    """fp32, no MTP head, MoE at capacity factor 8, RWKV6 at eps 1e-3 (the
    port's config, or the reference's with ``ref``)."""
    if ref:
        from repro import configs as ref_configs
        cfg = ref_configs.get_smoke_config(arch)
    else:
        cfg = configs.get_smoke_config(arch)
    cfg = cfg.replace(dtype="float32", mtp_depth=0)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    if cfg.block_kind == "rwkv6":
        cfg = cfg.replace(norm_eps=1e-3)
    return cfg


def _params(arch):
    """{dotted key: numpy array}: the port's smoke init (seed 1), the norm
    scales perturbed with numpy noise."""
    flat = {k: v.numpy().copy() for k, v in transformer.init_params(
        _cfg(arch), seed=1, device="cpu").items()}
    rng = np.random.default_rng(3)
    for key, leaf in flat.items():
        if key.endswith(("scale", "q_norm", "kv_norm")):
            leaf += rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    return flat


def _batch(arch, batch, n):
    """numpy tokens (batch, n) and, for the vlm, N_IMG image embeddings
    and an M-RoPE grid: the image a 2 x 4 patch grid at t 0, then text at
    its index in every section (as decode rotates it)."""
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, 512, (batch, n)).astype(np.int32)}
    if arch == "qwen2-vl-72b":
        i = np.arange(N_IMG)
        img = np.stack([np.zeros_like(i), i // 4, i % 4], -1)
        text = np.repeat(np.arange(N_IMG, n)[:, None], 3, -1)
        out["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.concatenate([img, text])[None], (batch, n, 3))).astype(
                np.int32)
        out["image_embeds"] = rng.standard_normal(
            (batch, N_IMG, _cfg(arch).d_model)).astype(np.float32)
    return out


def _decode(arch, lay, world=None):
    """Prefill, then teacher-forced decode steps through ``Server`` on
    ``world`` (one process without): (the prefill's last logits and each
    step's, whole over the vocabulary and the data ranks (B, steps + 1,
    vocab), {group/leaf: this rank's cache shape})."""
    batch, s, steps = _shape(arch, lay)
    model = LAYOUTS[lay][1] if world is not None else 1
    cfg = _cfg(arch)
    server = Server(cfg, params_from_numpy(_params(arch)), device="cpu",
                    world=world, model_axis=model)
    full = _batch(arch, batch, s + steps)
    cache = server.init_cache(batch, _max_len(arch, lay), torch.float32)
    prompt = {k: v[:, :s] if k != "image_embeds" else v
              for k, v in full.items()}
    last, cache = server.prefill(prompt, cache)
    out = [last[:, 0]]
    for i in range(steps):
        tok = torch.from_numpy(full["tokens"][:, s + i:s + i + 1])
        logits, cache = server.decode_logits(cache, tok, s + i)
        out.append(logits[:, 0])
    logits = server.gather_rows(torch.stack(out, 1))
    return logits.numpy(), {f"{g}/{k}": tuple(v.shape)
                            for g, leaves in cache.items()
                            for k, v in leaves.items()}


def _run_jobs(world, layouts):
    return {case: _decode(*case, world) for lay in layouts
            for case in CASES if case[1] == lay}


@pytest.fixture(scope="module")
def worlds():
    """{world size: a future of [each rank's {case: results}]}: the three
    worlds side by side, started once; a test waits for its world."""
    pool = concurrent.futures.ThreadPoolExecutor(len(WORLDS))
    runs = {size: pool.submit(distributed.spawn, _run_jobs, size, lays,
                              device="cpu", deadline_s=DEADLINE_S,
                              timeout_s=60)
            for size, lays in WORLDS.items()}
    yield runs
    pool.shutdown(wait=True)


def _world_of(lay):
    return next(size for size, lays in WORLDS.items() if lay in lays)


def _reference(arch, lay):
    """The reference's train-mode logits of the whole sequence at the
    positions the prefill's last row and the decode steps give."""
    import jax.numpy as jnp
    from repro.models import transformer as ref_model
    batch, s, steps = _shape(arch, lay)
    out = {}
    for key, leaf in _params(arch).items():
        *path, name = key.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(leaf)
    full = {k: jnp.asarray(v) for k, v in
            _batch(arch, batch, s + steps).items()}
    logits = ref_model.forward(_cfg(arch, ref=True), out, full,
                               mode="train")[0]
    return np.asarray(logits)[:, s - 1:s + steps]


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_decode_across_ranks_matches_one_process(case, worlds):
    """Every rank's gathered logits within 3e-4 of the one-process
    decode's and within 5e-4 of the reference's train-mode logits; every
    rank of the world the same logits; each rank's cache leaves of the
    shapes ``cache_dims`` gives."""
    arch, lay = case
    data, model = LAYOUTS[lay]
    data = serving_rows(_shape(arch, lay)[0], data)
    one, whole = _decode(arch, lay)
    want = _reference(arch, lay)
    assert one.shape == want.shape
    np.testing.assert_allclose(one, want, atol=TRAIN_TOL, rtol=0)
    ranks = worlds[_world_of(lay)].result()
    cfg = _cfg(arch)
    shapes = {}
    for key, shape in whole.items():
        g, k = key.split("/")
        shapes.setdefault(g, {})[k] = shape
    dims = cache_dims(cfg, shapes, data, model)
    for rank, res in enumerate(ranks):
        got, shapes = res[case]
        np.testing.assert_allclose(got, one, atol=TP_TOL, rtol=0,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(got, want, atol=TRAIN_TOL, rtol=0,
                                   err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got, ranks[0][case][0])
        for key, shape in shapes.items():
            g, k = key.split("/")
            assert shape == cache_shape(cfg, k, whole[key], dims[g][k],
                                        data, model), key


def test_caches_split_heads_on_the_model_axis(worlds):
    """The per-rank cache shapes: the attention's KV heads split (or one
    KV head a rank under D6; D9), MLA's latents split on the sequence
    where the model axis divides the rows and whole where it does not, the
    RWKV6 shifts whole, the WKV and SSD states' heads split, the conv
    state the x channels of the rank's heads and the B and C channels
    whole; the data ranks' rows."""
    got = worlds[2].result()[0]
    wq = {a: got[a, "m2"][1] for a in ARCHS}
    assert wq[QWEN]["layers/k"] == (2, 2, 28, 1, 32)     # KH 2 / M 2
    mla = _cfg(DEEPSEEK).mla
    assert wq[DEEPSEEK]["dense/c_kv"][2:] == \
        ((24 + 4) // 2, mla.kv_lora_rank)
    assert wq[DEEPSEEK]["moe/k_rope"][2:] == (14, mla.qk_rope_head_dim)
    assert got[DEEPSEEK, "m2-odd"][1]["dense/c_kv"][2:] == \
        (24 + 3, mla.kv_lora_rank)
    assert wq["rwkv6-7b"]["layers/wkv"] == (2, 2, 2, 32, 32)
    assert wq["rwkv6-7b"]["layers/att_shift"] == (2, 2, 128)
    z = _cfg("zamba2-2.7b")
    d_in, n = z.ssm.expand * z.d_model, z.ssm.state_dim
    assert wq["zamba2-2.7b"]["mamba/conv"] == \
        (4, 2, z.ssm.conv_kernel - 1, d_in // 2 + 2 * n)
    assert wq["zamba2-2.7b"]["mamba/ssd"][2] == d_in // z.ssm.head_dim // 2
    m4 = worlds[4].result()[0]
    assert m4[QWEN, "m4"][1]["layers/k"] == (2, 2, 28, 1, 32)   # D6
    assert m4[DEEPSEEK, "m4"][1]["moe/c_kv"][2] == 28 // 4
    assert m4[DEEPSEEK, "m4-long"][1]["moe/c_kv"][2] == 96 // 4
    assert m4[DEEPSEEK, "dp2-m2"][1]["dense/c_kv"][1:3] == (2, 14)
    assert m4[QWEN, "dp2-m2"][1]["layers/k"] == (2, 2, 28, 1, 32)
    d8 = worlds[8].result()[0][QWEN, "dp2-m4"][1]["layers/k"]
    assert d8 == (2, 2, 40, 1, 32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("data,model", [(2, 2), (1, 4), (2, 4)])
def test_cache_dims_match_reference_specs(arch, data, model):
    """Against ``repro.core.sharding.cache_specs`` on a duck-typed data x
    model mesh: every leaf's batch on the data axis; the WKV and SSD
    states' heads and MLA's latents' sequence on the model axis as there;
    the leaves the reference splits on the sequence (``k``/``v``) or by
    contiguous channels (``conv``) are D9's differences, each named."""
    import jax
    import jax.numpy as jnp
    from repro.core import sharding as ref_sharding
    from repro.models import transformer as ref_model
    cfg = _cfg(arch)
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty((data, model)))
    shapes = jax.eval_shape(lambda: ref_model.init_cache(
        _cfg(arch, ref=True), 4, 16, dtype=jnp.float32))
    specs = ref_sharding.cache_specs(_cfg(arch, ref=True), shapes, mesh)
    mine = cache_dims(cfg, {g: {k: tuple(v.shape) for k, v in leaves.items()}
                            for g, leaves in shapes.items()}, data, model)
    for group, leaves in shapes.items():
        for key in leaves:
            spec = tuple(specs[group][key])
            batch, m, why = mine[group][key]
            assert spec[batch] in (("data",), "data"), (group, key, spec)
            if key in ("wkv", "ssd"):
                assert m == 2 and spec[2] == "model" and why is None
            elif key in ("k", "v"):
                assert spec[2] == "model"         # the reference's sequence
                if cfg.num_kv_heads % model:
                    assert m is None and why.startswith("D6")
                else:
                    assert m == 3 and why is None
            elif key in ("c_kv", "k_rope"):
                assert spec[2] == "model" and m == 2 and why is None
            elif key == "conv":
                assert m is None and why.startswith("D7")
            else:
                assert "model" not in spec and m is None and \
                    why.startswith("a shift")


@pytest.mark.parametrize("data,model,rows", [(1, 4, 18), (2, 2, 27),
                                              (1, 8, 16), (2, 4, 20)])
def test_latents_whole_where_the_model_axis_does_not_split_them(
        data, model, rows):
    """DeepSeek-V3's latents stay whole on every model rank, with the
    ``why``, where the model axis does not divide the cache's rows (the
    reference's ``_sanitize`` replicates them too) or where the attention
    runs whole (the smoke's 4 heads at model 8: F2; the reference keeps
    its sequence split, D10); split on the sequence otherwise."""
    import jax
    import jax.numpy as jnp
    from repro.core import sharding as ref_sharding
    from repro.models import transformer as ref_model
    cfg = _cfg(DEEPSEEK)
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty((data, model)))
    shapes = jax.eval_shape(lambda: ref_model.init_cache(
        _cfg(DEEPSEEK, ref=True), 4, rows, dtype=jnp.float32))
    specs = ref_sharding.cache_specs(_cfg(DEEPSEEK, ref=True), shapes, mesh)
    mine = cache_dims(cfg, {g: {k: tuple(v.shape) for k, v in leaves.items()}
                            for g, leaves in shapes.items()}, data, model)
    whole_attn = "attn" in whole_blocks(cfg, model)
    for group, leaves in shapes.items():
        for key in ("c_kv", "k_rope"):
            spec = tuple(specs[group][key])
            _, m, why = mine[group][key]
            ref_split = spec[2] == "model"
            assert ref_split == (rows % model == 0)
            if whole_attn:
                assert m is None and why.startswith("F2")
            elif rows % model:
                assert m is None and why == (
                    f"MLA: the latents whole, {model} model ranks do not "
                    f"divide {rows} rows")
            else:
                assert m == 2 and why is None
            assert cache_shape(cfg, key, tuple(leaves[key].shape),
                               mine[group][key], data, model)[2] == \
                (rows // model if m == 2 else rows)


class _ThreadRank:
    """Rank ``rank`` of ``size`` ranks run as threads of one process: each
    collective hands its input to the shared slots, waits for every rank
    and computes the result from all of them."""

    def __init__(self, rank, shared):
        self.rank, self.size, self.shared = rank, len(shared["slots"]), \
            shared

    def _all(self, x):
        slots, barrier = self.shared["slots"], self.shared["barrier"]
        slots[self.rank] = x
        barrier.wait()
        got = list(slots)
        barrier.wait()
        return got

    def all_reduce(self, t, op):
        got = self._all(t.clone())
        t.copy_(torch.stack(got).amax(0) if op == "max"
                else torch.stack(got).sum(0))
        return t

    def reduce_scatter_many(self, ts, dims):
        got = self._all([t.clone() for t in ts])
        return [sum(g[i].chunk(self.size, d)[self.rank] for g in got)
                for i, d in enumerate(dims)]

    def all_gather_many(self, xs, dims):
        got = self._all([x.clone() for x in xs])
        return [torch.cat([g[i] for g in got], d)
                for i, d in enumerate(dims)]


@pytest.mark.parametrize("parts", [3, 4])
def test_combine_softmax_equals_one_softmax(parts):
    """One (B, S, H, T) fp32 softmax times values (B, T, R), its T rows
    split into ``parts`` contiguous parts (the first live, the second with
    one live row, the rest fully masked at the finite NEG_INF, as a rank
    past ``cache_index`` is): every rank's partial max, Σ exp and weighted
    sum, merged by ``shardctx.combine_softmax`` with the ranks as threads,
    give each rank's heads of the whole softmax's output within 1e-6.
    Under grad it refuses."""
    rng = np.random.default_rng(parts)
    b, s, h, t, r = 2, 1, 12, 24, 5
    tm = t // parts
    scores = torch.from_numpy(rng.normal(0, 3, (b, s, h, t))
                              .astype(np.float32))
    vals = torch.from_numpy(rng.normal(0, 1, (b, t, r)).astype(np.float32))
    scores = torch.where(torch.arange(t) <= tm, scores, NEG_INF)
    want = torch.einsum("bsht,btr->bshr", torch.softmax(scores, -1), vals)
    shared = {"slots": [None] * parts,
              "barrier": threading.Barrier(parts, timeout=30)}
    got = [None] * parts

    def rank(m):
        with torch.inference_mode():
            part = scores[..., m * tm:(m + 1) * tm]
            mx = part.amax(-1)
            e = torch.exp(part - mx[..., None])
            ctx, den = shardctx.combine_softmax(
                mx, e.sum(-1), torch.einsum("bsht,btr->bshr", e,
                                            vals[:, m * tm:(m + 1) * tm]),
                _ThreadRank(m, shared))
            got[m] = ctx / den[..., None]
    threads = [threading.Thread(target=rank, args=(m,))
               for m in range(parts)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for m in range(parts):
        np.testing.assert_allclose(got[m].numpy(),
                                   want.chunk(parts, 2)[m].numpy(),
                                   atol=1e-6, rtol=0, err_msg=f"rank {m}")
    with pytest.raises(RuntimeError, match="takes no gradient"):
        shardctx.combine_softmax(scores.amax(-1), scores[..., 0],
                                 scores[..., None], _ThreadRank(0, shared))


def test_serve_cli_across_ranks(capfd):
    """``--devices 2 --model-axis 2 --device cpu`` prints the two
    ``[serve]`` lines once (rank 0) and rank 0's cache bytes (2 layers x
    4 rows x 22 positions x KV heads 2 / 2 x 32 x 2 (k, v) x 4 B), and its
    tokens equal the ``--devices 0`` run's at every step whose one-process
    top-2 logit gap exceeds 1e-4 (the skipped steps printed)."""
    argv = ["--arch", QWEN, "--smoke", "--batch", "4", "--prompt-len", "16",
            "--gen", "6", "--device", "cpu"]
    got = serve.main(argv + ["--devices", "2", "--model-axis", "2"])
    out = capfd.readouterr().out
    assert out.count(f"[serve] arch={QWEN}-smoke batch=4 prefill(16 "
                     f"tok)=") == 1
    assert out.count("[serve] sample generations (token ids):") == 1
    cfg = configs.get_smoke_config(QWEN)
    rank_bytes = cfg.num_layers * 4 * 22 * (cfg.num_kv_heads // 2) * \
        cfg.head_dim * 2 * 4
    assert out.count(f"[serve] cache {rank_bytes} bytes a rank (data 1 x "
                     f"model 2; latents split on the sequence: False)") == 1
    want = serve.main(argv)["tokens"]
    assert got["tokens"].shape == want.shape == (4, 6)
    # the one-process run's top-2 gaps at each generated token
    cfg = configs.get_smoke_config(QWEN).replace(dtype="float32")
    server = Server(cfg, transformer.init_params(cfg, seed=0, device="cpu"),
                    device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16),
                                               dtype=np.int32)
    cache = server.init_cache(4, 22, torch.float32)
    logits, cache = server.prefill({"tokens": prompt}, cache)
    gaps = []
    for i in range(6):
        top = logits[:, 0].topk(2, -1).values
        gaps.append((top[:, 0] - top[:, 1]).numpy())
        assert np.array_equal(greedy(logits).numpy()[:, 0], want[:, i])
        if i < 5:
            logits, cache = server.decode_logits(
                cache, torch.from_numpy(want[:, i:i + 1]), 16 + i)
    skipped = []
    for row in range(4):
        for i in range(6):
            if gaps[i][row] <= GAP:
                skipped.append((row, i))
                if got["tokens"][row, i] != want[row, i]:
                    break       # the rest of the row follows another token
                continue
            assert got["tokens"][row, i] == want[row, i], (row, i)
    print(f"steps skipped (row, step) at a top-2 gap <= {GAP}: {skipped}")


@pytest.mark.parametrize("argv,match", [
    (["--devices", "3", "--model-axis", "2"], "not a multiple"),
    (["--model-axis", "4"], "without a world")])
def test_serve_cli_refuses_a_layout(argv, match):
    """Refused before any rank starts: a world that is not a multiple of
    the model axis, a model axis without a world."""
    with pytest.raises(SystemExit, match=match):
        serve.main(["--arch", QWEN, "--smoke", "--device", "cpu"] + argv)


@pytest.mark.parametrize("argv,batch", [
    (["--devices", "3", "--model-axis", "3"], 2),
    (["--devices", "4", "--model-axis", "2"], 3)],
    ids=["model3", "batch3-data2-model2"])
def test_serve_cli_layouts_once_refused_match_one_process(argv, batch):
    """ROADMAP F2, both of the layouts the serve CLI once refused: a model
    axis of 3, which divides none of the smoke Qwen2.5's counts (every
    block runs whole on each model rank), and a batch of 3 over 2 data
    ranks (each data rank serves every row; rank 0's rows are kept): the
    same tokens as one process."""
    base = ["--arch", QWEN, "--smoke", "--device", "cpu", "--batch",
            str(batch), "--prompt-len", "16", "--gen", "5"]
    want = serve.main(base)["tokens"]
    got = serve.main(base + argv)["tokens"]
    assert got.shape == (batch, 5)
    np.testing.assert_array_equal(got, want)


def test_server_and_check_serving_refuse_a_layout():
    """``check_serving`` refuses a model without decode and an empty
    batch; a batch the data ranks do not divide is served whole on each
    (``serving_rows`` 1) and a model axis that divides no count is laid
    out with whole blocks (F2); ``Server`` refuses a model axis without a
    world."""
    cfg = _cfg(QWEN)
    check_serving(cfg, 4, 2, 2)
    check_serving(cfg, 3, 2, 1)
    assert serving_rows(3, 2) == 1 and serving_rows(4, 2) == 2
    with pytest.raises(ValueError, match="no decode step"):
        check_serving(configs.get_smoke_config("vit-b16"), 4, 1, 1)
    with pytest.raises(ValueError, match="a serving batch of 0 rows"):
        check_serving(cfg, 0, 1, 1)
    check_serving(cfg, 4, 1, 3)
    with pytest.raises(ValueError, match="model_axis 2 needs a world"):
        Server(cfg, {}, device="cpu", model_axis=2)
