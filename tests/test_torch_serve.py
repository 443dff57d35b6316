"""Port parity for serving: ``transformer.init_cache``, prefill and greedy
decode through the KV, latent (MLA) and recurrent-state (RWKV6, Mamba2)
caches, Zamba2's shared-block KV cache (one slot a group),
``engine.Server``, the serve CLI and the ``serve_decode`` example.

The reference side is the JAX package's pure functions
(``model.init_cache``, ``model.forward(mode="prefill" / "decode")``),
never ``DistributedEngine``, with ``use_pallas=False`` (caveat R1). Smoke
params are drawn by the port's ``init_params``, the unit norm scales
perturbed by numpy noise, and cross to both sides as numpy (the port's
through ``params_from_numpy``). Tolerances: prefill and decode logits
1e-4 against the reference, every cache leaf 1e-5 absolute plus 1e-5
relative (the WKV state is a sum over the prompt, ~1 in size, whose
summation order differs between the two chunked forms); decode against the
port's own train-mode logits 5e-4, the reference's contract
(``tests/test_arch_smoke.py::test_decode_matches_train_logits``). MoE
configs run at capacity factor 8 there too: prefill counts capacity over
the prompt, training over the whole sequence, so drops would differ. The
CUDA kernels at the prefill shapes are checked on the card by
``chip_smoke.py`` phase 15.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import functools  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.engine import Server, greedy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOGITS_TOL, CACHE_TOL, TRAIN_TOL = 1e-4, 1e-5, 5e-4
B, EXTRA = 2, 4
DECODERS = ("chatglm3-6b", "qwen2.5-14b", "glm4-9b", "gemma3-12b",
            "granite-moe-3b-a800m", "deepseek-v3-671b", "rwkv6-7b",
            "qwen2-vl-72b", "zamba2-2.7b")
# prompt lengths: gemma3's goes past its smoke window of 64, zamba2's
# across two of its smoke SSD chunks of 32
PROMPT = {"gemma3-12b": 72, "zamba2-2.7b": 70}


def _replace(cfg, **kw):
    """fp32, no MTP head, MoE at capacity factor 8 (either package)."""
    cfg = cfg.replace(dtype="float32", mtp_depth=0, **kw)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    return cfg


def _port_cfg(arch, **kw):
    return _replace(configs.get_smoke_config(arch), **kw)


def _nest(flat):
    """{dotted key: array} -> the reference's nested pytree."""
    out = {}
    for key, leaf in flat.items():
        *path, name = key.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


@functools.lru_cache(maxsize=None)
def _params(arch):
    """{dotted key: numpy array}: the port's smoke init, the norm scales
    perturbed."""
    cfg = _port_cfg(arch)
    flat = {k: v.numpy().copy() for k, v in transformer.init_params(
        cfg, seed=1, device="cpu").items()}
    rng = np.random.default_rng(3)
    for key, leaf in flat.items():
        if key.endswith(("scale", "q_norm", "kv_norm")):
            leaf += rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    return flat


def _tokens(arch, seed=0):
    s = PROMPT.get(arch, 24)
    return np.random.default_rng(seed).integers(
        0, 512, (B, s + EXTRA)).astype(np.int32), s


def _flat(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat(leaf, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = leaf
    return out


# --- caches -----------------------------------------------------------------


@pytest.mark.parametrize("arch", DECODERS)
def test_init_cache_matches_reference(arch):
    """Keys, shapes and dtypes of every leaf equal the reference's
    ``init_cache`` (its default bf16, and fp32); all zeros."""
    cfg, ref_cfg = _port_cfg(arch), _replace(
        ref_configs.get_smoke_config(arch))
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        got = _flat(transformer.init_cache(cfg, 3, 20, dtype=tdt,
                                           device="cpu"))
        want = _flat(jax.eval_shape(
            lambda: ref_model.init_cache(ref_cfg, 3, 20, dtype=jdt)))
        assert {k: (tuple(v.shape), str(v.dtype)[6:])
                for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(not v.any() for v in got.values())
    full_cfg = configs.get_config(arch)
    layers = {"layers": full_cfg.num_layers}
    if full_cfg.hybrid_group:       # 54 Mamba2 layers, 9 shared-block uses
        layers = {"mamba": full_cfg.num_layers,
                  "attn": full_cfg.num_layers // full_cfg.hybrid_group}
    if full_cfg.has_moe:
        nd = full_cfg.moe.first_dense_layers
        layers = {"dense": nd, "moe": full_cfg.num_layers - nd}
    full = transformer.init_cache(full_cfg, 1, 8, device="meta")
    assert {g: {v.shape[0] for v in leaves.values()}
            for g, leaves in full.items()} == \
        {g: {n} for g, n in layers.items() if n > 0}


def test_init_cache_refuses_a_model_without_decode():
    with pytest.raises(ValueError, match="no decode step"):
        transformer.init_cache(configs.get_smoke_config("vit-b16"), 1, 8,
                               device="cpu")


# --- prefill and decode against the reference --------------------------------


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "gemma3-12b",
                                  "granite-moe-3b-a800m", "deepseek-v3-671b",
                                  "rwkv6-7b", "zamba2-2.7b"])
def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and every cache leaf, then four decode steps, against
    the reference's ``forward(mode="prefill" / "decode")`` at the same
    params: logits 1e-4, caches 1e-5."""
    ref_cfg = _replace(ref_configs.get_smoke_config(arch))
    cfg = _port_cfg(arch)
    flat = _params(arch)
    params = jax.tree.map(jnp.asarray, _nest(flat))
    p = params_from_numpy(flat)
    toks, s = _tokens(arch)
    n = s + EXTRA
    rcache = ref_model.init_cache(ref_cfg, B, n, dtype=jnp.float32)
    pcache = transformer.init_cache(cfg, B, n, dtype=torch.float32,
                                    device="cpu")
    want, rcache, _ = ref_model.forward(
        ref_cfg, params, {"tokens": jnp.asarray(toks[:, :s])},
        mode="prefill", cache=rcache)
    got, pcache, _ = transformer.forward(
        cfg, p, {"tokens": torch.from_numpy(toks[:, :s])}, mode="prefill",
        cache=pcache)

    def check(got, want, where):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGITS_TOL, err_msg=where)
        for key, leaf in _flat(jax.tree.map(np.asarray, rcache)).items():
            g, w = key.split(".")
            np.testing.assert_allclose(pcache[g][w].numpy(), leaf,
                                       atol=CACHE_TOL, rtol=CACHE_TOL,
                                       err_msg=f"{where} {key}")
    check(got, want, "prefill")
    decode = jax.jit(lambda c, t, i: ref_model.forward(
        ref_cfg, params, {"token": t, "index": i}, mode="decode", cache=c))
    for i in range(EXTRA):
        tok = toks[:, s + i:s + i + 1]
        want, rcache, _ = decode(rcache, jnp.asarray(tok), jnp.int32(s + i))
        got, pcache, _ = transformer.forward(
            cfg, p, {"token": torch.from_numpy(tok), "index": s + i},
            mode="decode", cache=pcache)
        check(got, want, f"decode {i}")


# --- decode against the port's own training forward --------------------------


@pytest.mark.parametrize("arch,kw", [(a, {}) for a in DECODERS] + [
    ("gemma3-12b", {"attn_logit_softcap": 30.0}),
    ("qwen2.5-14b", {"attn_impl": "blockwise", "use_kernels": False,
                     "attn_block_k": 8, "attn_block_q": 8}),
    ("deepseek-v3-671b", {"use_kernels": False}),
    ("rwkv6-7b", {"use_kernels": False}),
    ("zamba2-2.7b", {"use_kernels": False})])
def test_decode_matches_train_logits(arch, kw):
    """Prefill the first S tokens, decode four more: the prefill logits and
    each decode step's equal train-mode logits of the whole sequence within
    5e-4 (the reference's contract), on the kernels' plain versions, the
    blockwise and naive routes, with a softcap, and past gemma3's
    window."""
    cfg = _port_cfg(arch, **kw)
    p = params_from_numpy(_params(arch))
    toks, s = _tokens(arch, seed=1)
    batch = {"tokens": torch.from_numpy(toks)}
    if arch == "qwen2-vl-72b":
        batch["image_embeds"] = torch.randn(
            (B, 8, cfg.d_model), generator=torch.Generator().manual_seed(0))
    want, _ = transformer.forward(cfg, p, batch, mode="eval")
    cache = transformer.init_cache(cfg, B, s + EXTRA, dtype=torch.float32,
                                   device="cpu")
    prompt = dict(batch, tokens=batch["tokens"][:, :s])
    got, cache, _ = transformer.forward(cfg, p, prompt, mode="prefill",
                                        cache=cache)
    torch.testing.assert_close(got, want[:, :s], rtol=0, atol=TRAIN_TOL)
    for i in range(EXTRA):
        got, cache, _ = transformer.forward(
            cfg, p, {"token": batch["tokens"][:, s + i:s + i + 1],
                     "index": s + i}, mode="decode", cache=cache)
        torch.testing.assert_close(got[:, 0], want[:, s + i], rtol=0,
                                   atol=TRAIN_TOL)


def test_decode_runs_sdpa_and_prefill_the_kernel_wrapper(monkeypatch):
    """Prefill hands the flash wrapper the whole cache (T = Smax, S < T,
    causal); decode never calls it: its one-row query takes the naive
    ``sdpa`` whatever ``use_kernels`` says, as the reference's does."""
    calls = []
    flash = attention.flash_mha

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return flash(q, k, v, **kw)
    monkeypatch.setattr(attention, "flash_mha", spy)
    cfg = _port_cfg("qwen2.5-14b")
    p = params_from_numpy(_params("qwen2.5-14b"))
    cache = transformer.init_cache(cfg, B, 30, dtype=torch.float32,
                                   device="cpu")
    toks = torch.from_numpy(_tokens("qwen2.5-14b")[0])
    transformer.forward(cfg, p, {"tokens": toks[:, :24]}, mode="prefill",
                        cache=cache)
    assert calls == [(24, 30, True)] * cfg.num_layers
    transformer.forward(cfg, p, {"token": toks[:, 24:25], "index": 24},
                        mode="decode", cache=cache)
    assert len(calls) == cfg.num_layers


def test_absorbed_decode_matches_the_materialised_form():
    """``mla_block``'s absorbed decode (queries into the latent, scores
    against the cached ``c_kv`` and rope key, the context out through
    ``w_uv``) against the materialised per-head K/V of the training
    branch on the whole sequence, last row: fp32 1e-5, bf16 2e-2."""
    cfg32 = _port_cfg("deepseek-v3-671b")
    flat = _params("deepseek-v3-671b")
    p = {k[len("moe_stack.attn."):]: torch.from_numpy(v[0])
         for k, v in flat.items() if k.startswith("moe_stack.attn.")}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        cfg = cfg32.replace(dtype=str(dtype)[6:])
        x = torch.randn((B, 13, cfg.d_model), generator=torch.Generator()
                        .manual_seed(2)).to(dtype)
        pos = torch.arange(13)[None].expand(B, 13)
        want = attention.mla_block(p, x, cfg, positions=pos)
        m = cfg.mla
        cache = {"c_kv": torch.zeros((B, 16, m.kv_lora_rank), dtype=dtype),
                 "k_rope": torch.zeros((B, 16, m.qk_rope_head_dim),
                                       dtype=dtype)}
        attention.mla_block(p, x[:, :12], cfg, positions=pos[:, :12],
                            cache=cache)
        got = attention.mla_block(p, x[:, 12:], cfg, positions=pos[:, 12:],
                                  cache=cache, cache_index=12)
        assert got.dtype == dtype and cache["c_kv"][:, 13:].abs().sum() == 0
        torch.testing.assert_close(got.float(), want[:, 12:].float(),
                                   rtol=tol, atol=tol)


def test_a_cache_in_another_dtype_raises():
    """A cache in another dtype than the compute dtype raises at the write
    (no cast hides the mismatch), and so do the kernel wrapper's checks on
    mixed q/k/v dtypes."""
    cfg = _port_cfg("qwen2.5-14b")
    p = params_from_numpy(_params("qwen2.5-14b"))
    cache = transformer.init_cache(cfg, B, 30, device="cpu")   # bf16
    toks = torch.from_numpy(_tokens("qwen2.5-14b")[0])
    with pytest.raises(ValueError, match="compute dtype"):
        transformer.forward(cfg, p, {"tokens": toks[:, :24]},
                            mode="prefill", cache=cache)
    ds = _port_cfg("deepseek-v3-671b")
    with pytest.raises(ValueError, match="compute dtype"):
        transformer.forward(ds, params_from_numpy(_params(
            "deepseek-v3-671b")), {"tokens": toks[:, :24]}, mode="prefill",
            cache=transformer.init_cache(ds, B, 30, device="cpu"))
    q = torch.zeros((B, 8, 4, 32))
    kv = torch.zeros((B, 2, 30, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="all equal"):
        fa.check_kernel_inputs(q, kv, kv)
    with pytest.raises(ValueError, match="overflows"):
        transformer.forward(cfg, p, {"tokens": toks},
                            mode="prefill", cache=transformer.init_cache(
                                cfg, B, 20, dtype=torch.float32,
                                device="cpu"))


def test_forward_modes_refuse_misuse():
    cfg = _port_cfg("qwen2.5-14b")
    p = params_from_numpy(_params("qwen2.5-14b"))
    toks = {"tokens": torch.zeros((B, 4), dtype=torch.int64)}
    cache = transformer.init_cache(cfg, B, 8, dtype=torch.float32,
                                   device="cpu")
    with pytest.raises(ValueError, match="needs a cache"):
        transformer.forward(cfg, p, toks, mode="prefill")
    with pytest.raises(ValueError, match="needs a cache"):
        transformer.forward(cfg, p, toks, lambda g: g, mode="prefill",
                            cache=cache)
    with pytest.raises(ValueError, match="prefill and decode"):
        transformer.forward(cfg, p, toks, cache=cache)
    with pytest.raises(ValueError, match="mode"):
        transformer.forward(cfg, p, toks, mode="serve", cache=cache)


# --- the server, the CLI and the example ------------------------------------


def test_server_greedy_tokens_follow_the_train_logits():
    """``Server.prefill`` then ``decode_step``: int32 (B, 1) tokens, each
    the argmax of the train-mode logits of the prompt and the tokens
    generated so far (greedy decoding is self-consistent), and the first
    one the argmax of the prefill's last logits."""
    cfg = _port_cfg("gemma3-12b")
    server = Server(cfg, params_from_numpy(_params("gemma3-12b")),
                    device="cpu")
    toks, s = _tokens("gemma3-12b", seed=2)
    cache = server.init_cache(B, s + 6)
    assert cache["layers"]["k"].dtype == torch.float32
    last, cache = server.prefill({"tokens": toks[:, :s]}, cache)
    assert last.shape == (B, 1, cfg.vocab_size)
    out = [greedy(last)]
    for i in range(5):
        tok, cache = server.decode_step(cache, out[-1], s + i)
        assert tok.dtype == torch.int32 and tok.shape == (B, 1)
        out.append(tok)
    seq = torch.cat([torch.from_numpy(toks[:, :s])] + out[:-1], dim=1)
    with torch.inference_mode():
        logits, _ = transformer.forward(cfg, server.params,
                                        {"tokens": seq}, mode="eval")
    want = logits[:, s - 1:].argmax(-1).to(torch.int32)
    assert torch.equal(torch.cat(out, dim=1), want)
    with pytest.raises(ValueError, match="no decode step"):
        Server(configs.get_smoke_config("vit-b16"), {}, device="cpu")


def test_serve_cli_on_the_cpu(capsys):
    res = serve.main(["--arch", "qwen2.5-14b", "--smoke", "--batch", "2",
                      "--prompt-len", "16", "--gen", "5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] arch=qwen2.5-14b-smoke batch=2 prefill(16 tok)=" in out
    assert "tok/s)" in out
    assert "[serve] sample generations (token ids):" in out
    assert res["tokens"].shape == (2, 5) and res["tokens"].dtype == np.int32
    again = serve.main(["--arch", "qwen2.5-14b", "--smoke", "--batch", "2",
                        "--prompt-len", "16", "--gen", "5", "--device",
                        "cpu", "--no-kernels"])
    assert np.array_equal(again["tokens"], res["tokens"])


@pytest.mark.parametrize("argv,match", [
    (["--model-axis", "2"], "without a world"),
    (["--arch", "vit-b16"], "no decode step"),
    (["--arch", "hubert-xlarge"], "no decode step")])
def test_serve_cli_refuses_what_is_not_ported(argv, match):
    with pytest.raises((SystemExit, NotImplementedError), match=match):
        serve.main(["--smoke", "--device", "cpu"] + argv)


def test_serve_cli_serves_a_batch_the_data_ranks_do_not_divide():
    """ROADMAP F2: ``--devices 2 --batch 3``, once refused, serves every
    row on both data ranks (the reference's ``_sanitize`` replicates such
    a batch) and keeps data rank 0's: the tokens of one process."""
    base = ["--arch", "qwen2.5-14b", "--smoke", "--batch", "3",
            "--prompt-len", "16", "--gen", "5", "--device", "cpu"]
    want = serve.main(base)["tokens"]
    got = serve.main(base + ["--devices", "2"])["tokens"]
    assert got.shape == (3, 5)
    np.testing.assert_array_equal(got, want)


def test_serve_decode_example_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_decode",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin",
                          "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr
    for arch in ("qwen2.5-14b-smoke", "rwkv6-7b-smoke", "zamba2-2.7b-smoke"):
        assert f"[serve] arch={arch} batch=2 prefill(32 tok)=" in r.stdout
    assert r.stdout.count("[serve] sample generations") == 3
    assert "not yet ported" not in r.stdout
