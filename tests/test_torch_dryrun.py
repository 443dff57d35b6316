"""The dry run in the port (``launch/dryrun.py``, ``configs/shapes.py``,
``launch/specs.py::input_specs``, ``core/comm_model.py::roofline``) and
its tools (``repro_torch.tools``).

Against the reference: ``applicable`` (both values, the reason's text)
and ``input_specs`` (names, shapes, dtypes) for all eleven configs x four
shapes; ``roofline``/``comm_time_seconds`` against the reference's
``roofline`` to 1e-12 relative for a group inside one node, the reference
fed the same totals and an ``hw`` with the H100's ``peak_flops``,
``hbm_bw`` and ``ici_bw = nvlink_bw``. The CLI on the reference's own
pairs (``tests/test_dryrun.py``: glm4-9b x decode_32k and zamba2-2.7b x
train_4k at 256 ranks, granite-moe-3b-a800m x train_4k at 512 with
``--multi-pod``) and qwen2.5-14b x train_4k, which F2 once blocked, each
with the reference test's checks; a refused pair recorded as a failure;
the four tools on JSONL files the test writes. Each pair counts on
``meta`` in seconds. The reference's ``seq_parallel`` default ("ulysses"
for a prefill pair): HuBERT's smoke prefill on a small layout counted in
the Ulysses layout (all-to-all bytes by formula, no all-reduce), a
decoder's at the production layout keeping its tensor-parallel count,
and a decoder's Ulysses prefill refused (ROADMAP 16.2c).
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import configs  # noqa: E402
from repro_torch.configs import ALL_ARCHS, ASSIGNED_ARCHS, SHAPES, \
    EngineConfig, applicable, get_shape  # noqa: E402
from repro_torch.core.comm_model import H100_SXM, comm_time_seconds, \
    roofline  # noqa: E402
from repro_torch.core.engine import Trainer, resolve_device  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import ProductionLayout, \
    production_layout  # noqa: E402
from repro_torch.launch.op_count import Totals  # noqa: E402
from repro_torch.models.transformer import compute_dtype  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.tools import profile_pair, render_experiments, \
    roofline_report, zero_memory_table  # noqa: E402

KINDS = ("compute_s", "memory_s", "collective_s")


def test_the_registry_lists_the_references_archs():
    from repro import configs as ref_configs
    assert ASSIGNED_ARCHS == ref_configs.ASSIGNED_ARCHS
    assert set(ALL_ARCHS) == set(ref_configs.ALL_ARCHS)
    assert list(SHAPES) == list(ref_configs.SHAPES)
    for name, shape in SHAPES.items():
        ref = ref_configs.get_shape(name)
        assert (shape.seq_len, shape.global_batch, shape.kind,
                shape.is_decode) == (ref.seq_len, ref.global_batch,
                                     ref.kind, ref.is_decode)


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_applicable_and_input_specs_equal_the_references(arch):
    import numpy as np
    from repro import configs as ref_configs
    from repro.launch import specs as ref_specs
    cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
    for name in SHAPES:
        assert applicable(cfg, get_shape(name)) == \
            ref_configs.applicable(ref, ref_configs.get_shape(name))
        got = input_specs(cfg, get_shape(name))
        want = ref_specs.input_specs(ref, ref_configs.get_shape(name))
        assert list(got) == list(want)
        for key, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[key].shape), key
            assert str(t.dtype).removeprefix("torch.") == \
                np.dtype(want[key].dtype).name, key


def _ref_roofline(monkeypatch):
    # the reference's dry run sets XLA_FLAGS at import; restored after
    import os
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as ref_dryrun
    return ref_dryrun


@pytest.mark.parametrize("coll", [
    {"all-reduce": 3.2e9, "all-gather": 7.5e9, "reduce-scatter": 1.1e9,
     "all-to-all": 2.0e8, "collective-permute": 4.4e7},
    {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0,
     "all-to-all": 0.0, "collective-permute": 0.0}])
def test_roofline_equals_the_references_inside_one_node(coll, monkeypatch):
    from types import SimpleNamespace
    from repro.launch.hlo_analysis import Totals as RefTotals
    ref_dryrun = _ref_roofline(monkeypatch)
    hw = SimpleNamespace(peak_flops=H100_SXM.peak_flops,
                         hbm_bw=H100_SXM.hbm_bw, ici_bw=H100_SXM.nvlink_bw)
    for flops, nbytes in ((3.7e15, 2.1e13), (1.0e9, 9.9e12)):
        ours = Totals(flops=flops, hbm_bytes=nbytes, coll=dict(coll))
        theirs = RefTotals(flops=flops, hbm_bytes=nbytes, coll=dict(coll))
        got = roofline(ours, chips=256, model_flops=4.2e17)
        want = ref_dryrun.roofline(theirs, chips=256, model_flops=4.2e17,
                                   hw=hw)
        assert set(got) == set(want) and got["dominant"] == want["dominant"]
        for key, val in want.items():
            if key != "dominant":
                assert got[key] == pytest.approx(val, rel=1e-12, abs=0)
        assert comm_time_seconds(coll) == pytest.approx(
            ref_dryrun.comm_time_seconds(coll, hw), rel=1e-12, abs=0)


def test_collectives_across_nodes_go_at_the_network_rate():
    coll = {"all-reduce": 1e9, "all-gather": 2e9}
    far = {"all-reduce": 1e9, "all-gather": 5e8}
    t = comm_time_seconds(coll, H100_SXM, far)
    assert t == pytest.approx(2e9 / H100_SXM.ib_bw + 1.5e9 /
                              H100_SXM.nvlink_bw + 5e8 / H100_SXM.ib_bw)


def _check(rec, chips):
    """``tests/test_dryrun.py:30-36``'s checks."""
    assert rec["status"] == "ok", rec
    assert rec["chips"] == chips
    rl = rec["roofline"]
    assert rl["compute_s"] >= 0 and rl["memory_s"] > 0
    assert rl["dominant"] in KINDS
    assert rl["useful_flops_frac"] < 1.5
    assert rec["peak_bytes_per_dev"] >= rec["argument_bytes_per_dev"] > 0
    assert rec["count_s"] < 60


@pytest.mark.parametrize("arch,shape,argv,chips", [
    ("glm4-9b", "decode_32k", [], 256),
    ("zamba2-2.7b", "train_4k", [], 256),
    ("granite-moe-3b-a800m", "train_4k", ["--multi-pod"], 512),
    ("qwen2.5-14b", "train_4k", [], 256)])
def test_dryrun_cli_pair(arch, shape, argv, chips, tmp_path):
    out = tmp_path / "rec.jsonl"
    assert dryrun.main(["--arch", arch, "--shape", shape, "--out",
                        str(out)] + argv) == 0
    rec = json.loads(out.read_text().splitlines()[-1])
    _check(rec, chips)
    assert rec["zero"] == 3 and rec["attn"] == "blockwise"
    assert rec["layout"]["model"] == 16
    if shape == "train_4k":
        # ZeRO-3 gathers each layer's slices over the data group, and the
        # model group's sums run every layer
        assert rec["collectives"]["all-gather"] > 0
        assert rec["collectives"]["all-reduce"] > 0
        # 16 x 16: both the data and the model groups span nodes
        assert rec["collectives_network"] == rec["collectives"]


def test_deepseek_decode_counts_a_ranks_share_of_the_latents(monkeypatch):
    """DeepSeek-V3 x decode_32k: rank 0 holds 1/16 of the latent cache
    (its 2,048 of 32,768 rows, ``cache_specs``' sequence split), so its
    argument bytes are the whole-latent layout's (D9's, counted again
    with ``latents_split`` forced off) less exactly 15/16 of the latents,
    61 layers x 8 rows x 32,768 x (512 + 64) x 2 B; and its collectives
    add, a layer, the decode's all-gather of the absorbed query (B H (R +
    rope) bf16), the all-reduce of the partial maxima (B H fp32) and the
    reduce-scatter of the merged context and sums (B H/M (R + 1) fp32)."""
    from repro_torch.core import sharding
    split, cfg, shape, _, layout = dryrun.count_pair("deepseek-v3-671b",
                                                     "decode_32k")
    monkeypatch.setattr(sharding, "latents_split", lambda *a: False)
    whole = dryrun.count_pair("deepseek-v3-671b", "decode_32k")[0]
    m, L, M = cfg.mla, cfg.num_layers, layout.model
    rows, h = shape.global_batch // layout.data, cfg.num_heads
    latents = L * rows * shape.seq_len * (m.kv_lora_rank
                                          + m.qk_rope_head_dim) * 2
    assert whole.args_bytes - split.args_bytes == latents * (M - 1) // M \
        == 17_270_046_720
    got = {k: split.totals.coll[k] - whole.totals.coll[k]
           for k in split.totals.coll}
    assert got == {
        "all-gather": L * rows * h * (m.kv_lora_rank + m.qk_rope_head_dim)
        * 2,
        "all-reduce": L * rows * h * 4,
        "reduce-scatter": L * rows * (h // M) * (m.kv_lora_rank + 1) * 4,
        "all-to-all": 0, "collective-permute": 0}


def _small_pairs(monkeypatch, layout, seq=64, batch=4):
    """The dry run on the smoke configs at ``seq`` tokens and ``batch``
    sequences, on ``layout`` (a ``ProductionLayout``)."""
    real = dryrun.get_shape
    monkeypatch.setattr(dryrun, "get_config", configs.get_smoke_config)
    monkeypatch.setattr(dryrun, "get_shape", lambda name: dataclasses.replace(
        real(name), seq_len=seq, global_batch=batch))
    monkeypatch.setattr(dryrun, "production_layout",
                        lambda multi_pod=False: layout)


def test_prefill_pairs_take_the_references_ulysses_default():
    """``engine_for``'s ``seq_parallel`` is the reference's
    (``repro/launch/dryrun.py:95-96``): "ulysses" for a prefill pair,
    "none" for a training or decode pair, an explicit value honoured on
    every pair."""
    lay = production_layout()
    for shape, want in (("prefill_32k", "ulysses"), ("train_4k", "none"),
                        ("decode_32k", "none")):
        assert dryrun.engine_for("glm4-9b", shape, lay)[1] \
            .sequence_parallel == want
        for sp in ("none", "ulysses"):
            assert dryrun.engine_for("glm4-9b", shape, lay,
                                     seq_parallel=sp)[1] \
                .sequence_parallel == sp


def test_hubert_prefill_counts_the_ulysses_layout(monkeypatch):
    """HuBERT's smoke prefill (4 query and 4 KV heads, 2 layers) on rank
    0 of data 2 x model 4 under the default: the record says "ulysses",
    every leaf is whole on the rank (its arguments hold the whole
    params), and its only collectives are the four all-to-alls a layer
    (q, k and v to heads, the output back to rows), each receiving the
    data rank's B/2 x S rows of H/M heads of hd in the compute dtype; the
    same pair with ``--seq-parallel none`` counts the tensor-parallel
    layout's all-reduces and no all-to-all."""
    layout = ProductionLayout(data=2, pipe=1, model=4)
    _small_pairs(monkeypatch, layout)
    rec = dryrun.run_pair("hubert-xlarge", "prefill_32k", verbose=False)
    tp = dryrun.run_pair("hubert-xlarge", "prefill_32k", verbose=False,
                         seq_parallel="none")
    cfg = configs.get_smoke_config("hubert-xlarge")
    assert rec["status"] == tp["status"] == "ok"
    assert (rec["seq_parallel"], tp["seq_parallel"]) == ("ulysses", "none")
    rows, seq = 4 // layout.data, 64
    nbytes = torch.empty((), dtype=compute_dtype(cfg)).element_size()
    a2a = 4 * cfg.num_layers * rows * seq * \
        (cfg.num_heads // layout.model) * cfg.head_dim * nbytes
    assert rec["collectives"] == {"all-reduce": 0, "all-gather": 0,
                                  "reduce-scatter": 0, "all-to-all": a2a,
                                  "collective-permute": 0}
    assert tp["collectives"]["all-to-all"] == 0 and \
        tp["collectives"]["all-reduce"] > 0
    assert rec["argument_bytes_per_dev"] > tp["argument_bytes_per_dev"]


def test_decoder_prefill_keeps_its_tensor_parallel_count(monkeypatch):
    """A decoder's prefill at the production layout (16 x 16) under the
    Ulysses default: the smoke Qwen2.5's 4 query and 2 KV heads do not
    split 16 ways, so ``make_hints``' fallback holds and the count is the
    ``--seq-parallel none`` count, op for op; the record still says the
    reference's "ulysses". Where the Ulysses layout would apply (model
    axis 2), a decoder's prefill is refused, naming ROADMAP 16.2c."""
    _small_pairs(monkeypatch, production_layout(), batch=32)
    rec = dryrun.run_pair("qwen2.5-14b", "prefill_32k", verbose=False)
    tp = dryrun.run_pair("qwen2.5-14b", "prefill_32k", verbose=False,
                         seq_parallel="none")
    assert (rec["seq_parallel"], tp["seq_parallel"]) == ("ulysses", "none")
    for key in ("collectives", "xla_cost_analysis", "peak_bytes_per_dev",
                "argument_bytes_per_dev"):
        assert rec[key] == tp[key], key
    _small_pairs(monkeypatch, ProductionLayout(data=2, pipe=1, model=2))
    with pytest.raises(ValueError, match="16.2c"):
        dryrun.run_pair("qwen2.5-14b", "prefill_32k", verbose=False)


def test_a_pair_that_fails_is_recorded_and_all_exits_one(tmp_path,
                                                        monkeypatch):
    def refuse(arch, shape, **kw):
        if shape == "decode_32k":
            raise ValueError("refused by the port")
        return {"arch": arch, "shape": shape, "status": "skip",
                "reason": "skipped here"}
    monkeypatch.setattr(dryrun, "run_pair", refuse)
    monkeypatch.setattr(dryrun, "ASSIGNED_ARCHS", ("glm4-9b",))
    out = tmp_path / "all.jsonl"
    assert dryrun.main(["--all", "--out", str(out)]) == 1
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["skip", "skip", "fail", "skip"]
    assert recs[2]["error"] == "ValueError: refused by the port"


def test_the_trainer_counts_on_meta_and_needs_a_card_by_default():
    """``Trainer`` and ``Server`` take ``device="meta"`` when asked (the
    dry run's); the default stays ``cuda``, which raises without a card."""
    cfg = configs.get_smoke_config("vit-b16")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="sees no GPU"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="sees no GPU"):
            Trainer(cfg, EngineConfig(train_batch_size=8))
    trainer = Trainer(cfg, EngineConfig(train_batch_size=8,
                                        guard_anomalies=False),
                      device="meta")
    assert trainer.device.type == "meta"


# --- the tools -----------------------------------------------------------------

def _records(tmp_path):
    """A JSONL of one counted pair, a skip and a failure."""
    rec = dryrun.run_pair("glm4-9b", "decode_32k", verbose=False)
    skip = dryrun.run_pair("hubert-xlarge", "decode_32k", verbose=False)
    fail = {"arch": "gemma3-12b", "shape": "train_4k", "multi_pod": False,
            "status": "fail", "error": "ValueError: a refusal"}
    path = tmp_path / "baseline_singlepod.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in (rec, skip, fail)))
    return rec


def test_roofline_report_and_render_experiments_read_the_jsonl(tmp_path,
                                                               capsys):
    rec = _records(tmp_path)
    assert roofline_report.main(["--results", str(tmp_path)]) == 0
    rows = capsys.readouterr().out.splitlines()
    assert rows[0] == "name,us_per_call,derived"
    us = float(rows[1].split(",")[1])
    assert rows[1].startswith("roofline_gemma3-12b_train_4k,0.00,FAIL:")
    assert rows[2].startswith("roofline_glm4-9b_decode_32k,")
    assert us == 0.0 and float(rows[2].split(",")[1]) == pytest.approx(
        rec["roofline"]["bound_step_s"] * 1e6, abs=0.01)
    assert rows[-1] == "roofline_summary,0.00,ok=1;skip=1"
    assert render_experiments.main(["--results", str(tmp_path)]) == 0
    table = capsys.readouterr().out
    assert "modelled on H100 SXM5 700 W datasheet constants, not measured" \
        in table
    assert "| glm4-9b | decode_32k | 9.4B |" in table
    assert "| hubert-xlarge | decode_32k | — | — | — | — | — | SKIP |" \
        in table
    assert "| gemma3-12b | train_4k | — | — | — | — | — | FAIL |" in table


def test_profile_pair_and_the_zero_memory_table(tmp_path, capsys):
    assert profile_pair.main(["--arch", "glm4-9b", "--shape", "decode_32k",
                              "--n", "5"]) == 0
    out = capsys.readouterr().out
    assert "top 5 by bytes:" in out and "@ models/" in out
    assert zero_memory_table.main(["--arch", "glm4-9b", "--shape",
                                   "decode_32k", "--results",
                                   str(tmp_path)]) == 0
    recs = [json.loads(x) for x in
            (tmp_path / "zero_memory.jsonl").read_text().splitlines()]
    assert [r["zero"] for r in recs] == [0, 1, 2, 3]


def test_zero_memory_table_checkpoint_sizes(capsys):
    """``--ckpt-sizes``: 8 spawned CPU ranks save the smoke ViT's state at
    each stage; saved bytes equal the logical size, and from ZeRO 1 on
    the most a rank owns shrinks."""
    rows = zero_memory_table.ckpt_sizes()
    assert [r["saved"] for r in rows] == [r["logical"] for r in rows]
    assert rows[0]["max_rank"] == rows[0]["logical"]
    assert rows[3]["max_rank"] < rows[1]["max_rank"] < rows[0]["max_rank"]
    assert "restore/rank MiB" in capsys.readouterr().out
