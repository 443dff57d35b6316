"""The port's example scripts and cost model:
``repro_torch.core.comm_model`` against the reference's at the same numbers
(relative 1e-12, with ``tests/test_properties.py``'s hypothesis settings),
and the three scripts of ``repro_torch.examples`` on the CPU: the
quickstart's 40 smoke steps, ``train_vit_cifar`` saved and resumed on the
same trajectory (1e-5, the reference's resume parity), and
``scaling_sweep``'s gloo worlds and its refusal of pipeline layouts."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import json  # noqa: E402
import shutil  # noqa: E402

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import comm_model as ref  # noqa: E402
from repro_torch.core import comm_model as port  # noqa: E402

SETTINGS = dict(max_examples=25, deadline=None)   # test_properties.py
REL = 1e-12
RESUME_TOL = 1e-5


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0)


@settings(**SETTINGS)
@given(nbytes=st.floats(1e3, 1e10), n=st.integers(1, 512),
       bw=st.floats(1e8, 1e12), latency=st.floats(0.0, 1e-4))
def test_collective_times_match_reference(nbytes, n, bw, latency):
    for name in ("allreduce_time", "reduce_scatter_time", "allgather_time"):
        _close(getattr(port, name)(nbytes, n, bw, latency),
               getattr(ref, name)(nbytes, n, bw, latency))


@settings(**SETTINGS)
@given(nbytes=st.floats(1e3, 1e10), intra=st.integers(1, 16),
       pods=st.integers(1, 64))
def test_hierarchical_allreduce_matches_reference(nbytes, intra, pods):
    hw = ref.TPU_V5E
    mapped = port.Hardware(nvlink_bw=hw.ici_bw, ib_bw=hw.dcn_bw,
                           link_latency=hw.link_latency,
                           pcie_bw=hw.host_infeed_bw)
    _close(port.hierarchical_allreduce_time(nbytes, intra, pods, mapped),
           ref.hierarchical_allreduce_time(nbytes, intra, pods, hw))


@settings(**SETTINGS)
@given(grad=st.floats(1e6, 1e10), t=st.floats(1e-3, 10.0),
       n=st.integers(1, 8), accum=st.integers(1, 8),
       infeed=st.floats(0.0, 1e9), bw=st.floats(1e9, 1e12))
def test_step_model_matches_reference(grad, t, n, accum, infeed, bw):
    kw = dict(grad_bytes=grad, compute_times=[t * (1 + i / 10)
                                              for i in range(n)],
              comm_bw=bw, accum_steps=accum, infeed_bytes_per_mb=infeed,
              infeed_bw=bw / 4)
    a, b = port.StepModel(**kw), ref.StepModel(**kw)
    _close(a.step_time(), b.step_time())
    _close(a.sync_fraction(), b.sync_fraction())


@settings(**SETTINGS)
@given(t=st.floats(1e-2, 100.0), grad=st.floats(1e6, 1e10),
       bw=st.floats(1e9, 1e12),
       hetero=st.one_of(st.none(), st.lists(st.floats(0.1, 2.0),
                                            min_size=32, max_size=32)))
def test_scaling_curves_match_reference(t, grad, bw, hetero):
    counts = [1, 2, 4, 8, 16, 32]
    for name in ("strong_scaling_times", "weak_scaling_times"):
        got = getattr(port, name)(t, grad, counts, comm_bw=bw, hetero=hetero)
        want = getattr(ref, name)(t, grad, counts, comm_bw=bw, hetero=hetero)
        for a, b in zip(got, want):
            _close(a, b)


def test_default_hardware_is_an_h100_and_no_tpu_constant():
    hw = port.Hardware()
    assert hw.name == "h100_sxm5_700w" and hw.peak_flops == 989e12
    assert (hw.hbm_bw, hw.nvlink_bw, hw.ib_bw, hw.pcie_bw) == \
        (3.35e12, 450e9, 50e9, 64e9)
    assert port.GPU_SPECS == ref.GPU_SPECS
    assert not hasattr(port, "TPU_V5E")


# --- the example scripts ---------------------------------------------------

def test_quickstart_trains_and_evaluates_on_the_cpu(capsys):
    from repro_torch.examples import quickstart
    logged, res = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert [r["step"] for r in logged] == [0, 10, 20, 30, 39]
    assert logged[-1]["loss"] < 2.3 < logged[0]["loss"]
    assert res["eval_count"] == 500
    assert "eval: top1" in out and "data=procedural" in out


def test_train_vit_cifar_resumes_the_same_trajectory(tmp_path, capfd):
    from repro_torch.examples import train_vit_cifar
    ck, full = tmp_path / "ck", tmp_path / "full.json"
    base = ["--device", "cpu", "--steps", "4", "--ckpt-every", "2",
            "--batch", "8", "--ckpt-dir", str(ck)]
    assert train_vit_cifar.main(base + ["--metrics-out", str(full)]) == 0
    cmd = capfd.readouterr().out
    assert "-m repro_torch.launch.train" in cmd and "--device cpu" in cmd
    # a run stopped after its step-2 save: drop the later step, resume
    shutil.rmtree(ck / "step_00000004")
    part = tmp_path / "resumed.json"
    assert train_vit_cifar.main(base + ["--metrics-out", str(part),
                                        "--resume"]) == 0
    assert "resumed step=2" in capfd.readouterr().out
    want = {r["step"]: r for r in json.loads(full.read_text())
            if "loss" in r}
    rows = json.loads(part.read_text())
    got = [r for r in rows if "loss" in r]
    assert [r["step"] for r in got] == [3]
    keys = ("step", "eval_top1_count", "eval_top5_count", "eval_count")
    assert [r[k] for r in rows if "eval_count" in r for k in keys] == \
        [r[k] for r in json.loads(full.read_text()) if "eval_count" in r
         for k in keys]
    for r in got:
        assert abs(r["loss"] - want[r["step"]]["loss"]) <= RESUME_TOL
        assert abs(r["grad_norm"] - want[r["step"]]["grad_norm"]) <= \
            RESUME_TOL


def test_scaling_sweep_runs_gloo_worlds_and_refuses_layouts(tmp_path,
                                                            capsys):
    from repro_torch.examples import scaling_sweep
    out = tmp_path / "sweep.json"
    res = scaling_sweep.main(["--device", "cpu", "--counts", "1", "2",
                              "--batch", "8", "--json-out", str(out)])
    assert json.loads(out.read_text()) == res
    assert set(res) == {"dp1", "dp2"}
    printed = capsys.readouterr().out
    assert "analytic projection to the paper's T4 cluster" in printed
    with pytest.raises(SystemExit, match="item 16"):
        scaling_sweep.main(["--device", "cpu", "--layouts", "2x2"])
