"""Port parity for fault tolerance (``repro_torch.resilience``): the fault
plans and backoff schedules equal the reference's for the same specs and
seeds; the plan's once-only semantics across restarts and ranks; the
supervisor and ``child_argv``; a spawned rank's exit 75 and the signals
that reach a launcher; and the supervised chaos run, which must match its
uninterrupted run within 1e-5 (``tests/test_resilience.py``'s invariant).

The reference's own chaos test does not run in this sandbox
(``DistributedEngine``, ROADMAP R1), so the port's chaos run is held
against the port's uninterrupted run; ``tests/test_torch_dp.py`` holds
that run against the reference. The spawned worlds import this module, so
JAX is imported only inside the tests that compare with the reference.
Every subprocess and spawned world has a deadline.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.checkpoint import list_steps  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.resilience import RESTARTABLE_EXIT, FaultPlan, \
    PermanentFault, TransientError, child_argv, supervise  # noqa: E402
from repro_torch.resilience.backoff import BackoffPolicy  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ENV = dict(os.environ, PYTHONPATH=SRC, PYTHONUNBUFFERED="1")
CHAOS_TOL = 1e-5

SPECS = ["nan_grad@3,ckpt_write@4:transient:5,data@2:permanent,sigterm@7",
         "nan@rand,preempt@rand,ckpt_corrupt@rand", "ckpt@rand:permanent",
         "nan_grad@1,ckpt_corrupt@2,preempt@3"]


def _schedule(plan):
    return [(f.kind, f.step, f.mode, f.count, f.remaining)
            for f in plan.faults]


# --- the same schedules as the reference -----------------------------------

@pytest.mark.parametrize("seed", [0, 11, 12, 2 ** 31 - 1])
@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parse_matches_reference(spec, seed):
    from repro.resilience import FaultPlan as RefPlan
    assert _schedule(FaultPlan.parse(spec, seed=seed, max_step=100)) == \
        _schedule(RefPlan.parse(spec, seed=seed, max_step=100))


@pytest.mark.parametrize("seed,max_step", [(0, 10), (5, 50), (7, 3),
                                           (123, 1000)])
def test_fault_plan_seeded_matches_reference(seed, max_step):
    from repro.resilience import FaultPlan as RefPlan
    assert _schedule(FaultPlan.seeded(seed, max_step)) == \
        _schedule(RefPlan.seeded(seed, max_step))


@pytest.mark.parametrize("policy", [
    {}, {"max_attempts": 8, "base_delay": 0.01, "max_delay": 0.01},
    {"max_attempts": 64, "base_delay": 0.5, "max_delay": 30.0},
    {"max_attempts": 6, "multiplier": 3.0, "jitter": 0.0}])
@pytest.mark.parametrize("seed", [0, 1, 42])
def test_backoff_delays_match_reference(policy, seed):
    from repro.resilience.backoff import BackoffPolicy as RefPolicy
    assert list(BackoffPolicy(**policy).delays(seed)) == \
        list(RefPolicy(**policy).delays(seed))


def test_backoff_retry_counts_attempts_and_sleeps():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientError("blip")
        return "ok"
    policy = BackoffPolicy(max_attempts=4, base_delay=0.01, max_delay=0.01)
    assert policy.retry(flaky, seed=0, sleep=slept.append) == "ok"
    assert len(calls) == 3 and len(slept) == 2
    with pytest.raises(ValueError):
        policy.retry(lambda: (_ for _ in ()).throw(ValueError("no")),
                     sleep=slept.append)


# --- FaultPlan semantics ------------------------------------------------------

def test_fault_plan_parse_rejects_garbage():
    with pytest.raises(ValueError, match="kind@step"):
        FaultPlan.parse("nan_grad")
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan.parse("frobnicate@3")
    with pytest.raises(ValueError, match="@rand"):
        FaultPlan.parse("nan_grad@rand")


def test_fault_check_transient_resolves_permanent_does_not():
    p = FaultPlan.parse("ckpt_write@3:transient:2,data@4:permanent")
    for _ in range(2):
        with pytest.raises(TransientError):
            p.check("ckpt_write", 3)
    p.check("ckpt_write", 3)
    for _ in range(3):
        with pytest.raises(PermanentFault):
            p.check("data", 4)
    p.check("data", 99)


def test_poison_batch_fires_once_on_float_and_uint8_batches():
    p = FaultPlan.parse("nan_grad@2,nan_grad@3")
    batch = {"images": np.ones((2, 2), np.float32),
             "labels": np.arange(2, dtype=np.int32)}
    fed = p.poison_batch(batch, 2)
    assert np.isnan(fed["images"]).all() and fed["labels"].dtype == np.int32
    assert np.isfinite(p.poison_batch(batch, 2)["images"]).all()
    u8 = {"images": np.zeros((2, 16, 16, 3), np.uint8),
          "labels": np.arange(2, dtype=np.int32)}
    fed = p.poison_batch(u8, 3, resolution=32)
    assert fed["images"].dtype == np.float32
    assert fed["images"].shape == (2, 32, 32, 3)
    assert np.isnan(fed["images"]).all()
    assert u8["images"].dtype == np.uint8       # the original untouched


def test_fault_log_marks_fired_faults_consumed(tmp_path):
    log = str(tmp_path / "faults.jsonl")
    p1 = FaultPlan.parse("nan_grad@2,preempt@5", log_path=log)
    p1.poison_batch({"x": np.ones(2, np.float32)}, 2)
    recs = [json.loads(line) for line in open(log)]
    assert [(r["kind"], r["step"]) for r in recs] == [("nan_grad", 2)]
    p2 = FaultPlan.parse("nan_grad@2,preempt@5", log_path=log)
    fed = p2.poison_batch({"x": np.ones(2, np.float32)}, 2)
    assert np.isfinite(fed["x"]).all()          # consumed, not replayed
    assert not p2.faults[1].fired


def test_only_the_writer_rank_appends_but_every_rank_reads(tmp_path):
    log = str(tmp_path / "faults.jsonl")
    reader = FaultPlan.parse("nan_grad@1", log_path=log, writer=False)
    reader.poison_batch({"x": np.ones(2, np.float32)}, 1)
    assert not os.path.exists(log)
    FaultPlan.parse("nan_grad@1", log_path=log).poison_batch(
        {"x": np.ones(2, np.float32)}, 1)
    again = FaultPlan.parse("nan_grad@1", log_path=log, writer=False)
    assert again.faults[0].exhausted


def test_installed_plan_is_module_level_and_removable():
    from repro_torch.resilience import faults
    with FaultPlan.parse("data@1:permanent") as plan:
        assert faults.active() is plan
        with pytest.raises(PermanentFault):
            faults.check("data", 1)
    assert faults.active() is None
    faults.check("data", 1)                     # no plan: a no-op


def test_data_fault_site_in_the_pipeline():
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.data.synthetic import DATASETS
    pipe = DataPipeline(global_batch=2, dataset=DATASETS["cifar10"],
                        resolution=8)
    with FaultPlan.parse("data@1:transient:1"):
        pipe.batch_at(0, 0)
        with pytest.raises(TransientError):
            pipe.batch_at(0, 1)
        pipe.batch_at(0, 1)


# --- supervisor --------------------------------------------------------------

class _FakeProc:
    def __init__(self, rc):
        self._rc = rc

    def wait(self):
        return self._rc

    def poll(self):
        return self._rc

    def send_signal(self, sig):
        pass


def _fake_popen(rcs, launched):
    it = iter(rcs)

    def popen(cmd):
        launched.append(list(cmd))
        return _FakeProc(next(it))
    return popen


def test_supervise_restarts_until_success():
    launched, slept = [], []
    rc = supervise(["train"], max_restarts=3,
                   backoff=BackoffPolicy(max_attempts=8, base_delay=0.01,
                                         max_delay=0.01),
                   seed=0, sleep=slept.append,
                   popen=_fake_popen([RESTARTABLE_EXIT, 1, 0], launched),
                   log=lambda m: None)
    assert rc == 0
    assert len(launched) == 3 and len(slept) == 2


def test_supervise_exhausts_restart_budget():
    launched = []
    rc = supervise(["train"], max_restarts=2,
                   backoff=BackoffPolicy(max_attempts=8, base_delay=0.01,
                                         max_delay=0.01),
                   seed=0, sleep=lambda d: None,
                   popen=_fake_popen([1, 1, 1, 1], launched),
                   log=lambda m: None)
    assert rc == 1 and len(launched) == 3


def test_supervise_zero_restarts_passes_through():
    rc = supervise(["train"], max_restarts=0, sleep=lambda d: None,
                   popen=_fake_popen([RESTARTABLE_EXIT], []),
                   log=lambda m: None)
    assert rc == RESTARTABLE_EXIT


def test_child_argv_strips_supervision_flags_and_adds_resume():
    argv = ["--steps", "6", "--supervise", "--max-restarts", "2",
            "--ckpt-dir", "/tmp/x"]
    cmd = child_argv(argv)
    assert cmd[:3] == [sys.executable, "-m", "repro_torch.launch.train"]
    tail = cmd[3:]
    assert "--supervise" not in tail and "--max-restarts" not in tail
    assert "2" not in tail
    assert tail.count("--resume") == 1
    assert child_argv(tail).count("--resume") == 1


# --- launcher exit codes and signals -------------------------------------------

def _exit_75(world):
    world.all_reduce(torch.ones(1))
    raise SystemExit(RESTARTABLE_EXIT)


def test_spawned_ranks_exit_code_is_the_launchers():
    with pytest.raises(SystemExit) as e:
        distributed.spawn(_exit_75, 2, device="cpu", deadline_s=120,
                          timeout_s=60)
    assert e.value.code == RESTARTABLE_EXIT


def test_cli_preemption_in_a_world_exits_75_after_one_save(tmp_path, capfd):
    """A planned preemption fires on every rank at step 1; the ranks agree
    on it, write one emergency checkpoint at step 2 together, and the
    launcher exits 75."""
    d = tmp_path / "ck"
    with pytest.raises(SystemExit) as e:
        cli.main(["--smoke", "--steps", "6", "--batch", "8", "--devices",
                  "2", "--zero", "3", "--device", "cpu", "--ckpt-dir",
                  str(d), "--inject-faults", "preempt@1"])
    assert e.value.code == RESTARTABLE_EXIT
    assert list_steps(str(d)) == [2]
    assert "emergency checkpoint" in capfd.readouterr().out
    recs = [json.loads(line) for line in open(d / "faults.jsonl")]
    assert [r["kind"] for r in recs] == ["preempt"]     # rank 0 alone


def test_sigterm_to_the_launcher_reaches_every_rank(tmp_path):
    """SIGTERM sent to the launcher of a world of two is passed on to the
    ranks; they agree on a step, save it together and the launcher exits
    75."""
    d = tmp_path / "ck"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "400", "--batch", "8", "--devices", "2", "--device",
         "cpu", "--log-every", "1", "--ckpt-dir", str(d)],
        env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        deadline = time.monotonic() + 240
        for line in proc.stdout:
            lines.append(line)
            if "[train] step     2 " in line:
                proc.send_signal(signal.SIGTERM)
                break
            assert time.monotonic() < deadline, "".join(lines)
        out, _ = proc.communicate(timeout=240)
    finally:
        proc.kill()
    out = "".join(lines) + out
    assert proc.returncode == RESTARTABLE_EXIT, out
    assert out.count("caught signal 15") == 2, out   # each rank once
    steps = list_steps(str(d))
    assert len(steps) == 1 and 3 <= steps[0] < 400, (steps, out)
    assert f"emergency checkpoint -> {d}/step_{steps[0]:08d}" in out


# --- the chaos run ----------------------------------------------------------------

def test_supervised_chaos_run_matches_its_uninterrupted_run(tmp_path):
    """NaN gradients, a corrupted checkpoint and a preemption under the
    supervisor, on a world of two: the run restarts, the guard trips, every
    logged loss equals the uninterrupted run's within 1e-5, and each fault
    is logged once."""
    common = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
              "--steps", "6", "--batch", "8", "--devices", "2", "--dtype",
              "float32", "--log-every", "1", "--device", "cpu"]
    base_out = tmp_path / "base.json"
    r = subprocess.run(common + ["--metrics-out", str(base_out)], env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    ck = tmp_path / "ck"
    chaos_out = tmp_path / "chaos.json"
    r = subprocess.run(
        common + ["--ckpt-dir", str(ck), "--ckpt-every", "2", "--ckpt-sync",
                  "--keep-last", "3", "--supervise", "--max-restarts", "2",
                  "--inject-faults", "nan_grad@1,ckpt_corrupt@2,preempt@3",
                  "--metrics-out", str(chaos_out)],
        env=ENV, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "launch attempt 2/3" in r.stdout
    assert "update skipped" in r.stdout
    base = {m["step"]: m["loss"] for m in json.load(open(base_out))
            if "loss" in m}
    chaos = {m["step"]: m["loss"] for m in json.load(open(chaos_out))
             if "loss" in m}
    assert sorted(chaos) == [4, 5] and sorted(base) == list(range(6))
    for s in chaos:
        assert abs(base[s] - chaos[s]) <= CHAOS_TOL, (s, base[s], chaos[s])
    # the attempt before the restart logged steps 0-3 on stdout
    printed = [line for line in r.stdout.splitlines()
               if line.startswith("[train] step ")]
    assert len(printed) == 6
    for line in printed:
        step, loss = int(line.split()[2]), float(line.split()[3][5:])
        assert abs(loss - base[step]) <= 5e-5, line
    recs = [json.loads(line) for line in open(ck / "faults.jsonl")]
    assert sorted(r["kind"] for r in recs) == ["ckpt_corrupt", "nan_grad",
                                               "preempt"]
