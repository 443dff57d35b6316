"""The port's CLI (``repro_torch.launch.train``) in its eval mode on the
CPU: it writes the reference's metrics row, refuses the training options
that are not ported yet, and never runs on the CPU unless asked to. Its
training mode is tested in ``tests/test_torch_train.py``."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import json  # noqa: E402

from repro_torch.launch.train import main  # noqa: E402

# the reference's eval row: DistributedEngine.evaluate's keys
# (src/repro/core/engine.py:506-512) plus step and wall_s
# (src/repro/launch/train.py:365-366)
REF_EVAL_KEYS = {"eval_top1_count", "eval_top5_count", "eval_count",
                 "eval_acc", "eval_top5_acc", "eval_loss", "step", "wall_s"}

ARGS = ["--smoke", "--steps", "0", "--eval-every", "1", "--eval-size", "52",
        "--eval-batch", "16"]


def test_eval_cli_writes_reference_row(tmp_path, capsys):
    out = tmp_path / "metrics.json"
    main(ARGS + ["--device", "cpu", "--metrics-out", str(out)])
    rows = json.loads(out.read_text())
    assert len(rows) == 1
    row = rows[0]
    assert set(row) == REF_EVAL_KEYS
    assert row["eval_count"] == 52 and row["step"] == 0
    assert 0 <= row["eval_top1_count"] <= row["eval_top5_count"] <= 52
    assert row["eval_acc"] == row["eval_top1_count"] / 52
    printed = capsys.readouterr().out
    assert f"({row['eval_top1_count']}/52)" in printed
    assert "[eval ] step     0 top1=" in printed


def test_kernels_flag_does_not_change_cpu_counts():
    rows = [main(ARGS + ["--device", "cpu", "--dtype", "float32"] + extra)
            for extra in ([], ["--no-kernels"])]
    keys = ("eval_top1_count", "eval_top5_count", "eval_count")
    assert [rows[0][0][k] for k in keys] == [rows[1][0][k] for k in keys]


def test_training_steps_are_refused():
    """Training steps run since slice 2; steps that need an option of the
    reference the port does not have yet are refused, never run without
    it."""
    with pytest.raises(SystemExit, match="not yet ported"):
        main(ARGS[:1] + ["--steps", "1", "--augment", "--device", "cpu"])


def test_cuda_is_the_default_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no GPU"):
        main(ARGS)
