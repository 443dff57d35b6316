"""Port parity for the two-stage data prefetcher
(``repro_torch.data.pipeline.Prefetcher``): the reference's prefetcher
tests (``tests/test_data_pipeline.py``) on the port at the CPU device, the
prefetched stream byte for byte against the reference's ``Prefetcher``
from the same seed and a mid-epoch start, ``poison_batch`` on a tensor
batch, and the training CLI with and without the prefetcher. The pinned
copies on a side stream run only on a card (``chip_smoke.py`` phase 8d)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gc  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.datasets import CIFARSource  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.data.synthetic import DATASETS  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.resilience import FaultPlan, TransientError  # noqa: E402
from repro_torch.resilience.backoff import BackoffPolicy  # noqa: E402

FAST_RETRY = BackoffPolicy(max_attempts=3, base_delay=0.01, max_delay=0.01)


def _pipe(epoch_size=32):
    return DataPipeline(kind="image", global_batch=8, seed=5,
                        dataset=DATASETS["cifar10"], epoch_size=epoch_size,
                        resolution=8)


def _prefetch(p, *a, **kw):
    return p.prefetch(*a, device="cpu", **kw)


def _wait_until(cond, timeout=5.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    assert cond()


def _fail_at(p, bad, exc=ValueError("boom")):
    orig = p.batch_at
    p.batch_at = lambda e, i: (_ for _ in ()).throw(exc) if bad(e, i) \
        else orig(e, i)


# --- the reference's prefetcher tests, on the port --------------------------

def test_prefetcher_matches_sync_stream_and_rolls_epochs():
    p = _pipe(epoch_size=24)            # 3 steps an epoch
    with _prefetch(p, 0, 1) as pf:      # mid-epoch, like a resume
        got = [next(pf) for _ in range(7)]
    cur = (0, 1)
    for cursor, batch, nxt in got:
        assert cursor == cur
        assert isinstance(batch["images"], torch.Tensor)
        np.testing.assert_array_equal(batch["images"].numpy(),
                                      p.batch_at(*cursor)["images"])
        assert nxt == p.next_cursor(*cursor)
        cur = nxt
    assert got[-1][0] == (2, 1)


def test_prefetcher_propagates_synthesis_errors():
    p = _pipe()
    p.dataset = None                    # synthesis will blow up
    with _prefetch(p, 0, 0) as pf:
        with pytest.raises(RuntimeError, match="prefetch thread failed"):
            next(pf)


def test_prefetcher_close_terminates_thread_and_unblocks_consumer():
    pf = _prefetch(_pipe(), 0, 0)
    next(pf)
    pf.close()
    assert not any(t.is_alive() for t in pf._threads)
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()                          # idempotent


def test_prefetcher_error_with_full_queue_does_not_strand_thread():
    p = _pipe()
    _fail_at(p, lambda e, i: (e, i) != (0, 0))
    pf = _prefetch(p, 0, 0, depth=1)    # the error meets a full queue
    _wait_until(lambda: pf._error is not None)
    assert any(t.is_alive() for t in pf._threads)   # parked in a put
    pf.close()
    assert not any(t.is_alive() for t in pf._threads)


def test_prefetcher_dropped_reference_reclaims_thread():
    pf = _prefetch(_pipe(), 0, 0)
    threads = pf._threads
    next(pf)
    del pf
    gc.collect()
    _wait_until(lambda: not any(t.is_alive() for t in threads))


def test_prefetcher_error_after_ok_items_still_propagates():
    p = _pipe()
    _fail_at(p, lambda e, i: i >= 2)
    with _prefetch(p, 0, 0, depth=2) as pf:
        assert next(pf)[0] == (0, 0)
        assert next(pf)[0] == (0, 1)
        with pytest.raises(RuntimeError, match="prefetch thread failed"):
            next(pf)
    assert not any(t.is_alive() for t in pf._threads)


def test_prefetcher_depth_n_overlaps_and_preserves_order():
    p = _pipe(epoch_size=24)
    with _prefetch(p, 0, 0, depth=4) as pf:
        assert {t.name for t in pf._threads} == \
            {"data-synth", "data-transfer"}
        got = [next(pf) for _ in range(8)]
    cur = (0, 0)
    for cursor, batch, nxt in got:
        assert cursor == cur
        np.testing.assert_array_equal(batch["images"].numpy(),
                                      p.batch_at(*cursor)["images"])
        assert nxt == p.next_cursor(*cursor)
        cur = nxt


def test_prefetcher_close_warns_on_hung_producer():
    release = threading.Event()
    p = _pipe()
    p.batch_at = lambda e, i: release.wait() and None    # wedged source
    pf = _prefetch(p, 0, 0, retry=None)
    pf.JOIN_TIMEOUT = 0.2
    with pytest.warns(RuntimeWarning,
                      match=r"pending cursor \(epoch 0, batch 0\)"):
        pf.close()
    release.set()


def test_prefetch_depth_must_be_positive():
    with pytest.raises(ValueError, match="depth"):
        _prefetch(_pipe(), 0, 0, depth=0)


def test_prefetcher_retries_transient_source_errors():
    p = _pipe()
    orig = p.batch_at
    fails = {"n": 0}

    def flaky(e, i):
        if (e, i) == (0, 1) and fails["n"] < 2:
            fails["n"] += 1
            raise TransientError("network blip")
        return orig(e, i)

    p.batch_at = flaky
    with _prefetch(p, 0, 0, retry=FAST_RETRY) as pf:
        cursors = [next(pf)[0] for _ in range(3)]
    assert cursors == [(0, 0), (0, 1), (0, 2)]
    assert fails["n"] == 2


def test_prefetcher_exhausted_retries_propagate():
    p = _pipe()
    calls = {"n": 0}

    def down(e, i):
        calls["n"] += 1
        raise TransientError("source is down")

    p.batch_at = down
    with _prefetch(p, 0, 0, retry=FAST_RETRY) as pf:
        with pytest.raises(RuntimeError, match="prefetch thread failed"):
            next(pf)
    assert calls["n"] == 3              # exactly the retry budget


def test_prefetcher_nonretryable_errors_skip_the_retry_loop():
    p = _pipe()
    calls = {"n": 0}

    def broken(e, i):
        calls["n"] += 1
        raise ValueError("synthesis bug")

    p.batch_at = broken
    with _prefetch(p, 0, 0) as pf:      # the default retry policy
        with pytest.raises(RuntimeError, match="prefetch thread failed"):
            next(pf)
    assert calls["n"] == 1


def test_prefetcher_close_interrupts_backoff_sleep():
    p = _pipe()
    p.batch_at = lambda e, i: (_ for _ in ()).throw(
        TransientError("always down"))
    retry = BackoffPolicy(max_attempts=10, base_delay=30.0, max_delay=30.0)
    pf = _prefetch(p, 0, 0, retry=retry)
    _wait_until(lambda: any(t.is_alive() for t in pf._threads))
    t0 = time.time()
    pf.close()
    assert time.time() - t0 < 10        # not a 30 s backoff served out
    assert not any(t.is_alive() for t in pf._threads)


def test_batch_at_data_fault_injection_roundtrip():
    with FaultPlan.parse("data@1:transient:2"):
        with _prefetch(_pipe(), 0, 0, retry=FAST_RETRY) as pf:
            cursors = [next(pf)[0] for _ in range(3)]
        assert cursors == [(0, 0), (0, 1), (0, 2)]
    with FaultPlan.parse("data@0:permanent"):
        with _prefetch(_pipe(), 0, 0, retry=FAST_RETRY) as pf:
            with pytest.raises(RuntimeError,
                               match="prefetch thread failed"):
                next(pf)


def test_default_backoff_is_the_references():
    from repro.data.pipeline import DEFAULT_DATA_BACKOFF as ref
    assert pipeline.DEFAULT_DATA_BACKOFF.__dict__ == ref.__dict__


def test_cuda_prefetch_without_a_card_raises():
    """No quiet fallback: asking for the card where torch sees none is an
    error, before any thread starts."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py phase 8d runs this")
    with pytest.raises(RuntimeError, match="no GPU"):
        _pipe().prefetch(0, 0)


# --- the same stream as the reference's Prefetcher ---------------------------

def _ref_pipes(kind):
    from repro.data import datasets as ref_datasets
    from repro.data import pipeline as ref_pipeline
    from repro.data import synthetic as ref_synthetic
    if kind == "cifar":
        return (DataPipeline(global_batch=8, seed=3, source=CIFARSource(
                    "cifar10", seed=3, train_size=40)),
                ref_pipeline.DataPipeline(
                    kind="image", global_batch=8, seed=3,
                    source=ref_datasets.CIFARSource("cifar10", seed=3,
                                                    train_size=40)))
    if kind == "synthetic":
        return (DataPipeline(global_batch=4, seed=3,
                             dataset=DATASETS["cifar10"], resolution=16,
                             epoch_size=20),
                ref_pipeline.DataPipeline(
                    kind="image", global_batch=4, seed=3,
                    dataset=ref_synthetic.DATASETS["cifar10"],
                    resolution=16, epoch_size=20))
    return (DataPipeline(kind="token", global_batch=4, seed=3, vocab=97,
                         seq_len=16, epoch_size=12),
            ref_pipeline.DataPipeline(kind="token", global_batch=4, seed=3,
                                      vocab=97, seq_len=16, epoch_size=12))


@pytest.mark.parametrize("kind", ["cifar", "synthetic", "token"])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetched_stream_equals_the_references(depth, kind):
    port, ref = _ref_pipes(kind)
    n = 2 * port.steps_per_epoch + 1   # crosses two epoch boundaries
    with port.prefetch(1, 2, device="cpu", depth=depth) as pf:
        got = [next(pf) for _ in range(n)]
    with ref.prefetch(1, 2, depth=depth) as pf:
        want = [next(pf) for _ in range(n)]
    for (gc_, gb, gn), (wc, wb, wn) in zip(got, want):
        assert gc_ == tuple(wc) and gn == tuple(wn)
        assert gb.keys() == wb.keys()
        for key in wb:
            w = np.asarray(wb[key])
            g = gb[key].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, key
            assert g.tobytes() == w.tobytes(), key


# --- poison_batch on the prefetcher's tensors --------------------------------

def test_poison_batch_on_a_tensor_batch_fires_once():
    p = FaultPlan.parse("nan_grad@2,nan_grad@3")
    batch = {"images": torch.ones(2, 4, 4, 3),
             "labels": torch.arange(2, dtype=torch.int32)}
    fed = p.poison_batch(batch, 2)
    assert torch.isnan(fed["images"]).all()
    assert fed["images"].device == batch["images"].device
    assert fed["labels"] is batch["labels"]
    assert torch.isfinite(p.poison_batch(batch, 2)["images"]).all()
    u8 = {"images": torch.zeros(2, 16, 16, 3, dtype=torch.uint8),
          "labels": torch.arange(2, dtype=torch.int32)}
    fed = p.poison_batch(u8, 3, resolution=32)
    assert fed["images"].dtype == torch.float32
    assert tuple(fed["images"].shape) == (2, 32, 32, 3)
    assert torch.isnan(fed["images"]).all()
    assert u8["images"].dtype == torch.uint8    # the original untouched
    assert p.poison_batch(u8, 3) is u8          # once only


# --- the training CLI ----------------------------------------------------

BASE = ["--smoke", "--steps", "4", "--batch", "8", "--log-every", "1",
        "--device", "cpu"]


def _losses(rows):
    return [(r["loss"], r["grad_norm"]) for r in rows if "loss" in r]


def test_prefetch_and_no_prefetch_give_bitwise_equal_losses(capsys):
    a = cli.main(BASE + ["--prefetch-depth", "3"])
    b = cli.main(BASE + ["--no-prefetch"])
    assert len(_losses(a)) == 4 and _losses(a) == _losses(b)


def test_data_fault_is_retried_under_prefetch_and_fatal_without(capsys):
    clean = cli.main(BASE + ["--no-prefetch"])
    capsys.readouterr()
    rows = cli.main(BASE + ["--inject-faults", "data@2"])
    out = capsys.readouterr().out
    assert "[data] transient source error at (0, 2)" in out
    assert _losses(rows) == _losses(clean)
    with pytest.raises(TransientError, match="injected transient data"):
        cli.main(BASE + ["--no-prefetch", "--inject-faults", "data@2"])
    from repro_torch.resilience import faults
    assert faults.active() is None      # the plan is uninstalled


def test_prefetch_depth_zero_is_refused():
    with pytest.raises(SystemExit, match="--prefetch-depth must be >= 1"):
        cli.main(BASE + ["--prefetch-depth", "0"])


def test_poisoned_tensor_batch_trips_the_guard_once(capsys):
    clean = cli.main(BASE)
    capsys.readouterr()
    rows = cli.main(BASE + ["--inject-faults", "nan_grad@1"])
    out = capsys.readouterr().out
    assert out.count("update skipped") == 1
    assert "update skipped (1/3)" in out
    assert _losses(rows) == _losses(clean)  # the retry saw the clean batch
