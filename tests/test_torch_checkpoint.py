"""Port parity for checkpointing: the port's ``repro-elastic-ckpt/v2``
(``repro_torch.checkpoint``) round-trips the training state bitwise, is
byte-compatible with the JAX package's format both ways, restores
elastically across gloo worlds and ZeRO stages, keeps the reference's
strictness and robustness (simulated processes, merge invariants, barrier
timeout, crc32 and fallback, GC), snapshots before an async write, and
gives the CLI resume parity.

The spawned worlds import this module (the spawn start method pickles the
job function by reference), so JAX is imported only inside the tests that
hold the port against the reference. Every spawned world and subprocess
has a deadline. Tolerance: resumed losses within 1e-5 of the uninterrupted
run's (``tests/test_resilience.py``'s resume parity); states bitwise.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import json  # noqa: E402
import os  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402

import repro_torch.checkpoint as ck  # noqa: E402
import repro_torch.checkpoint.checkpoint as ck_mod  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import EngineConfig  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.engine import Trainer, key_to_rng, rng_to_key, \
    to_device  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.data.synthetic import DATASETS  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.resilience import FaultPlan, PermanentFault  # noqa: E402
from repro_torch.resilience.backoff import BackoffPolicy  # noqa: E402

RESUME_TOL = 1e-5
DEADLINE_S = 240
ARCHS = ("vit-b16", "chatglm3-6b", "rwkv6-7b")


# --- helpers ----------------------------------------------------------------

def _trainer(arch="vit-b16", optimizer="adamw", zero=0, world=None,
             batch=8):
    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    ecfg = EngineConfig(train_batch_size=batch, optimizer=optimizer,
                        zero_stage=zero, lr=1e-3, total_steps=10,
                        warmup_steps=1)
    return Trainer(cfg, ecfg, device="cpu", world=world)


def _random_state(trainer, seed=0):
    """A state whose params and moments are all distinct random values,
    with a nonzero step, cursor and a negative rng seed."""
    state = trainer.init_state(init_params(trainer.cfg, seed=seed,
                                           device="cpu"))
    gen = torch.Generator().manual_seed(seed + 1)
    opt = state.opt_state
    trees = [state.params, opt.mu] + ([opt.nu] if opt.nu != () else [])
    with torch.no_grad():
        for tree in trees:
            for t in tree.values():
                t.copy_(torch.randn(t.shape, generator=gen))
    return state.replace(opt_state=opt._replace(step=7), step=7, epoch=2,
                         batch_index=5, rng=-123456789012)


def _assert_states_equal(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for name in ("mu", "nu"):
        ta, tb = getattr(a.opt_state, name), getattr(b.opt_state, name)
        assert (ta == ()) == (tb == ())
        for k in (ta or {}):
            assert torch.equal(ta[k], tb[k]), (name, k)
    assert (a.opt_state.step, a.step, a.epoch, a.batch_index, a.rng) == \
        (b.opt_state.step, b.step, b.epoch, b.batch_index, b.rng)


def _tiny_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(6,)).astype(np.float32)),
            "step": np.int64(3)}


def _tiny_like():
    return {"w": torch.empty(4, 6, device="meta"),
            "b": torch.empty(6, device="meta"), "step": np.int64(0)}


def _corrupt(ckpt_dir, step):
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    shard = next(n for n in sorted(os.listdir(d))
                 if n.startswith("shards-"))
    with open(os.path.join(d, shard), "r+b") as f:
        f.seek(os.path.getsize(os.path.join(d, shard)) // 2)
        f.write(b"\xde\xad\xbe\xef" * 4)


# --- (a) the state round trip ------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adamw", "sgd", "lamb"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_round_trip_is_bitwise(arch, optimizer, tmp_path, capsys):
    """Every param, moment, counter, the cursor and the rng seed come
    back bitwise, into a fresh trainer's state and into a live one (whose
    tensors are overwritten in place)."""
    tr = _trainer(arch, optimizer)
    state = _random_state(tr)
    path = tr.save_state(str(tmp_path), state)
    assert path.endswith("step_00000007")
    rep = ck.checkpoint_size_report(str(tmp_path), 7)
    assert rep["saved_bytes"] == rep["logical_bytes"]
    _assert_states_equal(state, _trainer(arch, optimizer).restore_state(
        str(tmp_path)))
    tr2 = _trainer(arch, optimizer)
    live = tr2.init_state(init_params(tr2.cfg, seed=9, device="cpu"))
    ptr = {k: p.data_ptr() for k, p in live.params.items()}
    restored = tr2.restore_state(str(tmp_path), step=7, state=live)
    _assert_states_equal(state, restored)
    assert {k: p.data_ptr() for k, p in restored.params.items()} == ptr
    assert "[ckpt] lazy restore: read" in capsys.readouterr().out


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1, 2 ** 32, -1,
                                  -2 ** 63, 2 ** 63 - 1])
def test_rng_maps_to_two_words(seed):
    key = rng_to_key(seed)
    assert key.dtype == np.uint32 and key.shape == (2,)
    assert key_to_rng(key) == seed
    if 0 <= seed < 2 ** 32:             # a PRNGKey(seed)'s words
        assert key.tolist() == [0, seed]


def test_rng_out_of_range_raises():
    with pytest.raises(ValueError, match="64 signed bits"):
        rng_to_key(2 ** 63)


def test_abstract_state_names_the_reference_leaves():
    tr = _trainer("vit-b16", "sgd")
    like = tr.abstract_state()
    assert "params/embed/cls" in like and "opt_state/mu/stack/mlp/w_up" \
        in like and not any(k.startswith("opt_state/nu/") for k in like)
    assert like["rng"].dtype == np.uint32 and like["rng"].shape == (2,)
    for k in ("opt_state/step", "step", "epoch", "batch_index"):
        assert like[k].dtype == np.int32 and like[k].shape == ()
    assert all(t.device.type == "meta" for k, t in like.items()
               if isinstance(t, torch.Tensor))


def test_template_mismatch_raises_and_never_rolls_back(tmp_path):
    """A checkpoint of another optimizer or config raises, even with an
    earlier step that would match (no silent rollback)."""
    tr = _trainer("vit-b16", "sgd")
    tr.save_state(str(tmp_path), _random_state(tr))
    with pytest.raises(KeyError, match="missing from checkpoint"):
        _trainer("vit-b16", "adamw").restore_state(str(tmp_path))
    wide = _trainer("vit-b16", "sgd")
    wide.cfg = wide.cfg.replace(d_ff=2 * wide.cfg.d_ff)
    with pytest.raises(ValueError, match="incompatible with restore"):
        wide.restore_state(str(tmp_path))


# --- (b) and (c) byte compatibility with the JAX package --------------------

def _ref_state(arch, optimizer):
    """A reference TrainState from ``init_params`` and the optimizer's
    ``init``, with nonzero moments, counters and key; and its numpy
    tree."""
    import jax
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro.core.engine import TrainState
    from repro.models import transformer as ref_model
    from repro.optim import make_optimizer
    cfg = ref_configs.get_smoke_config(arch).replace(dtype="float32")
    params = jax.jit(lambda k: ref_model.init_params(cfg, k))(
        jax.random.PRNGKey(0))
    opt = make_optimizer(optimizer).init(params)
    opt = opt._replace(step=jnp.int32(3),
                       mu=jax.tree.map(lambda p: p * 0.5 + 0.25, params),
                       nu=() if opt.nu == () else
                       jax.tree.map(jnp.square, params))
    return TrainState(params=params, opt_state=opt, step=jnp.int32(3),
                      epoch=jnp.int32(1), batch_index=jnp.int32(2),
                      rng=jax.random.fold_in(jax.random.PRNGKey(0), 1))


def _flat_np(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat_np(leaf, f"{prefix}{name}."))
        else:
            out[prefix + name] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("arch,optimizer", [
    ("vit-b16", "adamw"), ("vit-b16", "sgd"), ("chatglm3-6b", "lamb"),
    ("rwkv6-7b", "adamw")])
def test_reference_checkpoint_restores_into_the_port(arch, optimizer,
                                                     tmp_path):
    """A ``TrainState`` saved by ``repro.checkpoint`` restores into the
    port bitwise: params equal ``params_from_numpy`` of the reference's,
    the moments theirs, the counters and cursor as saved, and the key
    read as one signed 64-bit seed."""
    from repro.checkpoint import save_checkpoint as ref_save
    ref = _ref_state(arch, optimizer)
    ref_save(str(tmp_path), 3, ref)
    state = _trainer(arch, optimizer).restore_state(str(tmp_path))
    want = _flat_np(ref.params)
    assert set(state.params) == set(want)
    for k, p in state.params.items():
        assert np.array_equal(p.numpy(), want[k]), k
    for k, m in state.opt_state.mu.items():
        assert np.array_equal(m.numpy(), _flat_np(ref.opt_state.mu)[k]), k
    if optimizer != "sgd":
        for k, m in state.opt_state.nu.items():
            assert np.array_equal(m.numpy(),
                                  _flat_np(ref.opt_state.nu)[k]), k
    assert (state.opt_state.step, state.step, state.epoch,
            state.batch_index) == (3, 3, 1, 2)
    words = np.asarray(ref.rng).astype(np.uint64)
    assert state.rng == int(words[0]) << 32 | int(words[1])


@pytest.mark.parametrize("arch,optimizer", [
    ("vit-b16", "adamw"), ("vit-b16", "sgd"), ("rwkv6-7b", "lamb")])
def test_port_checkpoint_restores_and_verifies_in_the_reference(
        arch, optimizer, tmp_path):
    """A port-saved state restores in ``repro`` with the reference's own
    template (``shardings=None``), verifies, and saves exactly its logical
    bytes; the seed 7 reads as ``PRNGKey(7)``."""
    import jax
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro.checkpoint import checkpoint_size_report as ref_sizes
    from repro.checkpoint import restore_checkpoint as ref_restore
    from repro.checkpoint import verify_checkpoint as ref_verify
    from repro.core.engine import TrainState
    from repro.models import transformer as ref_model
    from repro.optim import make_optimizer
    tr = _trainer(arch, optimizer)
    state = _random_state(tr).replace(rng=7)
    tr.save_state(str(tmp_path), state)
    ref_verify(str(tmp_path), 7)
    rep = ref_sizes(str(tmp_path), 7)
    assert rep["saved_bytes"] == rep["logical_bytes"]
    cfg = ref_configs.get_smoke_config(arch).replace(dtype="float32")
    params = jax.eval_shape(lambda: ref_model.init_params(
        cfg, jax.random.PRNGKey(0)))
    scalar = jax.ShapeDtypeStruct((), jnp.int32)
    like = TrainState(params=params,
                      opt_state=jax.eval_shape(make_optimizer(optimizer).init,
                                               params),
                      step=scalar, epoch=scalar, batch_index=scalar,
                      rng=jax.ShapeDtypeStruct((2,), jnp.uint32))
    out = ref_restore(str(tmp_path), 7, like)
    got = _flat_np(out.params)
    for k, p in state.params.items():
        assert np.array_equal(got[k], p.numpy()), k
    for k, m in state.opt_state.mu.items():
        assert np.array_equal(_flat_np(out.opt_state.mu)[k], m.numpy()), k
    assert int(out.opt_state.step) == int(out.step) == 7
    assert (int(out.epoch), int(out.batch_index)) == (2, 5)
    assert np.array_equal(out.rng, np.asarray(jax.random.PRNGKey(7)))


def test_bf16_leaves_cross_both_ways(tmp_path):
    """bf16 goes as raw bytes: a port bf16 leaf restores in the reference
    (``ml_dtypes``) and a reference bf16 leaf in the port (no
    ``ml_dtypes``), bit for bit."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import restore_checkpoint as ref_restore
    from repro.checkpoint import save_checkpoint as ref_save
    from repro.checkpoint import verify_checkpoint as ref_verify
    w = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    ck.save_checkpoint(str(tmp_path / "port"), 1, {"w": w, "s": np.int32(4)})
    ref_verify(str(tmp_path / "port"), 1)
    out = ref_restore(str(tmp_path / "port"), 1,
                      {"w": jax.ShapeDtypeStruct((5, 3), jnp.bfloat16),
                       "s": jax.ShapeDtypeStruct((), jnp.int32)})
    assert np.array_equal(np.asarray(out["w"]).view(np.uint16),
                          w.view(torch.int16).numpy().view(np.uint16))
    assert int(out["s"]) == 4
    ref_save(str(tmp_path / "ref"), 1, {"w": jnp.asarray(out["w"])})
    got = ck.restore_checkpoint(str(tmp_path / "ref"), 1,
                                {"w": torch.empty(5, 3, dtype=torch.bfloat16,
                                                  device="meta")})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], w)


def test_sharded_port_save_restores_in_the_reference(tmp_path):
    """Two simulated processes each write their chunk of a leaf split on
    dimension 1 (the ``data`` axis at that dimension of the spec): the
    reference's restore reassembles it from the shard index maps."""
    from repro.checkpoint import restore_checkpoint as ref_restore
    import jax
    import jax.numpy as jnp
    w = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    for p in (1, 0):                    # process 0 commits: it goes last
        with ck.simulate_processes(p, 2):
            ck.save_checkpoint(str(tmp_path), 2, {
                "w": ck.Sharded(w.chunk(2, 1)[p], 1), "b": w[0].clone()},
                retry=None)
    man = json.load(open(tmp_path / "step_00000002" / "manifest.json"))
    entries = man["leaves"]["w"]["shards"]
    assert [e["index"] for e in entries] == [[[0, 4], [0, 3]],
                                             [[0, 4], [3, 6]]]
    assert man["leaves"]["w"]["spec"] == [None, "data"]
    assert man["mesh"] == {"data": 2, "model": 1}
    out = ref_restore(str(tmp_path), 2,
                      {"w": jax.ShapeDtypeStruct((4, 6), jnp.float32),
                       "b": jax.ShapeDtypeStruct((6,), jnp.float32)})
    assert np.array_equal(out["w"], w.numpy())
    assert np.array_equal(out["b"], w[0].numpy())


# --- (d) elastic restore across gloo worlds and ZeRO stages -----------------

def _batch(cfg, step):
    pipe = DataPipeline(global_batch=8, dataset=DATASETS["cifar10"],
                        resolution=cfg.image_size, seed=0)
    return to_device(pipe.batch_at(0, step), "cpu")


def _whole(trainer, state):
    """Every param and moment whole, as numpy (collectives on a world)."""
    opt = trainer.full_opt_state(state)
    out = {f"p/{k}": v.numpy().copy()
           for k, v in trainer.full_params(state).items()}
    out.update({f"mu/{k}": v.numpy().copy() for k, v in opt.mu.items()})
    out.update({f"nu/{k}": v.numpy().copy() for k, v in opt.nu.items()})
    return out


def _save_job(world, root):
    """World 2: two steps at ZeRO-3 and at ZeRO-1, each saved into its own
    directory; returns each stage's whole state."""
    out = {}
    for zero in (3, 1):
        tr = _trainer(zero=zero, world=world)
        state = tr.init_state(init_params(tr.cfg, seed=0, device="cpu"))
        for step in range(2):
            state, _ = tr.train_step(state, _batch(tr.cfg, step))
        tr.save_state(os.path.join(root, f"zero{zero}"), state)
        out[zero] = _whole(tr, state)
    return out


def _restore_job(world, root):
    """World 4 at ZeRO-2: restore each directory; returns the whole
    states and the restore stats."""
    out = {}
    for zero in (3, 1):
        tr = _trainer(zero=2, world=world)
        state = tr.restore_state(os.path.join(root, f"zero{zero}"))
        stats = ck.last_restore_stats()
        out[zero] = (_whole(tr, state), state.step, stats.read_bytes,
                     stats.logical_bytes)
    return out


def test_elastic_restore_across_worlds_and_stages(tmp_path):
    """Saved at world 2 under ZeRO-3 and ZeRO-1, restored at world 4 under
    ZeRO-2 and on one device: whole params and moments bitwise equal, and
    a sharded rank reads fewer bytes than the logical state."""
    saved = distributed.spawn(_save_job, 2, str(tmp_path), device="cpu",
                              deadline_s=DEADLINE_S, timeout_s=60)
    assert all(np.array_equal(saved[0][z][k], saved[1][z][k])
               for z in (3, 1) for k in saved[0][z])
    restored = distributed.spawn(_restore_job, 4, str(tmp_path),
                                 device="cpu", deadline_s=DEADLINE_S,
                                 timeout_s=60)
    for zero in (3, 1):
        want = saved[0][zero]
        for rank in range(4):
            whole, step, read, logical = restored[rank][zero]
            assert step == 2 and read < logical, (zero, rank, read, logical)
            for k in want:
                assert np.array_equal(whole[k], want[k]), (zero, rank, k)
        tr = _trainer()
        one = _whole(tr, tr.restore_state(str(tmp_path / f"zero{zero}")))
        for k in want:
            assert np.array_equal(one[k], want[k]), (zero, k)
        rep = ck.checkpoint_size_report(str(tmp_path / f"zero{zero}"), 2)
        assert rep["saved_bytes"] == rep["logical_bytes"]
        assert set(rep["per_process_bytes"]) == {0, 1}


# --- (e) strictness and robustness of the format -----------------------------

def test_simulated_two_process_save_merges_and_restores(tmp_path):
    tree = _tiny_tree()
    d = str(tmp_path)
    with ck.simulate_processes(1, 2):
        ck.save_checkpoint(d, 3, tree, retry=None)
        assert ck.list_steps(d) == []          # nothing committed yet
    with ck.simulate_processes(0, 2):
        ck.save_checkpoint(d, 3, tree, retry=None)
    assert ck.list_steps(d) == [3]
    sd = os.path.join(d, "step_00000003")
    assert sorted(os.listdir(sd)) == [
        "manifest-p00.json", "manifest-p01.json", "manifest.json",
        "shards-p00.npz", "shards-p01.npz"]
    assert not any(".tmp" in n for n in os.listdir(d))
    man = json.load(open(os.path.join(sd, "manifest.json")))
    assert man["format"] == ck.FORMAT and man["processes"] == 2
    for key in ("w", "b", "step"):      # replicated and host: process 0
        entries = man["leaves"][key]["shards"]
        assert len(entries) == 1 and entries[0]["process"] == 0
    ck.verify_checkpoint(d, 3)
    out = ck.restore_checkpoint(d, 3, _tiny_like())
    assert torch.equal(out["w"], tree["w"]) and out["step"] == 3
    rep = ck.checkpoint_size_report(d, 3)
    assert rep["saved_bytes"] == rep["logical_bytes"]
    assert set(rep["per_process_bytes"]) == {0}
    assert set(ck.per_process_restore_bytes(d, 3)) == {0, 1}


def test_snapshot_host_leaves_owned_by_process_zero_only():
    tree = _tiny_tree()
    with ck.simulate_processes(0, 2):
        snap0 = ck_mod._snapshot(tree)
    with ck.simulate_processes(1, 2):
        snap1 = ck_mod._snapshot(tree)
    assert snap0["process"] == 0 and snap1["process"] == 1
    for key in tree:
        assert len(snap0["leaves"][key]["shards"]) == 1
        assert snap1["leaves"][key]["shards"] == []
    assert set(snap1["leaves"]) == set(snap0["leaves"])


def test_lazy_restore_reads_only_intersecting_shards(tmp_path):
    """Saved split four ways on dimension 0; a process of two reads the
    two shards its chunk covers, and restoring split on dimension 1 reads
    them all."""
    w = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    for p in (3, 2, 1, 0):
        with ck.simulate_processes(p, 4):
            ck.save_checkpoint(str(tmp_path), 1,
                               {"w": ck.Sharded(w.chunk(4, 0)[p], 0)},
                               retry=None)
    like = {"w": torch.empty(8, 6, device="meta")}
    with ck.simulate_processes(1, 2):
        plan, stats = ck.restore_local_shards(str(tmp_path), 1, like,
                                              {"w": 0})
        col = ck.restore_checkpoint(str(tmp_path), 1, like, {"w": 1})
    [(dev, ranges, block)] = plan["w"]
    assert dev == 1 and ranges == ((4, 8), (0, 6))
    assert torch.equal(block, w[4:])
    assert (stats.entries_read, stats.entries_total) == (2, 4)
    assert stats.read_bytes == stats.partition_bytes == w.nbytes // 2
    assert torch.equal(col["w"], w[:, 3:])
    assert ck.last_restore_stats().entries_read == 4


def _manifest(process, processes, leaves):
    return {"format": ck.FORMAT, "step": 5, "process": process,
            "processes": processes, "mesh": None, "leaves": leaves}


def _leaf(entries, shape=(4,)):
    return {"dtype": "float32", "shape": list(shape), "spec": None,
            "shards": entries}


def _entry(process, index):
    return {"file": f"shards-p{process:02d}.npz", "key": "a0",
            "shape": [b - a for a, b in index], "index": index,
            "device": 0, "process": process, "crc32": 0}


def test_merge_rejects_duplicate_host_leaf_ownership():
    m0 = _manifest(0, 2, {"s": _leaf([_entry(0, [[0, 4]])])})
    m1 = _manifest(1, 2, {"s": _leaf([_entry(1, [[0, 4]])])})
    with pytest.raises(ValueError, match="duplicate/overlapping"):
        ck.merge_manifests([m0, m1])


def test_merge_rejects_lost_shard_coverage():
    m0 = _manifest(0, 2, {"s": _leaf([_entry(0, [[0, 2]])])})
    m1 = _manifest(1, 2, {"s": _leaf([])})
    with pytest.raises(ValueError, match="incomplete"):
        ck.merge_manifests([m0, m1])


def test_merge_rejects_missing_process_and_key_mismatch():
    m0 = _manifest(0, 2, {"s": _leaf([_entry(0, [[0, 4]])])})
    with pytest.raises(ValueError, match="declared 2"):
        ck.merge_manifests([m0])
    m1 = _manifest(1, 2, {"t": _leaf([])})
    with pytest.raises(KeyError, match="leaf keys disagree"):
        ck.merge_manifests([m0, m1])


def test_merge_barrier_times_out_naming_stragglers(tmp_path, monkeypatch):
    monkeypatch.setattr(ck_mod, "MERGE_BARRIER_TIMEOUT", 0.2)
    with ck.simulate_processes(0, 2):
        with pytest.raises(ck.CheckpointBarrierTimeout, match=r"\[1\]"):
            ck.save_checkpoint(str(tmp_path), 1, _tiny_tree(), retry=None)
    assert ck.list_steps(str(tmp_path)) == []
    assert not isinstance(ck.CheckpointBarrierTimeout("x"), OSError)


def test_npz_handles_closed_after_fallback_scan(tmp_path, monkeypatch):
    d = str(tmp_path)
    for step in (1, 2, 3):
        ck.save_checkpoint(d, step, _tiny_tree(), retry=None)
    for step in (2, 3):
        _corrupt(d, step)
    opened = []
    real_load = np.load

    def tracking_load(*a, **kw):
        f = real_load(*a, **kw)
        opened.append(f)
        return f

    monkeypatch.setattr(ck_mod.np, "load", tracking_load)
    out, step = ck.restore_latest_valid(d, _tiny_like())
    assert step == 1 and torch.equal(out["w"], _tiny_tree()["w"])
    with pytest.raises(ck.CheckpointCorruptError):
        ck.verify_checkpoint(d, 3)
    assert opened and not [f for f in opened if f.zip is not None]


def test_gc_excludes_failed_deletions_and_warns(tmp_path, monkeypatch,
                                                capsys):
    d = str(tmp_path)
    for step in (1, 2, 3, 4):
        ck.save_checkpoint(d, step, _tiny_tree(), retry=None)
    real_rmtree = ck_mod.shutil.rmtree

    def failing_rmtree(path, *a, **kw):
        if path.endswith("step_00000002"):
            raise OSError("device or resource busy")
        return real_rmtree(path, *a, **kw)

    monkeypatch.setattr(ck_mod.shutil, "rmtree", failing_rmtree)
    assert ck.gc_checkpoints(d, 1) == [1, 3]
    assert ck.list_steps(d) == [2, 4]
    assert "failed to delete step 2" in capsys.readouterr().out


def test_verify_detects_corruption_and_restore_falls_back(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        ck.save_checkpoint(d, s, {"w": torch.full((16, 8), float(s)),
                                  "step": np.int32(s)})
    ck.verify_checkpoint(d, 3)
    _corrupt(d, 3)
    with pytest.raises(ck.CheckpointCorruptError):
        ck.verify_checkpoint(d, 3)
    assert ck.latest_step(d) == 3 and ck.latest_valid_step(d) == 2
    like = {"w": torch.empty(16, 8, device="meta"), "step": np.int32(0)}
    tree, step = ck.restore_latest_valid(d, like)
    assert step == 2 and torch.equal(tree["w"], torch.full((16, 8), 2.0))
    with pytest.raises(ck.CheckpointCorruptError):
        ck.restore_checkpoint(d, 3, like)   # an explicit step propagates


def test_restore_latest_valid_raises_when_all_corrupt(tmp_path):
    ck.save_checkpoint(str(tmp_path), 1, _tiny_tree())
    _corrupt(str(tmp_path), 1)
    with pytest.raises(FileNotFoundError, match="all failed verification"):
        ck.restore_latest_valid(str(tmp_path), _tiny_like())


def test_list_steps_skips_tmp_and_manifestless(tmp_path):
    ck.save_checkpoint(str(tmp_path), 5, _tiny_tree())
    os.makedirs(tmp_path / "step_00000007.tmp")
    os.makedirs(tmp_path / "step_00000008")
    (tmp_path / "step_00000008" / "shards-p00.npz").write_bytes(b"junk")
    assert ck.list_steps(str(tmp_path)) == [5]
    assert ck.latest_step(str(tmp_path)) == 5


def test_save_retries_transient_write_faults(tmp_path):
    retry = BackoffPolicy(max_attempts=4, base_delay=0.01, max_delay=0.01)
    with FaultPlan.parse("ckpt_write@1:transient:2"):
        ck.save_checkpoint(str(tmp_path), 1, _tiny_tree(), retry=retry)
    ck.verify_checkpoint(str(tmp_path), 1)


def test_save_gives_up_on_permanent_write_fault(tmp_path):
    retry = BackoffPolicy(max_attempts=3, base_delay=0.01, max_delay=0.01)
    with FaultPlan.parse("ckpt_write@1:permanent"):
        with pytest.raises(PermanentFault):
            ck.save_checkpoint(str(tmp_path), 1, _tiny_tree(), retry=retry)
    assert ck.list_steps(str(tmp_path)) == []


def test_gc_keeps_last_k_and_never_the_last_valid(tmp_path):
    d = str(tmp_path / "a")
    for s in range(1, 6):
        ck.save_checkpoint(d, s, _tiny_tree(s))
    assert ck.gc_checkpoints(d, 2) == [1, 2, 3]
    assert ck.list_steps(d) == [4, 5]
    d = str(tmp_path / "b")
    for s in (1, 2, 3):
        ck.save_checkpoint(d, s, _tiny_tree(s))
    _corrupt(d, 2)
    _corrupt(d, 3)
    assert 1 not in ck.gc_checkpoints(d, 2)
    assert ck.list_steps(d) == [1, 2, 3]
    assert ck.restore_latest_valid(d, _tiny_like())[1] == 1
    d = str(tmp_path / "c")
    for s in range(1, 5):
        ck.save_checkpoint(d, s, _tiny_tree(s), keep_last_k=2)
    assert ck.list_steps(d) == [3, 4]


def test_restore_template_is_strict(tmp_path):
    ck.save_checkpoint(str(tmp_path), 1, _tiny_tree())
    with pytest.raises(KeyError, match="missing from checkpoint"):
        ck.restore_checkpoint(str(tmp_path), 1, dict(_tiny_like(), x=0.0))
    bad = dict(_tiny_like(), w=torch.empty(4, 6, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="dtype=bfloat16"):
        ck.restore_checkpoint(str(tmp_path), 1, bad)
    with pytest.raises(KeyError, match="not in the template"):
        ck.restore_checkpoint(str(tmp_path), 1, _tiny_like(), {"v": 0})
    with ck.simulate_processes(0, 4):     # 6 does not split four ways
        with pytest.raises(ValueError, match="not divisible"):
            ck.restore_checkpoint(str(tmp_path), 1, _tiny_like(), {"b": 0})


def test_async_failure_fails_fast_and_close_logs(tmp_path, capsys):
    saver = ck.AsyncCheckpointer(max_in_flight=1, retry=None)
    with FaultPlan.parse("ckpt_write@1:permanent"):
        saver.save(str(tmp_path), 1, _tiny_tree())
        saver._pending[0].join()
        with pytest.raises(RuntimeError, match="async checkpoint save"):
            saver.save(str(tmp_path), 2, _tiny_tree())
    saver.close()
    assert "surfaced at close" in capsys.readouterr().out
    with pytest.raises(ValueError, match="max_in_flight"):
        ck.AsyncCheckpointer(max_in_flight=0)


# --- (f) the async snapshot -------------------------------------------------

def test_async_snapshot_is_taken_before_the_next_step(tmp_path,
                                                      monkeypatch):
    """The train step updates the params in place; an async save copies
    them before it returns, so a write that runs only after the next step
    still holds the values of the step it was taken at."""
    tr = _trainer()
    state = tr.init_state(init_params(tr.cfg, seed=0, device="cpu"))
    state, _ = tr.train_step(state, _batch(tr.cfg, 0))
    before = {k: p.clone() for k, p in state.params.items()}
    stepped = threading.Event()
    real_write = ck_mod._write_with_retry

    def late_write(*a, **kw):
        assert stepped.wait(60)
        return real_write(*a, **kw)

    monkeypatch.setattr(ck_mod, "_write_with_retry", late_write)
    saver = tr.make_checkpointer()
    saver.save(str(tmp_path), state.step, tr.checkpoint_tree(state))
    state, _ = tr.train_step(state, _batch(tr.cfg, 1))
    assert not all(torch.equal(before[k], p)
                   for k, p in state.params.items())
    stepped.set()
    saver.wait()
    restored = _trainer().restore_state(str(tmp_path))
    assert restored.step == 1
    for k, p in restored.params.items():
        assert torch.equal(p, before[k]), k


# --- (g) CLI resume parity ----------------------------------------------------

BASE = ["--smoke", "--steps", "6", "--batch", "8", "--log-every", "1",
        "--dtype", "float32", "--device", "cpu"]


def _losses(rows):
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


@pytest.mark.parametrize("before,after", [
    ([], []),
    (["--augment", "--accum", "2"], ["--augment", "--accum", "2"]),
    (["--devices", "2", "--zero", "3"], ["--devices", "4", "--zero", "1"]),
], ids=["one-device", "augment", "world2-zero3-to-world4-zero1"])
def test_cli_resume_parity(before, after, tmp_path, capfd):
    """``--steps 6 --stop-after 3`` then ``--resume``: the resumed steps'
    losses equal the uninterrupted run's within 1e-5, and the resumed run
    starts at the saved step and cursor."""
    d = str(tmp_path / "ck")
    want = _losses(cli.main(BASE + before))
    first = _losses(cli.main(BASE + before + ["--ckpt-dir", d,
                                              "--stop-after", "3"]))
    assert ck.list_steps(d) == [3] and sorted(first) == [0, 1, 2]
    capfd.readouterr()
    rest = _losses(cli.main(BASE + after + ["--ckpt-dir", d, "--resume"]))
    out = capfd.readouterr().out       # spawned ranks print to the fd
    assert "resumed step=3 cursor=(epoch 0, batch 3)" in out
    assert sorted(rest) == [3, 4, 5] and ck.list_steps(d) == [3, 6]
    for s, loss in {**first, **rest}.items():
        assert abs(loss - want[s]) <= RESUME_TOL, (s, loss, want[s])
