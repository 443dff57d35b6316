"""The collective bytes (``core/distributed.py``): every ``World``
collective records its kind and the bytes of its result on this rank,
the reference's convention (``repro/launch/hlo_analysis.py:18-19``), and a
``RecordingWorld`` (the dry run's, on ``meta``) records exactly what a
real gloo world's ``count_collectives()`` does for one training step: the
ViT at data 2 under ZeRO 0-3, Qwen2.5 at model 2, the ViT's pipe of 2
(the exchanges) and the ViT under Ulysses at model 2 (the all-to-alls).
Exact. Also the rank arithmetic the recording world lays out with
(``launch/mesh.py::layout_ranks``) against the real layout's groups, the
reference's production layout, and which groups span nodes.

The spawned ranks import this module, so it imports no JAX.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import EngineConfig  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.distributed import COLLECTIVE_KINDS, \
    count_collectives, recording_world, reset_collectives  # noqa: E402
from repro_torch.core.engine import Trainer  # noqa: E402
from repro_torch.launch.mesh import group_ranks, layout_ranks, \
    make_layout, production_layout  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402

DEADLINE_S = 240
# job -> (arch, engine fields, model axis)
JOBS = {
    **{f"vit-z{z}": ("vit-b16", {"zero_stage": z}, 1) for z in range(4)},
    "qwen-m2": ("qwen2.5-14b", {}, 2),
    "vit-pp2": ("vit-b16", {"pipeline_stages": 2}, 1),
    "vit-uly2": ("vit-b16", {"sequence_parallel": "ulysses"}, 2),
}


def _batch(cfg, device):
    """A global batch of 8 rows (the ViT's images and labels, Qwen's 32
    tokens) on ``device``: random on the CPU, empty on ``meta``."""
    rng = np.random.default_rng(0)
    if cfg.arch_type == "vit":
        b = {"images": rng.standard_normal((8, cfg.image_size,
                                            cfg.image_size, 3),
                                           dtype=np.float32),
             "labels": rng.integers(0, cfg.num_classes, 8)}
    else:
        b = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32))}
    return {k: torch.from_numpy(v).to(device) if device == "cpu" else
            torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                        device=device) for k, v in b.items()}


def _step_counts(job, world):
    """The collective bytes by kind of one training step of ``job`` on
    ``world`` (after the layout's own first collectives)."""
    arch, fields, m = JOBS[job]
    device = world.device.type
    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    ecfg = EngineConfig(train_batch_size=8, gradient_accumulation_steps=2,
                        guard_anomalies=device != "meta", **fields)
    trainer = Trainer(cfg, ecfg, device=device, world=world, model_axis=m)
    state = trainer.init_state(model.init_params(cfg, device=device))
    reset_collectives()
    trainer.train_step(state, _batch(cfg, device))
    return count_collectives()


def _rank(world):
    return {job: _step_counts(job, world) for job in JOBS}


@pytest.fixture(scope="module")
def gloo():
    """[each rank's {job: counts}] of a gloo world of 2 on the CPU."""
    return distributed.spawn(_rank, 2, device="cpu", deadline_s=DEADLINE_S,
                             timeout_s=60)


@pytest.mark.parametrize("job", list(JOBS))
def test_recording_world_counts_what_a_gloo_world_does(job, gloo):
    for rank in range(2):
        want = gloo[rank][job]
        got = _step_counts(job, recording_world(rank, 2))
        assert got == want, (rank, got, want)
    moved = {k for k, v in gloo[0][job].items() if v}
    expect = {"vit-pp2": "collective-permute", "vit-uly2": "all-to-all",
              "vit-z3": "all-gather", "vit-z2": "reduce-scatter"}
    assert expect.get(job, "all-reduce") in moved


def test_a_group_of_one_records_nothing_and_each_kind_its_result():
    w = recording_world(0, 4)
    reset_collectives()
    t = torch.empty((3, 8), device="meta")
    w.all_reduce(t, "sum")
    w.all_reduce_many([t, torch.empty(5, dtype=torch.bfloat16,
                                      device="meta")])
    w.reduce_scatter_many([t], [1])
    w.all_gather_many([t], [0])
    w.all_to_all([torch.empty((2, 2), device="meta")] * 4,
                 [(2, 2), (1, 2), (2, 2), (3, 2)])
    w.exchange([(t, 1)], [((4, 4), torch.float32, 1)])
    got = count_collectives()
    assert got == {"all-reduce": 96 + 96 + 10, "reduce-scatter": 24,
                   "all-gather": 384, "all-to-all": 64,
                   "collective-permute": 64}
    one = recording_world(0, 1)
    reset_collectives()
    one.all_reduce(t)
    one.all_gather_many([t], [0])
    assert sum(count_collectives().values()) == 0
    assert set(got) == set(COLLECTIVE_KINDS)


def test_layout_ranks_and_the_production_layout():
    """``layout_ranks`` gives each rank the groups ``make_layout`` builds
    (rank ``(d * S + p) * M + m``); the production layout is 16 x 16 (32
    x 16 over two pods); a recording world's layout takes those groups
    with no process group, and its model and data groups of the 256
    ranks span nodes of 8 cards."""
    assert layout_ranks(8, 5, pipe=2, model=2) == {
        "data": [1, 5], "pipe": [5, 7], "model": [4, 5]}
    assert layout_ranks(4, 3) == {"data": [0, 1, 2, 3], "pipe": None,
                                  "model": None}
    groups = group_ranks(16, 1, 4)
    assert groups["model"][1] == [4, 5, 6, 7]
    assert groups["data"][2] == [2, 6, 10, 14]
    assert production_layout().size == 256
    big = production_layout(multi_pod=True)
    assert (big.data, big.pipe, big.model, big.size) == (32, 1, 16, 512)
    lay = make_layout(recording_world(17, 256), 1, 16)
    assert lay.model.ranks == tuple(range(16, 32)) and lay.model.rank == 1
    assert lay.data.ranks == tuple(range(1, 256, 16)) and lay.data.rank == 1
    assert lay.model.spans_nodes and lay.data.spans_nodes
    small = make_layout(recording_world(3, 8), 1, 4)
    assert not small.model.spans_nodes
