"""The engine: the train step with gradient accumulation and the anomaly
guard, data-parallel under ZeRO 0-3 when given a world, and the no-grad
eval step (``repro/core/engine.py``).

``Trainer`` owns the optimizer and the LR schedule and runs
``train_step(state, batch)`` for either family: each microbatch is
finished on the device (with ``aug``: crop, flip and Mixup/CutMix drawn
from the step's per-microbatch seeds; else upsample and normalise a uint8
image batch, ``device_preprocess``; token batches pass through), goes
forward and backward through the compute view of the params (bf16 matrices
under ``cast_params_bf16``), and the fp32 mean gradient feeds the
hand-written optimizer. ``Evaluator`` runs the eval loop under
``torch.inference_mode()``: each host batch (numpy, uint8 at the native
grid) goes to the device, is finished there, and yields integer
top-1/top-5/count plus an fp32 NLL sum, summed on the host so accuracy does
not depend on the batching. Both read the params through the same compute
view, so eval sees what training computes with.

Data parallelism (``world``, a ``core.distributed.World``): every rank gets
the same global batch and computes on its rows of each global microbatch
(``data/pipeline.py::rank_rows``), so the microbatches, and the
augmentation stream, are the reference's at any world size. What the ranks
exchange depends on ``ecfg.zero_stage`` (``core/sharding.py`` says which
dimension of each leaf is sharded):

  0  all-reduce the mean gradients; every rank takes the whole update.
  1  all-reduce; each rank updates its chunk of every sharded leaf with its
     chunk of the moments, then all-gathers the params.
  2  reduce-scatter each microbatch's gradients into the shard, then as 1.
  3  the params live sharded: the forward all-gathers each layer's slices
     where they are used (and the non-stacked leaves before the embed)
     through ``GatherShards``, one collective per layer and dtype, whose
     backward reduce-scatters. The gathered slices stay alive until the
     backward has used them.

An MoE decoder's load-balance loss is the global microbatch's, as GSPMD
makes the reference's: the forward's ``reduce`` hook (``forward_reduce``)
averages each MoE layer's routed fractions over the ranks, and each rank
weights them with its own mean router probabilities, so the mean of the
ranks' losses and gradients is the reference's. The gather dispatch
counts its capacity over this rank's tokens (ROADMAP deviation D4).

Pipeline parallelism (``ecfg.pipeline_stages`` S > 1, the reference's
``_pipeline_grads``, ``engine.py:311-414``): the step's gradients come from
``core.pipeline.pipelined_value_and_grad`` over the accumulation
microbatches, with the same seeds and the same finishing of each
microbatch. Without a world, or on a world of one, this process runs every
stage. On a larger world the ranks form a data x pipe layout
(``launch/mesh.py``): each rank holds its chunks' layers of every stacked
leaf (``core/sharding.py::stage_chunks``), ZeRO runs over its stage's data
group, and the non-stacked leaves are replicated over the pipe group, whose
gradients (only the first and last stages have any; a tied embedding gets
both) are summed over it. The global grad norm sums the stage-local
squares over the pipe group and counts a replicated leaf once; the loss and
the metrics, taken on the last stage, are summed over the pipe group, so
every rank's guard takes the same branch. Eval gathers the stacked leaves
whole over the pipe group and runs the plain forward.

A leaf that the world does not divide (``embed.cls``, ``stack.mlp.b_up``)
stays replicated: its gradient is all-reduced, every rank applies the same
whole update, and the norms count it once. The anomaly guard decides from
the all-reduced loss and the global grad norm, so every rank takes the same
branch; metrics are averaged over the ranks.

Tensor parallelism (``Trainer(model_axis=M)``, M > 1: the extent of the
reference's ``model`` mesh axis): a world is laid out data x model, or
data x pipe x model with pipeline stages (``launch/mesh.py``), and each
rank keeps its model chunk of every leaf
the model axis splits
(``core/sharding.py::model_dims``: Megatron's column/row split, the
vocab-parallel head, and the embedding split on its rows or, under
``ecfg.embed_sharding`` "dmodel", on its features, where the tied head is
a row-parallel product), then ZeRO's data chunk of that. The
forward and backward run with the model group installed
(``models/shardctx.py``), so the layers' collectives sum the partial
products; every other leaf is replicated over the model group and its
gradient is the same on each model rank, except the leaves of
``sharding.model_summed`` (D6's whole KV projections, D7's Mamba2
in-projection, conv and head vectors, the MoE router), each rank's
gradient its share, summed over the model group. The ZeRO collectives and the metrics' mean run over
the data group; the global grad norm sums a model-split leaf's squares
over the model group and counts a replicated one once. Batches are split
by the data rank, so the M ranks of a replica see the same rows and the
same augmentation draws. Checkpoints write every tensor leaf as
``Blocks``: a model chunk (and its data chunk) at its index ranges, a
replicated leaf by model rank 0.

Ulysses sequence parallelism (``ecfg.sequence_parallel`` "ulysses", where
``core/ulysses.py::applies`` says the model allows it; elsewhere the
tensor-parallel layout above): the same data x model layout, but every
model rank holds every leaf whole (``model_dims`` None) but an MoE's
routed experts, split on E (``ulysses.model_dims``), and the model
group is installed as the sequence group (``shardctx.use_sequence``), so
each rank runs its rows of the sequence; ``ecfg.embed_sharding`` has no
effect there (``embed.tok`` is whole on the model group and keeps the
"vocab" layout's ZeRO split). Each rank's gradient of a whole
leaf is its rows' share, summed over the model group (``model_summed``),
but the ViT's final norm and head, computed whole on every rank
(``ulysses.whole``); a split expert's gradient is its rank's own. A
decoder's or HuBERT's loss and metrics are summed over the group too, so
every rank's guard decides on the whole loss (the MoE's aux enters them
on model rank 0 only). The global grad norm sums the split experts'
squares over the model group and counts every other leaf once. ZeRO
shards a rank's expert chunk over the data group, as under tensor
parallelism. Checkpoints go as ``Blocks`` (the experts as model chunks,
every other leaf whole on the model axis, written by model rank 0), and
restore into any layout.

``Server`` serves (the reference's ``_prefill`` and ``_decode_step``,
``engine.py:517-568``): ``prefill`` runs a prompt batch into a cache and
returns the last position's logits; ``decode_step`` runs one token a
sequence at a given index and returns the greedy next token (int32). Both
run under ``torch.inference_mode()``, on one device or as one rank of a
data x model layout (each data rank its rows, each model rank its model
chunks of the params and its heads of the cache, ROADMAP D9, or its rows
of MLA's latents).

Checkpoints (``repro_torch.checkpoint``, the reference's
``repro-elastic-ckpt/v2``): ``checkpoint_tree`` names the state's leaves as
the reference's ``TrainState`` pytree does (``params/embed/cls``,
``opt_state/step``, ``opt_state/mu/...``, ``opt_state/nu/...``, ``step``,
``epoch``, ``batch_index``, ``rng``), each rank writing its chunks of the
leaves its ZeRO stage shards; ``restore_state`` reads back this rank's part
under its own layout, whatever layout wrote the step, and copies it into
the live tensors. Under a pipe group every tensor leaf goes as
``Blocks``: a stacked leaf as one block per chunk at its layer range (and
its data chunk under ZeRO), written by the stage's data rank 0 unless ZeRO
splits it; a non-stacked one by stage 0's ranks. A restore re-slices them
into any dp x pp x ZeRO layout.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointer, Blocks, Sharded, \
    last_restore_stats, restore_checkpoint, restore_latest_valid, \
    save_checkpoint
from repro_torch.configs.base import EngineConfig, check_embed_sharding
from repro_torch.core import pipeline, ulysses
from repro_torch.core.grad_accum import accumulate_gradients
from repro_torch.core.sharding import check_model_axis, check_serving, \
    is_stacked, model_dims, model_summed, serving_rows, shard_dims, \
    stage_chunks
from repro_torch.data.augment import augment_batch, device_preprocess, \
    draw_augment, step_seed
from repro_torch.data.pipeline import rank_rows
from repro_torch.launch.mesh import make_layout
from repro_torch.models import shardctx
from repro_torch.models import transformer as model
from repro_torch.optim import OptState, make_optimizer, make_schedule
from repro_torch.optim.optimizers import global_norm


def resolve_device(device) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; a missing card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no GPU; "
                           "pass device='cpu' (--device cpu) to run on the "
                           "CPU")
    return device


def compute_params(params: dict, ecfg: EngineConfig) -> dict:
    """The compute view of the params: under ``cast_params_bf16`` the fp32
    matrices (ndim >= 2) are cast to bf16; the master copy stays fp32."""
    if not ecfg.cast_params_bf16:
        return params
    return {k: p.to(torch.bfloat16)
            if p.dtype == torch.float32 and p.ndim >= 2 else p
            for k, p in params.items()}


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                device, non_blocking=True)
            if isinstance(v, np.ndarray) else v.to(device)
            for k, v in batch.items()}


def rng_to_key(seed: int) -> np.ndarray:
    """The checkpoint's ``rng`` leaf of the port's int64 seed: uint32
    ``[high word, low word]`` of its 64 bits (two's complement), the layout
    of the reference's ``PRNGKey`` (which reads a seed in [0, 2**32) as
    ``PRNGKey(seed)``)."""
    if not -2 ** 63 <= seed < 2 ** 63:
        raise ValueError(f"rng seed {seed} does not fit 64 signed bits")
    u = seed % 2 ** 64
    return np.array([u >> 32, u & 0xFFFFFFFF], np.uint32)


def key_to_rng(key) -> int:
    """The seed of a checkpoint's ``rng`` leaf: its two uint32 words as
    one 64-bit value taken as signed, so any reference key maps into the
    range ``step_seed`` packs."""
    hi, lo = (int(w) for w in np.asarray(key, np.uint32))
    u = hi << 32 | lo
    return u - 2 ** 64 if u >= 2 ** 63 else u


def _ckpt_key(key: str) -> str:
    """The reference's leaf path of a flat param key."""
    return key.replace(".", "/")


@dataclass
class TrainState:
    """The training state.

    params       the model's fp32 parameters, updated in place when a step
                 is accepted (so a ``ViT`` built on them sees every
                 update); under ZeRO-3 each rank's chunks of the sharded
                 leaves
    opt_state    ``OptState`` (fp32 moments; under ZeRO 1-3 each rank's
                 chunks of the sharded leaves)
    step         optimizer steps taken, also the LR-schedule position
    epoch, batch_index
                 the data cursor of the NEXT batch, rolled by the host loop
    rng          the base seed of per-step randomness: microbatch i of step
                 s augments with ``step_seed(rng, s, i)``
    """
    params: dict
    opt_state: OptState
    step: int = 0
    epoch: int = 0
    batch_index: int = 0
    rng: int = 0

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


class GatherShards(torch.autograd.Function):
    """ZeRO-3's gather on use: all-gathers a group of shards (shard i along
    ``dims[i]``) in one collective per dtype; the backward reduce-scatters
    the whole leaves' gradients the same way and divides by the world, so
    each shard gets its chunk of the mean over the ranks."""

    @staticmethod
    def forward(ctx, world, dims, *shards):
        ctx.world, ctx.dims = world, dims
        return tuple(world.all_gather_many(list(shards), dims))

    @staticmethod
    def backward(ctx, *grads):
        world = ctx.world
        return (None, None) + tuple(
            g.div_(world.size) for g in
            world.reduce_scatter_many(list(grads), ctx.dims))


class Trainer:
    def __init__(self, cfg, ecfg: EngineConfig, *, preproc=None,
                 device="cuda", aug=None, world=None, model_axis=1):
        """``preproc``: the dataset's :class:`Preproc`, needed when batches
        come as uint8 (every dataset source ships them so); the fp32
        synthetic stream needs none. ``aug``: an ``AugmentConfig`` for
        train-time augmentation (ViT only). ``world``: a
        ``core.distributed.World`` for the data-parallel step under
        ``ecfg.zero_stage`` (its device is the rank's); None trains on one
        device without a process group. With ``ecfg.pipeline_stages`` > 1
        a world of more than one rank is laid out data x pipe, with
        ``model_axis`` M > 1 data x (pipe x) model
        (``launch.mesh.make_layout``, a collective): each replica's (each
        stage's) layers split over M ranks, the token embedding on its
        rows or its features by ``ecfg.embed_sharding``. With
        ``ecfg.sequence_parallel`` "ulysses" the M ranks split the sequence
        instead where ``ulysses.applies``, every leaf but an MoE's experts
        whole on each (D8), so ``embed_sharding`` has no effect there."""
        self.data = self.pipe = self.tp = None
        M = model_axis
        # the Ulysses layout on the model group, else tensor parallelism
        self.ulysses = world is not None and ulysses.applies(
            cfg, M, ecfg.sequence_parallel)
        if not self.ulysses:
            check_model_axis(cfg, M)
        if world is None and M > 1:
            raise ValueError(f"model_axis {M} needs a world of ranks")
        if world is not None:
            layout = make_layout(world, ecfg.pipeline_stages, M)
            self.data, self.pipe, self.tp = layout.data, layout.pipe, \
                layout.model
        ecfg.validate(self.data.size if self.data is not None else 1)
        if ecfg.pipeline_stages > 1:
            pipeline.check_supported(cfg)
            pipeline.stage_partition(
                cfg.num_layers,
                ecfg.pipeline_stages * ecfg.pipeline_interleave)
        if world is None and ecfg.zero_stage:
            raise ValueError(f"zero_stage {ecfg.zero_stage} needs a "
                             f"data-parallel world")
        if aug is not None and cfg.arch_type != "vit":
            raise ValueError(f"{cfg.name}: augmentation is for images")
        self.cfg = cfg
        self.ecfg = ecfg
        self.preproc = preproc
        self.aug = aug.validate() if aug is not None else None
        self.device = resolve_device(device)
        if world is not None:
            if world.device.type != self.device.type:
                raise ValueError(f"world on {world.device}, trainer asked "
                                 f"for {self.device}")
            self.device = world.device
        self.optimizer = make_optimizer(
            ecfg.optimizer, weight_decay=ecfg.weight_decay,
            grad_clip=ecfg.grad_clip)
        self.schedule = make_schedule(ecfg.lr_schedule, ecfg.lr,
                                      ecfg.warmup_steps, ecfg.total_steps)
        self.param_dims = self.opt_dims = None
        # the embedding's layout (under Ulysses every leaf is whole on the
        # model group: "vocab"'s ZeRO split)
        self.embed = "vocab" if self.ulysses else ecfg.embed_sharding
        # the dimension of each (whole) leaf split over the model group
        # (under Ulysses only an MoE's routed experts, on E)
        shapes = {k: p.shape
                  for k, p in model.init_params(cfg, device="meta").items()}
        if self.tp is None:
            self.model_dims = dict.fromkeys(shapes)
        elif self.ulysses:
            self.model_dims = ulysses.model_dims(shapes, cfg, M)
        else:
            self.model_dims = model_dims(shapes, cfg, M, self.embed)
        # the leaves whole on every model rank whose gradients are summed
        # over the model group (D6's KV projections, D7's Mamba2 leaves,
        # the MoE router; under Ulysses every whole leaf a rank computes
        # on its rows)
        self.model_summed = [k for k in shapes if self.tp is not None and (
            not ulysses.whole(k, cfg) and self.model_dims[k] is None
            if self.ulysses else model_summed(k, cfg, M))]
        # the executor's schedule accounting of the last pipelined step
        self.schedule_out = {}

    # --- layout ---------------------------------------------------------

    def group_context(self):
        """The model group installed for a forward and its backward: as
        the sequence group under Ulysses, else as the tensor-parallel
        group (None without one)."""
        if self.ulysses:
            return shardctx.use_sequence(self.tp)
        return shardctx.use(self.tp)

    def _layout(self, params: dict) -> None:
        """Which dimension of each leaf the params (``param_dims``, ZeRO-3)
        and the optimizer state (``opt_dims``, ZeRO 1-3) shard; all None on
        one device."""
        shapes = {k: p.shape for k, p in params.items()}
        size = self.data.size if self.data is not None else 1
        stage = self.ecfg.zero_stage
        self.param_dims = shard_dims(shapes, zero_stage=stage, world=size,
                                     embed_sharding=self.embed)
        self.opt_dims = shard_dims(shapes, zero_stage=stage, world=size,
                                   for_opt_state=True,
                                   embed_sharding=self.embed)

    def _opt_view(self, params: dict) -> dict:
        """The part of each leaf this rank's optimizer state covers: its
        chunk of a leaf whose state is sharded while the param is not
        (ZeRO 1-2), else the leaf (a ZeRO-3 param is its chunk already)."""
        return {k: self.data.chunk(p, self.opt_dims[k])
                if self.opt_dims[k] is not None
                and self.param_dims[k] is None else p
                for k, p in params.items()}

    def _chunks(self) -> list:
        """The layer ranges of this rank's pipeline chunks."""
        e = self.ecfg
        return stage_chunks(self.cfg.num_layers, e.pipeline_stages,
                            e.pipeline_interleave, self.pipe.rank)

    def init_state(self, params: dict) -> TrainState:
        """A fresh state around ``params`` (e.g. ``ViT.params()``, whose
        tensors it then updates in place; every rank passes the same
        values). Under a pipe group the state keeps this rank's chunks of
        each stacked leaf; under a model group this rank's model chunk of
        each leaf the model axis splits (copies: build the model on
        ``state.params``); under ZeRO-3 this rank's chunk of each sharded
        leaf, and the caller's whole tensors can go. ``params`` may lie
        on the host (a memory-mapped file's): only this rank's parts are
        copied to its device."""
        def local(k, p):
            d = self.model_dims[k] if self.tp is not None else None
            if d is not None:
                p = self.tp.chunk(p, d)
            if self.pipe is not None and is_stacked(k):
                # this rank's chunks of each stacked leaf, in chunk order
                return torch.cat([p[lo:hi].to(self.device)
                                  for lo, hi in self._chunks()])
            return p.to(self.device, copy=d is not None)
        params = {k: local(k, p) for k, p in params.items()}
        self._layout(params)
        if self.ecfg.zero_stage == 3:
            params = {k: self.data.chunk(p, d).clone() if d is not None
                      else p for k, p in params.items()
                      for d in (self.param_dims[k],)}
        return TrainState(params=params,
                          opt_state=self.optimizer.init(
                              self._opt_view(params)),
                          rng=self.ecfg.seed)

    def gather(self, group: dict) -> dict:
        """The model's ``gather`` hook under ZeRO-3: ``{key: this rank's
        chunk}`` (a layer's slice for a stacked leaf) -> ``{key: the whole
        tensor}``, the sharded ones in one ``GatherShards``."""
        keys = [k for k in group if self.param_dims[k] is not None]
        if not keys:
            return group
        # a stacked leaf comes as one layer's slice: its L axis is gone
        dims = [self.param_dims[k] - is_stacked(k) for k in keys]
        full = GatherShards.apply(self.data, dims,
                                  *[group[k] for k in keys])
        return dict(group, **dict(zip(keys, full)))

    @property
    def forward_gather(self):
        """``gather`` where the params are sharded (ZeRO-3), else None."""
        return self.gather if self.ecfg.zero_stage == 3 else None

    def mean_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """The model's ``reduce`` hook on a world: a copy of ``t`` averaged
        over the ranks, outside autograd. The MoE layers pass it their
        routed fractions, so the load-balance loss is the global batch's
        (``models/moe.py``); a checkpointed layer's recompute calls it
        again, on every rank alike."""
        with torch.no_grad():
            return self.data.all_reduce(t.detach().clone(), "mean")

    @property
    def forward_reduce(self):
        """``mean_over_ranks`` on a data group of more than one rank, else
        None."""
        w = self.data
        return self.mean_over_ranks if w is not None and w.size > 1 \
            else None

    def _whole(self, tree: dict, dims: dict) -> dict:
        """``tree`` with each leaf that ``dims`` shards gathered whole."""
        keys = [k for k in tree if dims[k] is not None]
        full = self.data.all_gather_many([tree[k] for k in keys],
                                         [dims[k] for k in keys])
        return dict(tree, **dict(zip(keys, full)))

    def pipe_whole(self, tree: dict) -> dict:
        """``tree`` with each stacked leaf gathered whole over the pipe
        group (its chunks in layer order); ``tree`` itself without one."""
        if self.pipe is None:
            return tree
        keys = [k for k in tree if is_stacked(k)]
        e = self.ecfg
        S, v = e.pipeline_stages, e.pipeline_interleave
        full = self.pipe.all_gather_many([tree[k] for k in keys],
                                         [0] * len(keys))
        # rows come stage-major (p, k, layer); the layers run (k, p, layer)
        out = {k: f.view((S, v, -1) + tuple(f.shape[1:])).transpose(0, 1)
               .reshape(f.shape) for k, f in zip(keys, full)}
        return dict(tree, **out)

    def model_whole(self, tree: dict) -> dict:
        """``tree`` (model chunks) with each leaf the model axis splits
        gathered whole over the model group; ``tree`` itself without
        one."""
        if self.tp is None:
            return tree
        keys = [k for k in tree if self.model_dims[k] is not None]
        full = self.tp.all_gather_many([tree[k] for k in keys],
                                       [self.model_dims[k] for k in keys])
        return dict(tree, **dict(zip(keys, full)))

    def full_params(self, state: TrainState) -> dict:
        """Every param whole (a collective under ZeRO-3, a pipe group or
        a model group)."""
        params = state.params
        if self.forward_gather is not None:
            params = self._whole(params, self.param_dims)
        return self.pipe_whole(self.model_whole(params))

    def full_opt_state(self, state: TrainState) -> OptState:
        """The optimizer state with every moment whole (a collective under
        ZeRO 1-3, a pipe group or a model group)."""
        if self.data is None:
            return state.opt_state
        st = state.opt_state

        def whole(tree):
            return self.pipe_whole(self.model_whole(
                self._whole(tree, self.opt_dims)))
        return OptState(st.step, whole(st.mu),
                        whole(st.nu) if st.nu != () else ())

    # --- checkpoints -------------------------------------------------------

    def _ckpt_leaves(self, params: dict, opt_state: OptState, dims: bool):
        """``(checkpoint key, tensor, ZeRO dim, model dim)`` of every param
        and moment (the dims this rank's layout splits, or all None)."""
        out = [(f"params/{_ckpt_key(k)}", p,
                self.param_dims[k] if dims else None,
                self.model_dims[k] if dims else None)
               for k, p in params.items()]
        moments = [("mu", opt_state.mu)] + \
            ([("nu", opt_state.nu)] if opt_state.nu != () else [])
        for name, tree in moments:
            out += [(f"opt_state/{name}/{_ckpt_key(k)}", m,
                     self.opt_dims[k] if dims else None,
                     self.model_dims[k] if dims else None)
                    for k, m in tree.items()]
        return out

    def abstract_state(self) -> dict:
        """The restore template: every leaf of the checkpoint tree at its
        logical shape and dtype (tensors on the ``meta`` device, numpy for
        the host leaves), as ``repro/core/engine.py::abstract_state``."""
        params = model.init_params(self.cfg, device="meta")
        opt = self.optimizer.init(params)
        tree = {k: t for k, t, _, _ in self._ckpt_leaves(params, opt, False)}
        scalar = np.zeros((), np.int32)
        return dict(tree, **{"opt_state/step": scalar, "step": scalar,
                             "epoch": scalar, "batch_index": scalar,
                             "rng": np.zeros(2, np.uint32)})

    @property
    def _blocked(self) -> bool:
        """Whether checkpoints go as ``Blocks`` (a pipe or a model group)."""
        return self.pipe is not None or self.tp is not None

    def _blocks(self, key: str, shape, dim, mdim=None) -> list:
        """Under a pipe or a model group, the index ranges of this rank's
        blocks of the leaf ``key`` (logical ``shape``, ZeRO dimension
        ``dim``, model dimension ``mdim``): the model group's chunk of
        ``mdim``; the data group's chunk of ``dim`` where ZeRO splits it;
        under a pipe group a stacked leaf's chunks, each at its layer
        range."""
        ranges = [[0, int(n)] for n in shape]
        for d, group in ((dim, self.data), (mdim, self.tp)):
            if d is not None:
                n = shape[d] // group.size
                ranges[d] = [group.rank * n, (group.rank + 1) * n]
        if self.pipe is None or not is_stacked(key):
            return [ranges]
        return [[[lo, hi]] + ranges[1:] for lo, hi in self._chunks()]

    def _leaf_blocks(self, key: str, t: torch.Tensor, dim, mdim) -> Blocks:
        """Leaf ``key`` (this rank's tensor ``t``) as ``Blocks``: written
        by data rank 0 (and its ZeRO peers when ``dim`` splits it) of
        model rank 0 (and its peers when ``mdim`` splits it); under a pipe
        group by each stage for its layers, and a non-stacked leaf by stage
        0's ranks only."""
        shape = list(t.shape)
        if dim is not None:
            shape[dim] *= self.data.size
        if mdim is not None:
            shape[mdim] *= self.tp.size
        staged = self.pipe is not None and is_stacked(key)
        if staged:
            shape[0] = self.cfg.num_layers
        spec = [None] * len(shape)
        if dim is not None:
            spec[dim] = "data"
        if mdim is not None:
            spec[mdim] = "model"
        if staged:
            spec[0] = "pipe"
        writes = (dim is not None or self.data.rank == 0) and \
            (mdim is not None or self.tp is None or self.tp.rank == 0) and \
            (self.pipe is None or staged or self.pipe.rank == 0)
        parts = ()
        if writes:
            blocks = self._blocks(key, shape, dim, mdim)
            pieces = t.split([b[0][1] - b[0][0] for b in blocks]) \
                if staged else (t,)
            parts = tuple(zip(blocks, pieces))
        return Blocks(tuple(shape), t.dtype, parts, tuple(spec),
                      {"data": self.data.size,
                       "pipe": self.pipe.size if self.pipe else 1,
                       "model": self.tp.size if self.tp else 1})

    def checkpoint_tree(self, state: TrainState) -> dict:
        """The state as a checkpoint tree: each sharded leaf as this
        rank's chunk (``Sharded``), replicated tensors and host leaves whole
        (written by rank 0); under a pipe or a model group every tensor
        leaf as ``Blocks``."""
        leaves = self._ckpt_leaves(state.params, state.opt_state, True)
        if self._blocked:
            tree = {k: self._leaf_blocks(k, t, d, md)
                    for k, t, d, md in leaves}
        else:
            tree = {k: Sharded(t, d) if d is not None else t
                    for k, t, d, _ in leaves}
        return dict(tree, **{
            "opt_state/step": np.int32(state.opt_state.step),
            "step": np.int32(state.step), "epoch": np.int32(state.epoch),
            "batch_index": np.int32(state.batch_index),
            "rng": rng_to_key(state.rng)})

    def save_state(self, ckpt_dir: str, state: TrainState) -> str:
        """Synchronous save of the whole state (this rank's part), named
        by ``state.step``."""
        return save_checkpoint(ckpt_dir, state.step,
                               self.checkpoint_tree(state))

    def make_checkpointer(self) -> AsyncCheckpointer:
        """The async saver with the engine's in-flight bound and
        retention; the cadence is the caller's ``ckpt_every``."""
        return AsyncCheckpointer(max_in_flight=self.ecfg.ckpt_max_in_flight,
                                 keep_last_k=self.ecfg.ckpt_keep_last)

    def restore_state(self, ckpt_dir: str, step=None, state=None
                      ) -> TrainState:
        """Restore a saved state into THIS trainer's layout, whatever
        world and ZeRO stage wrote it: this rank reads only the shards that
        intersect its chunks, and the byte accounting is printed.

        ``step=None`` restores the newest VALID step (a torn or corrupt one
        falls back to the previous); an explicit ``step`` restores exactly
        that one. The values are copied into ``state``'s tensors (so a
        model built on ``state.params`` sees them), or into a fresh state
        on the trainer's device when ``state`` is None. A template mismatch
        raises ``KeyError``/``ValueError``."""
        if state is None:
            params = {k: torch.empty(p.shape, device=self.device)
                      for k, p in model.init_params(
                          self.cfg, device="meta").items()}
            state = self.init_state(params)
        like = self.abstract_state()
        leaves = self._ckpt_leaves(state.params, state.opt_state, True)
        dims = {k: self._blocks(k, like[k].shape, d, md) if self._blocked
                else d for k, _, d, md in leaves}
        if step is None:
            tree, step = restore_latest_valid(ckpt_dir, like, dims)
        else:
            tree = restore_checkpoint(ckpt_dir, step, like, dims)
        stats = last_restore_stats()
        mib = 1024 * 1024
        print(f"[ckpt] lazy restore: read {stats.read_bytes / mib:.1f} MiB "
              f"({stats.entries_read}/{stats.entries_total} shards) for a "
              f"{stats.partition_bytes / mib:.1f} MiB local partition of a "
              f"{stats.logical_bytes / mib:.1f} MiB logical state",
              flush=True)
        with torch.no_grad():
            for key, t, _, _ in leaves:
                if t.shape != tree[key].shape:
                    raise ValueError(f"{key}: restored {tuple(tree[key].shape)}"
                                     f" for a {tuple(t.shape)} tensor")
                t.copy_(tree[key])
        opt = state.opt_state._replace(step=int(tree["opt_state/step"]))
        return state.replace(opt_state=opt, step=int(tree["step"]),
                             epoch=int(tree["epoch"]),
                             batch_index=int(tree["batch_index"]),
                             rng=key_to_rng(tree["rng"]))

    # --- the step ------------------------------------------------------------

    def _finish_microbatch(self, mb, rng=None):
        """This rank's rows of one (global) microbatch, finished on the
        device (augmented with the seed ``rng``, or preprocessed). Each is
        finished one microbatch at a time, so one microbatch's fp32 images
        live at a time."""
        rows = None
        if self.data is not None:
            n = next(iter(mb.values())).shape[0]
            rows = rank_rows(n, self.data.rank, self.data.size)
        if self.aug is not None:
            gen = torch.Generator().manual_seed(rng)
            draws = draw_augment(gen, mb["images"].shape[0],
                                 self.cfg.image_size, self.aug)
            mb = augment_batch(draws, mb, self.aug, preproc=self.preproc,
                               resolution=self.cfg.image_size, rows=rows)
        else:
            if rows is not None:
                mb = {k: v[rows] for k, v in mb.items()}
            mb = device_preprocess(mb, self.preproc, self.cfg.image_size)
        return mb

    def _microbatch_loss(self, params, mb, rng=None):
        """Loss of this rank's rows of one (global) microbatch."""
        return model.loss_fn(self.cfg, params,
                             self._finish_microbatch(mb, rng),
                             self.forward_gather, self.forward_reduce)

    def _reduce_microbatch(self, grads: dict) -> dict:
        """ZeRO-2: each microbatch's mean gradient reduce-scattered into
        the shard (all-reduced for a replicated leaf)."""
        w = self.data
        shard = [k for k in grads if self.opt_dims[k] is not None]
        rest = [k for k in grads if self.opt_dims[k] is None]
        out = dict(zip(shard, w.reduce_scatter_many(
            [grads[k] for k in shard], [self.opt_dims[k] for k in shard])))
        w.all_reduce_many([grads[k] for k in rest], "mean")
        return {k: out[k].div_(w.size) if k in out else grads[k]
                for k in grads}

    def _reduce_sq(self, sq: dict) -> dict:
        """The optimizer's reducer: sums of squares over the data group for
        the leaves the update sees in chunks, over the pipe group for the
        stage-local stacked leaves and over the model group for the leaves
        the model axis splits; a replicated leaf is counted once."""
        for group, keys in (
                (self.data, [k for k in sq if self.opt_dims[k] is not None]),
                (self.pipe, [k for k in sq if is_stacked(k)]),
                (self.tp, [k for k in sq
                           if self.model_dims[k] is not None])):
            if group is None or not keys:
                continue
            total = group.all_reduce(torch.stack([sq[k] for k in keys]),
                                     "sum")
            sq = dict(sq, **dict(zip(keys, total.unbind())))
        return sq

    def _check_batch(self, batch: dict) -> None:
        """Raise, on every rank and before any collective, on a batch the
        accumulation steps and the world do not divide."""
        n = next(iter(batch.values())).shape[0]
        accum = self.ecfg.gradient_accumulation_steps
        if n % accum:
            raise ValueError(f"batch {n} not divisible by accum {accum}")
        if self.data is not None:
            rank_rows(n // accum, self.data.rank, self.data.size)

    def grads(self, params: dict, batch: dict, rngs=None):
        """Mean fp32 grads and mean metrics of one device batch, taken
        with respect to the compute view of ``params``. ``rngs``: the
        microbatches' augmentation seeds (needed with ``aug``). Under data
        parallelism both are means over the world, and the grads of leaves
        whose optimizer state is sharded come back as this rank's chunk
        under ZeRO 2 and 3 (whole under 0 and 1). With
        ``pipeline_stages`` > 1 they come from the 1F1B pipeline
        (:meth:`_pipeline_grads`, with the model group installed around
        the executor as around the plain path). Under a model group each
        is this rank's model chunk (the ``model_summed`` leaves' summed
        over the group: a stacked one's stage-local rows under a pipe
        group). Under Ulysses (:attr:`ulysses`) every gradient but a split
        expert's is whole, summed over the model group but for
        ``ulysses.whole``'s leaves, and a decoder's or HuBERT's metrics
        are summed over the group (each rank's loss is its rows' share)."""
        if self.aug is not None and rngs is None:
            raise ValueError("augmented training needs the microbatch "
                             "seeds (rngs)")
        self._check_batch(batch)
        if self.param_dims is None:
            self._layout(params)
        with self.group_context():
            grads, metrics = self._pipeline_grads(params, batch, rngs) \
                if self.ecfg.pipeline_stages > 1 else \
                self._data_grads(params, batch, rngs)
        if self.model_summed:
            self.tp.all_reduce_many([grads[k] for k in self.model_summed],
                                    "sum")
        if self.ulysses and self.cfg.arch_type != "vit":
            keys = list(metrics)
            total = self.tp.all_reduce(torch.stack(
                [metrics[k].to(torch.float32) for k in keys]), "sum")
            metrics = dict(zip(keys, total.unbind()))
        return grads, metrics

    def _data_grads(self, params: dict, batch: dict, rngs):
        """:meth:`grads` without the pipeline: accumulated over the
        microbatches, reduced over the data group."""
        view = {k: p.detach().requires_grad_()
                for k, p in compute_params(params, self.ecfg).items()}
        stage, w = self.ecfg.zero_stage, self.data
        grads, metrics = accumulate_gradients(
            self._microbatch_loss, view, batch,
            self.ecfg.gradient_accumulation_steps, rngs=rngs,
            reduce=self._reduce_microbatch
            if w is not None and stage == 2 else None)
        if w is None:
            return grads, metrics
        # stages 0 and 1, and the leaves ZeRO-3 keeps replicated: all-reduce
        w.all_reduce_many([g for k, g in grads.items() if stage < 2 or
                           stage == 3 and self.param_dims[k] is None],
                          "mean")
        keys = list(metrics)
        mean = w.all_reduce(torch.stack([metrics[k].to(torch.float32)
                                         for k in keys]), "mean")
        return grads, dict(zip(keys, mean.unbind()))

    def _pipeline_grads(self, params: dict, batch: dict, rngs):
        """``grads`` through ``pipelined_value_and_grad`` (the reference's
        ``_pipeline_grads``): the same microbatches, seeds and finishing as
        the data-parallel path. The executor's gradients are local: the
        stacked leaves' this stage's (a ZeRO-3 shard's averaged over the
        data group by the gather's backward), the non-stacked ones this
        rank's share, whole. So the non-stacked gradients and the metrics
        are summed over the pipe group, then every gradient takes the data
        group's mean under its ZeRO stage. Under a model group (installed
        by :meth:`grads`) the pipe group joins the ranks of one model
        index, so each sum runs between the ranks that hold the same
        model chunks."""
        e = self.ecfg
        stage, d = e.zero_stage, self.data
        view = {k: p.detach() for k, p in compute_params(params, e).items()}
        gather = self.forward_gather
        if gather is not None:
            # ZeRO-3: the non-stacked leaves whole, once a step
            rest = {k: p for k, p in view.items() if not is_stacked(k)}
            view = dict(view, **self._whole(rest, self.param_dims))
        (_, metrics), grads = pipeline.pipelined_value_and_grad(
            self.cfg, view, batch, stages=e.pipeline_stages,
            num_micro=e.gradient_accumulation_steps,
            interleave=e.pipeline_interleave, rngs=rngs,
            microbatch_fn=self._finish_microbatch,
            schedule_out=self.schedule_out, pipe=self.pipe, gather=gather,
            reduce=self.forward_reduce)
        keys = list(metrics)
        values = torch.stack([metrics[k].to(torch.float32) for k in keys])
        if self.pipe is not None:
            self.pipe.all_reduce_many(
                [g for k, g in grads.items() if not is_stacked(k)], "sum")
            self.pipe.all_reduce(values, "sum")
        if d is not None:
            if stage == 3:
                # the non-stacked shards' gradients came back whole
                shard = [k for k in grads if not is_stacked(k)
                         and self.param_dims[k] is not None]
                parts = d.reduce_scatter_many(
                    [grads[k] for k in shard],
                    [self.param_dims[k] for k in shard])
                grads.update({k: g.div_(d.size)
                              for k, g in zip(shard, parts)})
                d.all_reduce_many([g for k, g in grads.items()
                                   if self.param_dims[k] is None], "mean")
            elif stage == 2:
                grads = self._reduce_microbatch(grads)
            else:
                d.all_reduce_many(list(grads.values()), "mean")
            d.all_reduce(values, "mean")
        return grads, dict(zip(keys, values.unbind()))

    def _step_rngs(self, state: TrainState) -> list:
        """The augmentation seeds of ``state.step``'s microbatches."""
        return [step_seed(state.rng, state.step, i)
                for i in range(self.ecfg.gradient_accumulation_steps)]

    def train_step(self, state: TrainState, batch: dict):
        """``(state, device batch) -> (state, metrics)``; under data
        parallelism ``batch`` is the global batch, the same on every rank.
        Metrics: ``loss``, ``acc``, ``moe_aux`` (0-dim tensors),
        ``grad_norm`` (before the clip, a tensor), ``lr`` and ``step_ok``
        (Python numbers).

        The anomaly guard (``engine.py:361-379``): a non-finite loss or
        grad-norm drops the update, so params, optimizer state and step
        stay bitwise unchanged and ``step_ok`` is 0. Deciding it reads the
        two scalars on the host once per step, as the reference's loop
        does. The data cursor passes through; the host loop rolls it."""
        grads, metrics = self.grads(
            state.params, batch,
            self._step_rngs(state) if self.aug is not None else None)
        lr = self.schedule(state.step)
        dp = self.data is not None
        if dp and self.ecfg.zero_stage == 1:
            grads = self._opt_view(grads)
        reduce = self._reduce_sq if dp else None
        gnorm = global_norm(grads, reduce)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        ok = True
        if self.ecfg.guard_anomalies:
            ok = bool(torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm))
            metrics["step_ok"] = int(ok)
        if not ok:
            return state, metrics
        # the update goes in place, a leaf at a time: no second copy of the
        # params or the moments (a ZeRO 1-2 rank writes its chunk of each
        # sharded leaf, then gathers the leaf whole)
        params = self._opt_view(state.params) if dp else state.params
        with torch.no_grad():
            opt_state = self.optimizer.apply(grads, state.opt_state, params,
                                             lr, gnorm, reduce=reduce)
            if dp and self.ecfg.zero_stage in (1, 2):
                whole = self._whole(params, self.opt_dims)
                for k, p in state.params.items():
                    p.copy_(whole[k])
        return state.replace(opt_state=opt_state, step=state.step + 1), \
            metrics


class Evaluator:
    def __init__(self, cfg, vit: model.ViT, *, ecfg: EngineConfig = None,
                 preproc=None, device="cuda", trainer: Trainer = None):
        """``trainer``: the ``Trainer`` whose state ``vit`` holds, the one
        source of the state's layout. On a world the eval is data-parallel
        over its data group (each rank its rows of every batch, the counts
        summed over the ranks), a ZeRO-3 state's chunks are gathered by
        its ``forward_gather`` and a pipeline stage's layers by its
        ``pipe_whole`` (each rank of the pipe group then computes the same
        rows). None: ``vit`` holds every param whole."""
        if cfg.arch_type != "vit":
            raise NotImplementedError(
                f"{cfg.name}: the eval loop counts classes; only the vit "
                f"branch has one")
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        self.preproc = preproc
        self.trainer = trainer
        self.world = trainer.data if trainer is not None else None
        self.device = self.world.device if self.world is not None else \
            resolve_device(device)
        self.model = vit.to(self.device)

    def _compute_params(self):
        params = self.model.params()
        if self.trainer is not None:
            params = self.trainer.pipe_whole(params)
        return compute_params(params, self.ecfg)

    def _preprocess_batch(self, batch):
        """Upsample and normalise a uint8 batch on the device. A uint8
        batch without ``preproc`` raises in ``device_preprocess``; the
        reference skips the call then and passes the batch through
        untouched (``engine.py:295-296``), which its own docs call a wiring
        error."""
        return device_preprocess(batch, self.preproc, self.cfg.image_size)

    def to_device(self, batch) -> dict:
        return to_device(batch, self.device)

    def logits(self, batch):
        """Forward of one device batch (preprocessed here), under the
        trainer's model group (whole logits on every model rank)."""
        group = self.trainer.group_context() if self.trainer is not None \
            else contextlib.nullcontext()
        with torch.inference_mode(), group:
            batch = self._preprocess_batch(batch)
            gather = self.trainer.forward_gather \
                if self.trainer is not None else None
            return model.forward(self.cfg, self._compute_params(), batch,
                                 gather, mode="eval")[0]

    def eval_step(self, batch):
        """No-grad ``batch -> {top1, top5, count, loss_sum}`` tensors."""
        with torch.inference_mode():
            logits = self.logits(batch)
            return model.classification_counts(logits, batch["labels"],
                                               batch.get("mask"))

    def _local(self, batch):
        """This rank's rows of a host batch."""
        if self.world is None:
            return batch
        n = next(iter(batch.values())).shape[0]
        rows = rank_rows(n, self.world.rank, self.world.size)
        return {k: v[rows] for k, v in batch.items()}

    def evaluate(self, batches) -> dict:
        """Eval loop over (padded) host batches, e.g.
        ``CIFARSource.eval_batches(b)``: exact counts and derived rates.
        Under data parallelism the integer counts are summed over the
        ranks as int64 and the NLL sum as fp32, batch by batch."""
        top1 = top5 = count = 0
        loss_sum = 0.0
        for batch in batches:
            m = self.eval_step(self.to_device(self._local(batch)))
            counts = torch.stack([m["top1"], m["top5"], m["count"]])
            nll = m["loss_sum"].to(torch.float32).reshape(1)
            if self.world is not None:
                self.world.all_reduce(counts, "sum")
                self.world.all_reduce(nll, "sum")
            t1, t5, c = counts.tolist()
            top1 += t1
            top5 += t5
            count += c
            loss_sum += float(nll)
        n = max(count, 1)
        return {
            "eval_top1_count": top1, "eval_top5_count": top5,
            "eval_count": count,
            "eval_acc": top1 / n, "eval_top5_acc": top5 / n,
            "eval_loss": loss_sum / n,
        }


def greedy(logits) -> torch.Tensor:
    """The greedy next token (B, 1) int32 of logits (B, S, vocab): the
    argmax at the last position, ties to the lower id as ``jnp.argmax``."""
    return logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)


class Server:
    """Prefill and greedy decode of a decoder (fp32 masters, cast to
    ``cfg.dtype`` where used), on one device or as one rank of a data x
    model layout of ``world`` (``launch/mesh.py::make_layout(world, 1,
    model_axis)``, a collective: every rank builds its ``Server``).

    Across ranks (the reference's ``DistributedEngine.jit_prefill`` and
    ``jit_decode_step``, ``repro/core/engine.py:540-568``): data rank d
    serves rows ``[d·B/dp, (d+1)·B/dp)`` of every batch leaf and holds
    only those rows of the cache (a batch the data ranks do not divide is
    served whole by each, and :meth:`gather_rows` keeps data rank 0's, as
    the reference's ``_sanitize`` replicates it); the M ranks of a model group split each
    layer as training does (``core/sharding.py::model_dims``) and cache
    their own heads of attention K and V (``cache_dims``, ROADMAP
    deviation D9), their heads of RWKV6's and Mamba2's states, and their
    rows of MLA's latents where M divides the cache's rows
    (``latents_split``: decode is then a distributed flash-decoding over
    the group, ``models/attention.py::mla_block``). Only this
    rank's parts of the host params are copied to its device. The logits
    of a vocabulary split over the model group are gathered whole before
    the greedy token is taken, so every rank of a group decodes the same
    tokens. ``embed_sharding`` lays out the token embedding as the
    ``Trainer``'s ``ecfg.embed_sharding`` does: under "dmodel" a model
    rank holds its feature columns, and a tied head gives whole logits."""

    def __init__(self, cfg, params: dict, *, device="cuda", world=None,
                 model_axis: int = 1, embed_sharding: str = "vocab"):
        if not cfg.supports_decode():
            raise ValueError(f"{cfg.name} has no decode step")
        if world is None and model_axis > 1:
            raise ValueError(f"model_axis {model_axis} needs a world of "
                             f"ranks")
        check_model_axis(cfg, model_axis)
        check_embed_sharding(embed_sharding)
        self.cfg = cfg
        self.data = self.tp = None
        if world is not None:
            layout = make_layout(world, 1, model_axis)
            self.data, self.tp = layout.data, layout.model
            self.device = world.device
        else:
            self.device = resolve_device(device)
        self.model = model_axis
        shapes = {k: v.shape for k, v in params.items()}
        self.model_dims = model_dims(shapes, cfg, model_axis,
                                     embed_sharding) \
            if self.tp is not None else dict.fromkeys(shapes)

        def local(k, v):
            d = self.model_dims[k]
            if d is None:
                return v.to(self.device)
            return self.tp.chunk(v, d).to(self.device, copy=True)
        self.params = {k: local(k, v) for k, v in params.items()}
        self.batch = None
        # the last init_cache's MLA latents split on the sequence
        self.latents = False
        # the data ranks the batch's rows are split over (1: each serves
        # every row)
        self.row_split = self.dp

    @property
    def dp(self) -> int:
        return self.data.size if self.data is not None else 1

    def init_cache(self, batch: int, max_len: int, dtype=None) -> dict:
        """This rank's part of a zero cache of ``batch`` sequences (the
        whole batch; a data rank holds ``batch / dp`` rows, or every row
        where dp does not divide ``batch``) in ``dtype`` (the compute dtype
        by default): MLA's latents, where the model axis divides
        ``max_len``, as this model rank's ``max_len / M`` rows (the
        prefill and decode calls after it take the cache so)."""
        check_serving(self.cfg, batch, self.dp, self.model)
        self.batch = batch
        self.row_split = serving_rows(batch, self.dp)
        cache = model.init_cache(
            self.cfg, batch, max_len, device=self.device,
            dtype=dtype or model.compute_dtype(self.cfg),
            data=self.row_split, model=self.model)
        self.latents = any(leaves["c_kv"].shape[2] != max_len
                           for leaves in cache.values() if "c_kv" in leaves)
        return cache

    def _rows(self, t):
        """This data rank's rows of ``t``, a leaf of the whole batch (a
        leaf of this rank's rows passes as it is)."""
        if self.row_split == 1 or t.shape[0] != self.batch:
            return t
        return t[rank_rows(t.shape[0], self.data.rank, self.dp)]

    def _whole(self, logits):
        """``logits`` with a vocabulary split over the model group
        gathered whole."""
        if logits.shape[-1] == self.cfg.vocab_size:
            return logits
        return shardctx.gather_from_model(logits)

    def prefill(self, batch: dict, cache: dict):
        """``batch["tokens"]`` (B, S) (and a vlm's ``image_embeds``,
        ``positions``; the whole batch, or this data rank's rows) into
        ``cache`` at rows 0..S-1 -> (logits of the last position, this
        data rank's rows, the vocabulary whole (B/dp, 1, vocab), the
        cache)."""
        batch = to_device({k: self._rows(v) for k, v in batch.items()},
                          self.device)
        with torch.inference_mode(), shardctx.use(self.tp, self.latents):
            logits, cache, _ = model.forward(
                self.cfg, self.params, batch, mode="prefill", cache=cache)
            return self._whole(logits[:, -1:]), cache

    def decode_logits(self, cache: dict, token, index: int):
        """One token a sequence, ``token`` (B, 1) (the whole batch, or this
        data rank's rows), at position ``index`` -> (the logits of this
        data rank's rows, the vocabulary whole (B/dp, 1, vocab), the
        cache)."""
        token = self._rows(token).to(self.device)
        with torch.inference_mode(), shardctx.use(self.tp, self.latents):
            logits, cache, _ = model.forward(
                self.cfg, self.params, {"token": token, "index": int(index)},
                mode="decode", cache=cache)
            return self._whole(logits), cache

    def decode_step(self, cache: dict, token, index: int):
        """One token a sequence, ``token`` (B, 1), at position ``index``
        -> (the greedy next token of this data rank's rows (B/dp, 1)
        int32, the cache)."""
        logits, cache = self.decode_logits(cache, token, index)
        return greedy(logits), cache

    def gather_rows(self, t):
        """``t`` of this data rank's rows gathered whole over the data
        ranks, in row order (the data ranks' generated tokens); where each
        data rank served every row, data rank 0's."""
        if self.dp == 1:
            return t
        rows = self.data.all_gather_many([t.contiguous()], [0])[0]
        return rows if self.row_split > 1 else rows[:t.shape[0]]
