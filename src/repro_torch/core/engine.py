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

A leaf that the world does not divide (``embed.cls``, ``stack.mlp.b_up``)
stays replicated: its gradient is all-reduced, every rank applies the same
whole update, and the norms count it once. The anomaly guard decides from
the all-reduced loss and the global grad norm, so every rank takes the same
branch; metrics are averaged over the ranks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import EngineConfig
from repro_torch.core.grad_accum import accumulate_gradients
from repro_torch.core.sharding import shard_dims
from repro_torch.data.augment import augment_batch, device_preprocess, \
    draw_augment, step_seed
from repro_torch.data.pipeline import rank_rows
from repro_torch.models import transformer as model
from repro_torch.optim import OptState, make_optimizer, make_schedule


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
                 device="cuda", aug=None, world=None):
        """``preproc``: the dataset's :class:`Preproc`, needed when batches
        come as uint8 (every dataset source ships them so); the fp32
        synthetic stream needs none. ``aug``: an ``AugmentConfig`` for
        train-time augmentation (ViT only). ``world``: a
        ``core.distributed.World`` for the data-parallel step under
        ``ecfg.zero_stage`` (its device is the rank's); None trains on one
        device without a process group."""
        ecfg.validate(world.size if world is not None else 1)
        if world is None and ecfg.zero_stage:
            raise ValueError(f"zero_stage {ecfg.zero_stage} needs a "
                             f"data-parallel world")
        if aug is not None and cfg.arch_type != "vit":
            raise ValueError(f"{cfg.name}: augmentation is for images")
        self.cfg = cfg
        self.ecfg = ecfg
        self.preproc = preproc
        self.aug = aug.validate() if aug is not None else None
        self.world = world
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

    # --- layout ---------------------------------------------------------

    def _layout(self, params: dict) -> None:
        """Which dimension of each leaf the params (``param_dims``, ZeRO-3)
        and the optimizer state (``opt_dims``, ZeRO 1-3) shard; all None on
        one device."""
        shapes = {k: p.shape for k, p in params.items()}
        size = self.world.size if self.world is not None else 1
        stage = self.ecfg.zero_stage
        self.param_dims = shard_dims(shapes, zero_stage=stage, world=size)
        self.opt_dims = shard_dims(shapes, zero_stage=stage, world=size,
                                   for_opt_state=True)

    def _opt_view(self, params: dict) -> dict:
        """The part of each leaf this rank's optimizer state covers: its
        chunk of a leaf whose state is sharded while the param is not
        (ZeRO 1-2), else the leaf (a ZeRO-3 param is its chunk already)."""
        return {k: self.world.chunk(p, self.opt_dims[k])
                if self.opt_dims[k] is not None
                and self.param_dims[k] is None else p
                for k, p in params.items()}

    def init_state(self, params: dict) -> TrainState:
        """A fresh state around ``params`` (e.g. ``ViT.params()``, whose
        tensors it then updates in place; every rank passes the same
        values). Under ZeRO-3 the state keeps this rank's chunk of each
        sharded leaf, and the caller's whole tensors can go."""
        self._layout(params)
        if self.ecfg.zero_stage == 3:
            params = {k: self.world.chunk(p, d).clone() if d is not None
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
        dims = [self.param_dims[k] - k.startswith("stack.") for k in keys]
        full = GatherShards.apply(self.world, dims,
                                  *[group[k] for k in keys])
        return dict(group, **dict(zip(keys, full)))

    @property
    def forward_gather(self):
        """``gather`` where the params are sharded (ZeRO-3), else None."""
        return self.gather if self.ecfg.zero_stage == 3 else None

    def _whole(self, tree: dict, dims: dict) -> dict:
        """``tree`` with each leaf that ``dims`` shards gathered whole."""
        keys = [k for k in tree if dims[k] is not None]
        full = self.world.all_gather_many([tree[k] for k in keys],
                                          [dims[k] for k in keys])
        return dict(tree, **dict(zip(keys, full)))

    def full_params(self, state: TrainState) -> dict:
        """Every param whole (a collective under ZeRO-3)."""
        if self.forward_gather is None:
            return state.params
        return self._whole(state.params, self.param_dims)

    def full_opt_state(self, state: TrainState) -> OptState:
        """The optimizer state with every moment whole (a collective under
        ZeRO 1-3)."""
        if self.world is None:
            return state.opt_state
        st = state.opt_state
        return OptState(st.step, self._whole(st.mu, self.opt_dims),
                        self._whole(st.nu, self.opt_dims)
                        if st.nu != () else ())

    # --- the step ------------------------------------------------------------

    def _microbatch_loss(self, params, mb, rng=None):
        """Loss of this rank's rows of one (global) microbatch. Each is
        finished on the device one microbatch at a time, so one
        microbatch's fp32 images live at a time."""
        rows = None
        if self.world is not None:
            n = next(iter(mb.values())).shape[0]
            rows = rank_rows(n, self.world.rank, self.world.size)
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
        return model.loss_fn(self.cfg, params, mb, self.forward_gather)

    def _reduce_microbatch(self, grads: dict) -> dict:
        """ZeRO-2: each microbatch's mean gradient reduce-scattered into
        the shard (all-reduced for a replicated leaf)."""
        w = self.world
        shard = [k for k in grads if self.opt_dims[k] is not None]
        rest = [k for k in grads if self.opt_dims[k] is None]
        out = dict(zip(shard, w.reduce_scatter_many(
            [grads[k] for k in shard], [self.opt_dims[k] for k in shard])))
        w.all_reduce_many([grads[k] for k in rest], "mean")
        return {k: out[k].div_(w.size) if k in out else grads[k]
                for k in grads}

    def _reduce_sq(self, sq: dict) -> dict:
        """The optimizer's reducer: sums of squares over the ranks for the
        leaves the update sees in chunks; a replicated leaf is counted
        once."""
        keys = [k for k in sq if self.opt_dims[k] is not None]
        if not keys:
            return sq
        total = self.world.all_reduce(torch.stack([sq[k] for k in keys]),
                                      "sum")
        return dict(sq, **dict(zip(keys, total.unbind())))

    def _check_batch(self, batch: dict) -> None:
        """Raise, on every rank and before any collective, on a batch the
        accumulation steps and the world do not divide."""
        n = next(iter(batch.values())).shape[0]
        accum = self.ecfg.gradient_accumulation_steps
        if n % accum:
            raise ValueError(f"batch {n} not divisible by accum {accum}")
        if self.world is not None:
            rank_rows(n // accum, self.world.rank, self.world.size)

    def grads(self, params: dict, batch: dict, rngs=None):
        """Mean fp32 grads and mean metrics of one device batch, taken
        with respect to the compute view of ``params``. ``rngs``: the
        microbatches' augmentation seeds (needed with ``aug``). Under data
        parallelism both are means over the world, and the grads of leaves
        whose optimizer state is sharded come back as this rank's chunk
        under ZeRO 2 and 3 (whole under 0 and 1)."""
        if self.aug is not None and rngs is None:
            raise ValueError("augmented training needs the microbatch "
                             "seeds (rngs)")
        self._check_batch(batch)
        if self.param_dims is None:
            self._layout(params)
        view = {k: p.detach().requires_grad_()
                for k, p in compute_params(params, self.ecfg).items()}
        stage, w = self.ecfg.zero_stage, self.world
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
        dp = self.world is not None
        if dp and self.ecfg.zero_stage == 1:
            grads = self._opt_view(grads)
        new_params, new_opt, gnorm = self.optimizer.update(
            grads, state.opt_state,
            self._opt_view(state.params) if dp else state.params, lr,
            reduce=self._reduce_sq if dp else None)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        ok = True
        if self.ecfg.guard_anomalies:
            ok = bool(torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm))
            metrics["step_ok"] = int(ok)
        if not ok:
            return state, metrics
        if dp and self.ecfg.zero_stage in (1, 2):
            new_params = self._whole(new_params, self.opt_dims)
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(new_params[k])
        return state.replace(opt_state=new_opt, step=state.step + 1), metrics


class Evaluator:
    def __init__(self, cfg, vit: model.ViT, *, ecfg: EngineConfig = None,
                 preproc=None, device="cuda", world=None, gather=None):
        """``world``: evaluate data-parallel, each rank its rows of every
        batch, the counts summed over the ranks. ``gather``: the
        ``Trainer.forward_gather`` of a ZeRO-3 state whose chunks ``vit``
        holds."""
        if cfg.arch_type != "vit":
            raise NotImplementedError(
                f"{cfg.name}: the eval loop counts classes; only the vit "
                f"branch has one")
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        self.preproc = preproc
        self.world = world
        self.gather = gather
        self.device = world.device if world is not None else \
            resolve_device(device)
        self.model = vit.to(self.device)

    def _compute_params(self):
        return compute_params(self.model.params(), self.ecfg)

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
        """Forward of one device batch (preprocessed here)."""
        with torch.inference_mode():
            batch = self._preprocess_batch(batch)
            return model.forward(self.cfg, self._compute_params(), batch,
                                 self.gather)

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
