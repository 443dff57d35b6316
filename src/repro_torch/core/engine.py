"""The single-card engine: the train step with gradient accumulation and
the anomaly guard, and the no-grad eval step (``repro/core/engine.py``).

``Trainer`` owns the optimizer and the LR schedule and runs
``train_step(state, batch)``: each microbatch is finished on the device
(upsample and normalise, ``device_preprocess``), goes forward and backward
through the compute view of the params (bf16 matrices under
``cast_params_bf16``), and the fp32 mean gradient feeds the hand-written
optimizer. ``Evaluator`` runs the eval loop under
``torch.inference_mode()``: each host batch (numpy, uint8 at the native
grid) goes to the device, is finished there, and yields integer
top-1/top-5/count plus an fp32 NLL sum, summed on the host so accuracy does
not depend on the batching. Both read the params through the same compute
view, so eval sees what training computes with.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import EngineConfig
from repro_torch.core.grad_accum import accumulate_gradients
from repro_torch.data.augment import device_preprocess
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
                 is accepted (so a ``ViT`` built on them sees every update)
    opt_state    ``OptState`` (fp32 moments)
    step         optimizer steps taken, also the LR-schedule position
    epoch, batch_index
                 the data cursor of the NEXT batch, rolled by the host loop
    rng          the base seed of per-step randomness; nothing in this
                 slice draws from it until augmentation is ported
    """
    params: dict
    opt_state: OptState
    step: int = 0
    epoch: int = 0
    batch_index: int = 0
    rng: int = 0

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


class Trainer:
    def __init__(self, cfg, ecfg: EngineConfig, *, preproc=None,
                 device="cuda"):
        """``preproc``: the dataset's :class:`Preproc`, needed when batches
        come as uint8 (every dataset source ships them so); the fp32
        synthetic stream needs none."""
        ecfg.validate(1)
        self.cfg = cfg
        self.ecfg = ecfg
        self.preproc = preproc
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(
            ecfg.optimizer, weight_decay=ecfg.weight_decay,
            grad_clip=ecfg.grad_clip)
        self.schedule = make_schedule(ecfg.lr_schedule, ecfg.lr,
                                      ecfg.warmup_steps, ecfg.total_steps)

    def init_state(self, params: dict) -> TrainState:
        """A fresh state around ``params`` (e.g. ``ViT.params()``, whose
        tensors it then updates in place)."""
        return TrainState(params=params,
                          opt_state=self.optimizer.init(params),
                          rng=self.ecfg.seed)

    def _microbatch_loss(self, params, mb):
        # per-microbatch preprocess: one microbatch's fp32 images live at
        # a time
        mb = device_preprocess(mb, self.preproc, self.cfg.image_size)
        return model.loss_fn(self.cfg, params, mb)

    def grads(self, params: dict, batch: dict):
        """Mean fp32 grads and mean metrics of one device batch, taken
        with respect to the compute view of ``params``."""
        view = {k: p.detach().requires_grad_()
                for k, p in compute_params(params, self.ecfg).items()}
        return accumulate_gradients(self._microbatch_loss, view, batch,
                                    self.ecfg.gradient_accumulation_steps)

    def train_step(self, state: TrainState, batch: dict):
        """``(state, device batch) -> (state, metrics)``. Metrics: ``loss``,
        ``acc``, ``moe_aux`` (0-dim tensors), ``grad_norm`` (before the
        clip, a tensor), ``lr`` and ``step_ok`` (Python numbers).

        The anomaly guard (``engine.py:361-379``): a non-finite loss or
        grad-norm drops the update, so params, optimizer state and step
        stay bitwise unchanged and ``step_ok`` is 0. Deciding it reads the
        two scalars on the host once per step, as the reference's loop
        does. The data cursor passes through; the host loop rolls it."""
        grads, metrics = self.grads(state.params, batch)
        lr = self.schedule(state.step)
        new_params, new_opt, gnorm = self.optimizer.update(
            grads, state.opt_state, state.params, lr)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        ok = True
        if self.ecfg.guard_anomalies:
            ok = bool(torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm))
            metrics["step_ok"] = int(ok)
        if not ok:
            return state, metrics
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(new_params[k])
        return state.replace(opt_state=new_opt, step=state.step + 1), metrics


class Evaluator:
    def __init__(self, cfg, vit: model.ViT, *, ecfg: EngineConfig = None,
                 preproc=None, device="cuda"):
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        self.preproc = preproc
        self.device = resolve_device(device)
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
            return model.forward(self.cfg, self._compute_params(), batch)

    def eval_step(self, batch):
        """No-grad ``batch -> {top1, top5, count, loss_sum}`` tensors."""
        with torch.inference_mode():
            logits = self.logits(batch)
            return model.classification_counts(logits, batch["labels"],
                                               batch.get("mask"))

    def evaluate(self, batches) -> dict:
        """Eval loop over (padded) host batches, e.g.
        ``CIFARSource.eval_batches(b)``: exact counts and derived rates."""
        top1 = top5 = count = 0
        loss_sum = 0.0
        for batch in batches:
            m = self.eval_step(self.to_device(batch))
            top1 += int(m["top1"])
            top5 += int(m["top5"])
            count += int(m["count"])
            loss_sum += float(m["loss_sum"])
        n = max(count, 1)
        return {
            "eval_top1_count": top1, "eval_top5_count": top5,
            "eval_count": count,
            "eval_acc": top1 / n, "eval_top5_acc": top5 / n,
            "eval_loss": loss_sum / n,
        }
