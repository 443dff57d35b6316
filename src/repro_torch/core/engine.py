"""The engine's no-grad eval step (``repro/core/engine.py:290-298, 440-512``).

``Evaluator`` holds a model on one device and runs the eval loop: each
host batch (numpy, uint8 at the native grid) goes to the device, is
upsampled and normalised there, runs the forward under
``torch.inference_mode()``, and yields integer top-1/top-5/count plus an
fp32 NLL sum. The counts are summed on the host, so accuracy does not
depend on the batching. Training, and with it ``TrainState``, comes with
the next slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import EngineConfig
from repro_torch.data.augment import device_preprocess
from repro_torch.models import transformer as model


def resolve_device(device) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; a missing card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no GPU; "
                           "pass device='cpu' (--device cpu) to run on the "
                           "CPU")
    return device


class Evaluator:
    def __init__(self, cfg, vit: model.ViT, *, ecfg: EngineConfig = None,
                 preproc=None, device="cuda"):
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        self.preproc = preproc
        self.device = resolve_device(device)
        self.model = vit.to(self.device)

    def _compute_params(self):
        """The compute view of the params: under ``cast_params_bf16`` the
        fp32 matrices (ndim >= 2) are cast to bf16, as training sees them."""
        params = self.model.params()
        if not self.ecfg.cast_params_bf16:
            return params
        return {k: p.to(torch.bfloat16)
                if p.dtype == torch.float32 and p.ndim >= 2 else p
                for k, p in params.items()}

    def _preprocess_batch(self, batch):
        """Upsample and normalise a uint8 batch on the device. A uint8
        batch without ``preproc`` raises in ``device_preprocess``; the
        reference skips the call then and passes the batch through
        untouched (``engine.py:295-296``), which its own docs call a wiring
        error."""
        return device_preprocess(batch, self.preproc, self.cfg.image_size)

    def to_device(self, batch) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.device, non_blocking=True)
                if isinstance(v, np.ndarray) else v.to(self.device)
                for k, v in batch.items()}

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
