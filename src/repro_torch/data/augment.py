"""On-device finish of a host uint8 batch: upsample, then normalise.

The preprocessing half of ``repro.data.augment`` (``upsample``,
``normalize``, ``device_preprocess``). The random augmentations (crop,
flip, Mixup/CutMix) are training-only and come with the training slice.
"""
from __future__ import annotations

import torch


def upsample(images: torch.Tensor, resolution: int) -> torch.Tensor:
    """Nearest-neighbour upsample of (B, H, W, C) by an integer factor,
    dtype-preserving: uint8 stays uint8 until :func:`normalize`."""
    native = images.shape[1]
    if resolution == native:
        return images
    if resolution % native:
        raise ValueError(
            f"model resolution {resolution} not an integer multiple of "
            f"the native {native}px grid")
    k = resolution // native
    return images.repeat_interleave(k, dim=1).repeat_interleave(k, dim=2)


def normalize(images: torch.Tensor, preproc) -> torch.Tensor:
    """uint8 -> fp32 ``x * 1/(255*std) - mean/std`` (one multiply-add per
    pixel, the same constants as the reference)."""
    scale = torch.tensor([1.0 / (255.0 * s) for s in preproc.std],
                         dtype=torch.float32, device=images.device)
    bias = torch.tensor([-m / s for m, s in zip(preproc.mean, preproc.std)],
                        dtype=torch.float32, device=images.device)
    return images.to(torch.float32) * scale + bias


def device_preprocess(batch: dict, preproc, resolution: int) -> dict:
    """Upsample and normalise a uint8 ``images`` batch on its device.

    Float batches pass through untouched. A uint8 batch without
    ``preproc`` is a wiring error and raises."""
    img = batch.get("images")
    if img is None or img.dtype != torch.uint8:
        return batch
    if preproc is None:
        raise ValueError(
            "got a uint8 image batch but no normalization statistics — "
            "pass preproc=source.preproc so the on-device normalize knows "
            "the dataset's mean/std")
    out = dict(batch)
    out["images"] = normalize(upsample(img, resolution), preproc)
    return out
