"""On-device finish of a host uint8 batch (upsample, then normalise) and
the training augmentations: random crop, horizontal flip and Mixup/CutMix
with soft labels (``repro.data.augment``).

Each random function of the reference is split in two: a draw from an
explicit CPU ``torch.Generator`` (``draw_*``; JAX's threefry and torch's
generators never agree, so the tests feed the reference's own draws to the
apply half) and an apply on the device. The order is the reference's:
upsample the uint8 images, crop and flip at the model resolution, normalise,
then mix in fp32; the soft labels use the realised CutMix fraction.

Per-step randomness: the microbatch's generator is seeded with
``step_seed(state.rng, step, microbatch)``, so the stream is pure in those
three numbers, the same on every rank, and replays after a resume. Under
data parallelism each rank draws for the whole global microbatch and
applies the draws to its own rows (``rows``); a Mixup/CutMix partner row
that another rank owns comes from the global microbatch, which every rank
holds.
"""
from __future__ import annotations

import math
import struct
import zlib
from dataclasses import dataclass
from typing import Optional

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


@dataclass(frozen=True)
class AugmentConfig:
    """The augmentation recipe (``repro/data/augment.py:42-68``, same
    fields and defaults)."""
    num_classes: int
    crop_pad: int = 4           # zero-pad each side, then random crop back
    flip: bool = True           # horizontal flip with p=0.5
    mixup_alpha: float = 0.2    # Beta(a, a) mixing weight; 0 disables
    cutmix_alpha: float = 1.0   # Beta(a, a) box area; 0 disables
    mix_prob: float = 0.5       # probability a batch is mixed at all
    switch_prob: float = 0.5    # P(cutmix | mixing) when both enabled

    @property
    def mixing(self) -> bool:
        return self.mixup_alpha > 0.0 or self.cutmix_alpha > 0.0

    def validate(self):
        if self.num_classes <= 0:
            raise ValueError(
                f"AugmentConfig.num_classes must be positive: "
                f"{self.num_classes} (soft labels need the class count)")
        if self.crop_pad < 0:
            raise ValueError(f"crop_pad must be >= 0: {self.crop_pad}")
        return self


def step_seed(rng: int, step: int, microbatch: int) -> int:
    """The generator seed of one microbatch's augmentation: crc32 over the
    packed (tag, base seed, step, microbatch), the same in every process.
    The tag keeps it apart from ``pipeline.batch_seed`` of the same
    numbers."""
    return zlib.crc32(struct.pack("<4sqqq", b"aug\0", rng, step,
                                  microbatch)) % (2 ** 31)


# --- draws (CPU generator, host scalars and small index tensors) ----------

def _uniform(gen) -> float:
    """One draw in (0, 1]."""
    return 1.0 - float(torch.rand((), generator=gen, dtype=torch.float64))


def _gamma(gen, a: float) -> float:
    """Gamma(a, 1) by Marsaglia and Tsang (2000), boosted by U^(1/a) below
    a = 1."""
    if a < 1.0:
        return _gamma(gen, a + 1.0) * _uniform(gen) ** (1.0 / a)
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = float(torch.randn((), generator=gen, dtype=torch.float64))
        v = (1.0 + c * x) ** 3
        if v > 0.0 and math.log(_uniform(gen)) < \
                0.5 * x * x + d - d * v + d * math.log(v):
            return d * v


def draw_beta(gen, a: float) -> float:
    """Beta(a, a) as G1 / (G1 + G2), rounded to fp32 as the reference's
    ``jax.random.beta`` returns it."""
    while True:
        g1, g2 = _gamma(gen, a), _gamma(gen, a)
        if g1 + g2 > 0.0:
            return float(torch.tensor(g1 / (g1 + g2), dtype=torch.float32))


def draw_crop(gen, n: int, pad: int) -> Optional[torch.Tensor]:
    """(n, 2) int64 (row, column) offsets in ``[0, 2 * pad]``; None for
    ``pad == 0`` (no crop)."""
    if pad == 0:
        return None
    return torch.randint(0, 2 * pad + 1, (n, 2), generator=gen)


def draw_flip(gen, n: int) -> torch.Tensor:
    """(n,) bool, each True with p = 0.5."""
    return torch.rand(n, generator=gen) < 0.5


@dataclass(frozen=True)
class MixDraws:
    """One batch-level Mixup-or-CutMix draw (timm convention)."""
    perm: torch.Tensor      # (n,) int64: row i mixes with row perm[i]
    use_cutmix: bool
    lam_mix: float          # Mixup weight ~ Beta(mixup_alpha)
    lam_cut: float          # CutMix area draw ~ Beta(cutmix_alpha)
    box_y: int              # CutMix box centre, in [0, h)
    box_x: int              # ... and in [0, w)
    apply: bool             # mix at all (p = mix_prob)


def draw_mix(gen, n: int, h: int, w: int, acfg: AugmentConfig) -> MixDraws:
    perm = torch.randperm(n, generator=gen)
    switch = _uniform(gen) <= acfg.switch_prob
    use_cutmix = (switch and acfg.cutmix_alpha > 0.0) \
        if acfg.mixup_alpha > 0.0 else acfg.cutmix_alpha > 0.0
    lam_mix = draw_beta(gen, acfg.mixup_alpha or 1.0)
    lam_cut = draw_beta(gen, acfg.cutmix_alpha or 1.0)
    box_y = int(torch.randint(0, h, (), generator=gen))
    box_x = int(torch.randint(0, w, (), generator=gen))
    return MixDraws(perm, use_cutmix, lam_mix, lam_cut, box_y, box_x,
                    _uniform(gen) <= acfg.mix_prob)


@dataclass(frozen=True)
class AugmentDraws:
    """Every draw of one microbatch's augmentation; None where the recipe
    leaves a step out."""
    crop: Optional[torch.Tensor]
    flip: Optional[torch.Tensor]
    mix: Optional[MixDraws]


def draw_augment(gen, n: int, resolution: int,
                 acfg: AugmentConfig) -> AugmentDraws:
    """The draws for a microbatch of ``n`` rows at the model resolution,
    in a fixed order: crop offsets, flips, then the mix."""
    crop = draw_crop(gen, n, acfg.crop_pad)
    flip = draw_flip(gen, n) if acfg.flip else None
    mix = draw_mix(gen, n, resolution, resolution, acfg) \
        if acfg.mixing else None
    return AugmentDraws(crop, flip, mix)


# --- applies (on the images' device) --------------------------------------

def random_crop(images: torch.Tensor, offsets, pad: int) -> torch.Tensor:
    """Zero-pad (B, H, W, C) by ``pad`` on each side, then crop each image
    back at its (row, column) offset; label-invariant by construction."""
    if pad == 0:
        return images
    b, h, w, _ = images.shape
    padded = torch.nn.functional.pad(images, (0, 0, pad, pad, pad, pad))
    offsets = offsets.to(images.device)
    rows = offsets[:, 0, None] + torch.arange(h, device=images.device)
    cols = offsets[:, 1, None] + torch.arange(w, device=images.device)
    return padded[torch.arange(b, device=images.device)[:, None, None],
                  rows[:, :, None], cols[:, None, :]]


def random_flip(images: torch.Tensor, flips) -> torch.Tensor:
    """Horizontal flip of the images whose ``flips`` entry is True."""
    flips = flips.to(images.device)
    return torch.where(flips[:, None, None, None], images.flip(2), images)


def _cutmix_mask(h: int, w: int, lam: float, box_y: int, box_x: int,
                 device=None):
    """The box covering a fraction ``1 - lam`` of the image around its
    centre, clipped at the borders: (mask (h, w) fp32 with 1 inside the
    box, realised box fraction as an fp32 0-dim tensor)."""
    f32 = torch.float32
    cut = torch.sqrt(1.0 - torch.tensor(lam, dtype=f32))
    bh = int(torch.round(cut * h))
    bw = int(torch.round(cut * w))
    y0, y1 = min(max(box_y - bh // 2, 0), h), \
        min(max(box_y + (bh + 1) // 2, 0), h)
    x0, x1 = min(max(box_x - bw // 2, 0), w), \
        min(max(box_x + (bw + 1) // 2, 0), w)
    mask = torch.zeros((h, w), dtype=f32, device=device)
    mask[y0:y1, x0:x1] = 1.0
    frac = torch.tensor((y1 - y0) * (x1 - x0), dtype=f32) / \
        torch.tensor(h * w, dtype=f32)
    return mask, frac.to(device)


def mix_batch(images, onehot, images2, onehot2, mix: MixDraws):
    """Mixup or CutMix of ``images`` (B, H, W, C) fp32 with their partners
    ``images2`` (the rows ``mix.perm`` names, already cropped, flipped and
    normalised), and of their one-hot labels. Returns (images, soft
    labels); unmixed when ``mix.apply`` is False."""
    if not mix.apply:
        return images, onehot
    f32 = torch.float32
    if mix.use_cutmix:
        _, h, w, _ = images.shape
        box, frac = _cutmix_mask(h, w, mix.lam_cut, mix.box_y, mix.box_x,
                                 images.device)
        out = images * (1.0 - box)[None, :, :, None] + \
            images2 * box[None, :, :, None]
        lam = 1.0 - frac
    else:
        lam = torch.tensor(mix.lam_mix, dtype=f32, device=images.device)
        out = lam * images + (1.0 - lam) * images2
    return out, lam * onehot + (1.0 - lam) * onehot2


def _geometric(images, idx, draws: AugmentDraws, acfg, preproc,
               resolution):
    """Rows ``idx`` (a CPU index tensor) of ``images``: upsampled (uint8),
    cropped, flipped, then normalised (uint8), with those rows' draws."""
    x = images[idx.to(images.device)]
    was_uint8 = x.dtype == torch.uint8
    if was_uint8:
        x = upsample(x, resolution or x.shape[1])
    if draws.crop is not None:
        x = random_crop(x, draws.crop[idx], acfg.crop_pad)
    if draws.flip is not None:
        x = random_flip(x, draws.flip[idx])
    if was_uint8:
        x = normalize(x, preproc)
    return x


def augment_batch(draws: AugmentDraws, batch: dict, acfg: AugmentConfig, *,
                  preproc=None, resolution: int = 0, rows=None) -> dict:
    """Train-time augmentation of a microbatch with its ``draws``.

    ``batch``: ``{"images": (B, H, W, 3), "labels": (B,) int}``, the whole
    (global) microbatch the draws were made for; ``rows`` (a slice or index
    tensor, default all) picks the rows to return. Images come out at the
    model resolution, normalised fp32 when they came in uint8 (``preproc``
    is required then); labels become soft ``(rows, num_classes)`` fp32 when
    mixing is enabled and stay hard ints otherwise."""
    images = batch["images"]
    if images.dtype == torch.uint8 and preproc is None:
        raise ValueError(
            "augment_batch on a uint8 batch needs preproc= (the dataset's "
            "mean/std) for the post-crop normalize")
    n = images.shape[0]
    idx = torch.arange(n)[rows if rows is not None else slice(None)]
    out = dict(batch)
    out["labels"] = batch["labels"][idx.to(batch["labels"].device)]
    out["images"] = _geometric(images, idx, draws, acfg, preproc,
                               resolution)
    if draws.mix is None:
        return out
    labels = batch["labels"].long()
    partner = draws.mix.perm[idx]

    def onehot(i):
        return torch.nn.functional.one_hot(
            labels[i.to(labels.device)], acfg.num_classes).to(torch.float32)
    images2 = _geometric(images, partner, draws, acfg, preproc,
                         resolution) if draws.mix.apply else None
    out["images"], out["labels"] = mix_batch(
        out["images"], onehot(idx), images2, onehot(partner), draws.mix)
    return out
