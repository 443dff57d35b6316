"""DeepSpeed-Ulysses sequence parallelism on the model axis (the
counterpart of ``repro/core/ulysses.py``; the paper's §V proposal to
partition ViTs "along the image-patches dimension").

The reference expresses Ulysses as GSPMD hints (``make_hints``): where the
model axis M divides both the query and the KV heads, the attention output
is re-constrained sequence-sharded, the weights keep tensor parallelism's
split, and the compiler places the all-to-alls; elsewhere it returns the
tensor-parallel hints. The port runs DeepSpeed-Ulysses itself (ROADMAP
deviation D8):

- every model rank holds every leaf whole (``model_dims`` None), but an
  MoE's routed experts (below);
- the embedding runs whole, then each rank keeps its contiguous rows of
  the sequence (``models/shardctx.py::seq_split``: uneven where M does
  not divide S, as the ViT's 197 tokens; no padding);
- the norms, the MLP and the projections run on those rows; inside
  attention q, k and v go from rows to heads (``seq_to_heads``, an
  all-to-all), every rank attends over the whole sequence with its H/M
  query heads and KH/M KV heads, and the output goes back to rows
  (``heads_to_seq``) before ``wo``;
- a decoder's or HuBERT's head and loss run on the rank's rows, divided by
  the whole microbatch's count, so each rank's loss is a partial sum and
  the loss is their sum over the group; the ViT gathers its final rows
  (``gather_seq``) and takes the norm, the CLS head and the loss whole on
  every rank;
- each rank's gradient of a leaf is its rows' share, summed once over the
  model group (``Trainer.model_summed``), but for the leaves the ViT
  computes whole on every rank (its final norm and head) and the routed
  experts split below.

Granite-MoE (an "moe" family with plain attention blocks, ROADMAP 16.2b)
runs the same attention. The reference's Ulysses hints keep ``expert``
on the model axis, so its routed experts stay split on E: rank m holds
E/M of them (:func:`model_dims`, as tensor parallelism splits them; whole
where M does not divide E, F2). Its MoE gathers the rows over the group
(``shardctx.all_gather_seq``), routes every token of the data rank's
(B, S) at the capacity one process counts, runs this rank's experts and
reduce-scatters the partial sums back onto the rank's rows
(``shardctx.reduce_scatter_seq``; ``models/moe.py``). The load-balance
aux enters the loss on model rank 0 only, so the group's sum counts it
once.

The arithmetic is one device's, as the reference's. MLA, RWKV6 and
Mamba2 read no hint in the reference, so their Ulysses mode is its
tensor-parallel mode; the port keeps the TP layout for them too
(:func:`applies`).
"""
from __future__ import annotations

import re

from repro_torch.core.sharding import model_dims as tp_model_dims

# the families whose attention the Ulysses layout runs (D8); an "moe"
# family only with plain attention blocks (Granite-MoE, not MLA)
ULYSSES_ARCH_TYPES = ("vit", "dense", "vlm", "audio", "moe")
# the routed experts' leaves, split on E over the model group
_EXPERTS = re.compile(r"(^|\.)moe\.experts\.")


def supports(cfg) -> bool:
    """Whether the Ulysses layout covers ``cfg``'s family: one of
    :data:`ULYSSES_ARCH_TYPES` with plain attention blocks (so no MLA,
    RWKV6 or Mamba2)."""
    return cfg.arch_type in ULYSSES_ARCH_TYPES and cfg.block_kind == "attn"


def applies(cfg, model: int, sequence_parallel: str) -> bool:
    """Whether the Ulysses layout runs: ``sequence_parallel`` "ulysses" on
    a model axis of ``model`` > 1 ranks that divides both the query and
    the (nonzero) KV heads (``make_hints``' ``q_ok and kv_ok``), for a
    family it :func:`supports`. Otherwise the run takes the
    tensor-parallel layout."""
    return (sequence_parallel == "ulysses" and model > 1 and supports(cfg)
            and cfg.num_heads % model == 0 and cfg.num_kv_heads > 0
            and cfg.num_kv_heads % model == 0)


def model_dims(shapes: dict, cfg, model: int) -> dict:
    """``{key: the dimension split over the model group, or None}`` under
    the Ulysses layout: the routed experts' E axis, as tensor parallelism
    splits it (the reference's ``expert`` hint; whole where the model axis
    does not divide the experts, ``sharding.whole_blocks``); every other
    leaf whole."""
    tp = tp_model_dims(shapes, cfg, model)
    return {k: tp[k] if _EXPERTS.search(k) else None for k in shapes}


def whole(key: str, cfg) -> bool:
    """Whether leaf ``key`` is computed whole on every model rank under
    the Ulysses layout, so its gradient is the same on each and is not
    summed: the ViT's final norm and head, taken after ``gather_seq``."""
    return cfg.arch_type == "vit" and key.startswith(("final_norm.",
                                                      "head."))
