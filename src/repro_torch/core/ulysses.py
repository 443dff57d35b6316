"""DeepSpeed-Ulysses sequence parallelism on the model axis (the
counterpart of ``repro/core/ulysses.py``; the paper's §V proposal to
partition ViTs "along the image-patches dimension").

The reference expresses Ulysses as GSPMD hints (``make_hints``): where the
model axis M divides both the query and the KV heads, the attention output
is re-constrained sequence-sharded, the weights keep tensor parallelism's
split, and the compiler places the all-to-alls; elsewhere it returns the
tensor-parallel hints. The port runs DeepSpeed-Ulysses itself (ROADMAP
deviation D8):

- every model rank holds every leaf whole (``model_dims`` None);
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
  model group (:func:`summed`), but for the leaves the ViT computes whole
  on every rank (its final norm and head).

The arithmetic is one device's, as the reference's. The MoE families,
MLA, RWKV6 and Mamba2 read no hint in the reference, so their Ulysses mode
is its tensor-parallel mode; the port keeps the TP layout for them too
(:func:`applies`).
"""
from __future__ import annotations

# the families whose attention the Ulysses layout runs (D8)
ULYSSES_ARCH_TYPES = ("vit", "dense", "vlm", "audio")


def supports(cfg) -> bool:
    """Whether the Ulysses layout covers ``cfg``'s family: one of
    :data:`ULYSSES_ARCH_TYPES` with plain attention blocks and no
    experts."""
    return cfg.arch_type in ULYSSES_ARCH_TYPES and \
        cfg.block_kind == "attn" and not cfg.has_moe


def applies(cfg, model: int, sequence_parallel: str) -> bool:
    """Whether the Ulysses layout runs: ``sequence_parallel`` "ulysses" on
    a model axis of ``model`` > 1 ranks that divides both the query and
    the (nonzero) KV heads (``make_hints``' ``q_ok and kv_ok``), for a
    family it :func:`supports`. Otherwise the run takes the
    tensor-parallel layout."""
    return (sequence_parallel == "ulysses" and model > 1 and supports(cfg)
            and cfg.num_heads % model == 0 and cfg.num_kv_heads > 0
            and cfg.num_kv_heads % model == 0)

def whole(key: str, cfg) -> bool:
    """Whether leaf ``key`` is computed whole on every model rank under
    the Ulysses layout, so its gradient is the same on each and is not
    summed: the ViT's final norm and head, taken after ``gather_seq``."""
    return cfg.arch_type == "vit" and key.startswith(("final_norm.",
                                                      "head."))

