"""Which dimension of each leaf ZeRO shards over the data axis, and which
tensor parallelism splits over the model axis (``repro/core/sharding.py``).

The reference maps DeepSpeed's stages to GSPMD PartitionSpecs over a
``data`` and a ``model`` mesh axis. Here a spec reduces to one number per
leaf and axis: the dimension split over that axis's ranks, or ``None``
(replicated). Rank r of an axis holds the r-th contiguous chunk of its
dimension, as ``NamedSharding`` lays it out, so a checkpoint can use the
reference's shard index maps. :func:`shard_dims` is the table with the
model axis left out (``tp=None``), :func:`model_dims` the one with the
data axis left out (``fsdp=None``): a leaf can be split on both, on
different dimensions (``stack.attn.wq`` (L, D, H·hd): data on D under
ZeRO-3, model on H·hd); a rank of model rank m and data rank d holds
chunk d of model chunk m.

  stage 0: params and optimizer state replicated (DDP, the paper's).
  stage 1: optimizer state sharded (``for_opt_state``), params replicated.
  stage 2: stage 1, and the gradients reduce-scattered into the shard.
  stage 3: the params sharded too, gathered a layer at a time on use.

Under pipeline parallelism (the reference's ``pipeline_axis``,
``sharding.py:111-158``) the stacked leaves are stage-local: a rank holds
the layers of its own chunks (:func:`stage_chunks`), and ZeRO shards those
over its stage's data group on the same dimension as above; the
non-stacked leaves (embed, positions, head, final norm) are replicated on
every stage.
"""
from __future__ import annotations

import re

_F = "data"         # the data-parallel axis in the tables below
_TP = "model"       # the tensor-parallel axis

# the families whose layers the model axis splits (DeepSeek's MLA, an
# "moe" family, among them)
TP_ARCH_TYPES = ("vit", "audio", "dense", "vlm", "moe", "ssm", "hybrid")


def _rules(fsdp, tp=None):
    """``repro/core/sharding.py:32-76``: (pattern on the slash-joined key,
    spec of the unstacked leaf), first match wins; the embedding in the
    reference's default "vocab" layout (Megatron's vocab-parallel)."""
    return [
        # --- MoE experts (leading E axis: expert parallel over tp) ---
        (r"experts/w_(gate|up)$", (tp, fsdp, None)),
        (r"experts/w_out$", (tp, None, fsdp)),
        (r"/router$", (fsdp, None)),
        # --- attention projections (Megatron column/row) ---
        (r"attn/w?[qkvg]$|attn/w_(uq|uk|uv)$", (fsdp, tp)),
        (r"attn/(wo|w_o)$", (tp, fsdp)),
        (r"attn/w_(dq|dkv)$", (fsdp, None)),
        (r"attn/b[qkv]$", (tp,)),
        # --- dense mlp ---
        (r"mlp/w_(gate|up)$|shared/w_(gate|up)$", (fsdp, tp)),
        (r"mlp/w_out$|shared/w_out$", (tp, fsdp)),
        (r"mlp/b_up$", (tp,)),
        # --- mamba2 ---
        (r"mamba/w_in$", (fsdp, tp)),
        (r"mamba/w_out$", (tp, fsdp)),
        (r"mamba/conv_w$", (None, tp)),
        (r"mamba/conv_b$", (tp,)),
        # --- rwkv6 ---
        (r"time_mix/w_[rkvg]$", (fsdp, tp)),
        (r"time_mix/w_o$", (tp, fsdp)),
        (r"time_mix/decay_w1$", (fsdp, None)),
        (r"time_mix/decay_w2$", (None, tp)),
        (r"time_mix/lora_w1$", (fsdp, None)),
        (r"time_mix/lora_w2$", (None, None, fsdp)),
        (r"time_mix/(ln_scale|ln_bias|decay_base)$", (tp,)),
        (r"time_mix/bonus_u$", (tp, None)),
        (r"channel_mix/w_[k]$", (fsdp, tp)),
        (r"channel_mix/w_v$", (tp, fsdp)),
        (r"channel_mix/w_r$", (fsdp, tp)),
        # --- embeddings / head ---
        (r"embed/tok$", (tp, fsdp)),
        (r"head/w$", (fsdp, tp)),
        (r"embed/(patch_w|feat_proj)$", (None, fsdp)),
        (r"embed/pos$", (None, fsdp)),
        # --- mtp projection ---
        (r"mtp/proj$", (fsdp, None)),
    ]

# D6: the KV projections that stay replicated over the model axis where it
# does not divide the KV heads
_KV = re.compile(r"attn/(wk|wv|bk|bv)$")
# D7: the Mamba2 leaves every model rank keeps whole, slicing its heads'
# columns and channels on use (the reference splits w_in and conv_* by
# contiguous columns, which are not head-aligned)
_D7 = re.compile(r"mamba/(w_in|conv_w|conv_b|A_log|dt_bias|D|norm)$")
# the MoE router, whole on every model rank, each rank's gradient from
# its own experts' gates
_ROUTER = re.compile(r"/router$")


_STACKED = re.compile(r"(^|/)(stack|dense_stack|moe_stack)(/|$)")


def is_stacked(key: str) -> bool:
    """Whether ``key`` (dotted or slash-joined) is a per-layer leaf with a
    leading L axis: under ``stack``, ``dense_stack`` or ``moe_stack``."""
    return bool(_STACKED.search(key.replace(".", "/")))


def _sanitize(spec, shape, world):
    """Replicate any dimension the world does not divide (the reference
    prefers that predictable layout to GSPMD's padding)."""
    return tuple(ax if ax is not None and shape[i] % world == 0 else None
                 for i, ax in enumerate(spec))


def _spec(key, shape, fsdp, world, tp=None):
    """``param_specs``' ``spec_one`` for one leaf of ``shape``, on one
    axis (``fsdp`` or ``tp``) of ``world`` ranks."""
    ks = key.replace(".", "/")
    stacked = is_stacked(ks)
    base = next((spec for pat, spec in _rules(fsdp, tp)
                 if re.search(pat, ks)), None)
    if base is None:
        # norms, scalars, small vectors: sharded where the world divides
        if stacked:
            base = (None, fsdp) if len(shape) >= 2 else (None,)
        else:
            base = (fsdp,) if len(shape) >= 1 else ()
    elif stacked:
        base = (None,) + base
    base = base + (None,) * (len(shape) - len(base))
    return _sanitize(base, shape, world)


def shard_dims(shapes: dict, *, zero_stage: int, world: int,
               for_opt_state: bool = False) -> dict:
    """``{key: sharded dimension or None}`` for ``{key: shape}`` (flat
    dotted keys, e.g. ``stack.attn.wq``), as ``param_specs(...,
    tensor_parallel=False)`` gives on a ``data`` axis of ``world`` ranks.

    ``for_opt_state``: stages 1 and 2 shard the optimizer state while the
    params stay replicated; stage 3 shards both."""
    shard = zero_stage >= 3 or for_opt_state and zero_stage >= 1
    fsdp = _F if shard else None
    out = {}
    for key, shape in shapes.items():
        spec = _spec(key, tuple(shape), fsdp, world)
        out[key] = spec.index(_F) if _F in spec else None
    return out


def kv_replicated(cfg, model: int) -> bool:
    """D6: whether the KV projections stay whole on every model rank (the
    model axis does not divide the KV heads). The reference splits them
    into part-heads and lets GSPMD mend that with a replicated ``attn_kv``
    hint; an explicit split needs whole heads."""
    return model > 1 and cfg.num_kv_heads % model != 0


def model_summed(key: str, cfg, model: int) -> bool:
    """Whether leaf ``key`` is whole on every rank of a model group of
    ``model`` ranks while each rank's gradient of it is only its share, so
    the gradients are summed over the group: the KV projections under D6,
    Mamba2's D7 leaves, and the MoE router (each rank combines only its
    own experts' outputs)."""
    if model <= 1:
        return False
    ks = key.replace(".", "/")
    return bool(kv_replicated(cfg, model) and _KV.search(ks)
                or _D7.search(ks) or _ROUTER.search(ks))


def model_dims(shapes: dict, cfg, model: int) -> dict:
    """``{key: the dimension split over the model axis, or None}`` for
    ``{key: shape}`` (whole leaves), as ``param_specs(...,
    tensor_parallel=True)`` puts ``"model"`` on a mesh of ``model`` model
    ranks, but for the leaves of :func:`model_summed`, whole on every
    rank: D6's KV projections where the model axis does not divide the KV
    heads, and D7's Mamba2 in-projection and conv (the reference splits
    them by contiguous columns)."""
    out = {}
    for key, shape in shapes.items():
        spec = _spec(key, tuple(shape), None, model, _TP)
        dim = spec.index(_TP) if _TP in spec else None
        out[key] = None if model_summed(key, cfg, model) else dim
    return out


def _divides(cfg, model, n, what):
    if n % model:
        raise ValueError(f"{cfg.name}: {n} {what} not divisible by the "
                         f"model axis {model} (the port splits whole "
                         f"ones; ROADMAP item 16.1)")


def check_model_axis(cfg, model: int) -> None:
    """Raise ``ValueError`` for a config the model axis cannot split: a
    family outside ``TP_ARCH_TYPES``, or a count of what each rank takes a
    whole share of that the model axis does not divide: Mamba2's SSM
    heads, the MoE's experts and shared-expert width, RWKV6's heads and
    channel-mix width, the attention's (or MLA's) query heads and the MLP
    width of the dense layers (an MoE decoder's leading ones and the MTP
    head's block); or query heads that straddle a KV head when the KV
    projections stay whole (D6)."""
    if model < 1:
        raise ValueError(f"model axis must be >= 1: {model}")
    if model == 1:
        return
    if cfg.arch_type not in TP_ARCH_TYPES:
        raise ValueError(f"{cfg.name}: tensor parallelism for the "
                         f"{cfg.arch_type!r} family is not yet ported to "
                         f"repro_torch (ROADMAP item 16.1)")
    if cfg.block_kind == "mamba2":
        s = cfg.ssm
        _divides(cfg, model, s.expand * cfg.d_model // s.head_dim,
                 "SSM heads are")
    if cfg.has_moe:
        _divides(cfg, model, cfg.moe.num_experts, "experts are")
        if cfg.moe.num_shared_experts:
            _divides(cfg, model, cfg.moe.d_ff_expert
                     * cfg.moe.num_shared_experts, "shared-expert widths are")
    if cfg.block_kind == "rwkv6":
        _divides(cfg, model, cfg.num_heads, "heads are")
        _divides(cfg, model, cfg.d_ff, "channel-mix widths (d_ff) are")
        return
    if cfg.block_kind == "mamba2" and cfg.hybrid_group <= 0:
        return
    # the attention + MLP layers (a hybrid's shared block among them)
    _divides(cfg, model, cfg.num_heads, "query heads are")
    if not cfg.has_moe or cfg.moe.first_dense_layers > 0 \
            or cfg.mtp_depth > 0:
        _divides(cfg, model, cfg.d_ff, "MLP widths (d_ff) are")
    per, group = cfg.num_heads // model, cfg.num_heads // cfg.num_kv_heads
    if kv_replicated(cfg, model) and group % per:
        raise ValueError(
            f"{cfg.name}: {per} query heads a rank straddle the KV heads "
            f"(groups of {group}) at model axis {model} (ROADMAP item 16.1)")


def stage_chunks(num_layers: int, stages: int, interleave: int,
                 stage: int) -> list:
    """The ``[lo, hi)`` layer ranges of the chunks pipeline stage ``stage``
    holds: chunk ``c`` of ``stages * interleave`` equal chunks lives on
    stage ``c % stages`` (Megatron's round-robin placement), in the order
    of ``c``."""
    chunks = stages * interleave
    if num_layers % chunks:
        raise ValueError(f"num_layers={num_layers} not divisible by "
                         f"{chunks} pipeline chunks")
    n = num_layers // chunks
    return [(c * n, (c + 1) * n) for c in range(stage, chunks, stages)]


# --- the serving cache (the reference's ``cache_specs``) ----------------------

_CACHE_HEADS = re.compile(r"(^|/)(wkv|ssd)$")
_CACHE_KV = re.compile(r"(^|/)(k|v)$")


def cache_dims(cfg, cache_shapes: dict, data: int, model: int) -> dict:
    """``{group: {leaf: (batch dimension, model dimension or None, why)}}``
    for the cache tree ``cache_shapes`` (``{group: {leaf: shape}}``, each
    leaf stacked on a leading L axis), as the port lays it out over
    ``data`` data ranks and ``model`` model ranks: the counterpart of
    ``cache_specs`` (``repro/core/sharding.py:220-252``). Every leaf's
    batch (dimension 1) goes over the data axis. The model axis splits
    heads where the reference's does (RWKV6's ``wkv``, Mamba2's ``ssd``)
    and where the port's tensor parallelism gives a rank whole KV heads
    (attention ``k``/``v``; the reference splits their sequence: ROADMAP
    deviation D9). ``why`` says why a leaf is not split on the model
    axis, or which part a rank keeps: D6's one KV head, MLA's latents,
    the shifts, D7's conv channels; None for a plain split or with no
    model axis."""
    out = {}
    for group, leaves in cache_shapes.items():
        dims = out[group] = {}
        for key, shape in leaves.items():
            m, why = None, None
            if model > 1:
                if _CACHE_HEADS.search(key):
                    m = 2
                elif _CACHE_KV.search(key):
                    if kv_replicated(cfg, model):
                        why = ("D6: the one KV head this rank's query "
                               "heads use")
                    else:
                        m = 3
                elif key in ("c_kv", "k_rope"):
                    why = "MLA: the latents whole, every head shares them"
                elif key == "conv":
                    why = ("D7: the x channels of this rank's heads, then "
                           "the B and C channels whole")
                else:
                    why = "a shift: whole, x is copied to the model group"
            if shape[1] % data:
                raise ValueError(f"cache {group}/{key}: batch {shape[1]} "
                                 f"not divisible by {data} data ranks")
            dims[key] = (1, m, why)
    return out


def cache_shape(cfg, key: str, shape, dims, data: int, model: int) -> tuple:
    """The shape of one rank's part of cache leaf ``key`` of whole
    ``shape``, by its :func:`cache_dims` entry ``dims``."""
    batch, m, _ = dims
    out = list(shape)
    out[batch] //= data
    if m is not None:
        out[m] //= model
    elif model > 1 and _CACHE_KV.search(key) and kv_replicated(cfg, model):
        out[3] = 1
    elif model > 1 and key == "conv":
        s = cfg.ssm
        out[3] = s.expand * cfg.d_model // model + 2 * s.state_dim
    return tuple(out)


def check_serving(cfg, batch: int, data: int, model: int) -> None:
    """Raise ``ValueError`` for a serving layout the port cannot run: a
    family without a decode step, a batch the ``data`` ranks do not
    divide (the reference's ``_sanitize`` then replicates it; ROADMAP F2),
    and what :func:`check_model_axis` refuses."""
    if not cfg.supports_decode():
        raise ValueError(f"{cfg.name} has no decode step (an encoder or a "
                         f"classifier)")
    if data < 1 or batch % data:
        raise ValueError(f"batch {batch} not divisible by {data} data "
                         f"ranks (each serves an equal share of the rows; "
                         f"ROADMAP F2)")
    check_model_axis(cfg, model)
