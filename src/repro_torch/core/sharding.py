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

A decoder's token embedding ``embed.tok`` (V, d) takes the layout of
``embed_sharding`` (``EngineConfig``): "vocab" (the default, Megatron's
vocab-parallel) puts the model axis on its rows and ZeRO's data split on
its columns; "dmodel" puts the model axis on its columns, with no data
split at any stage or for the optimizer state (``P(None, tp)``,
``repro/core/sharding.py:65-69``). Either split is dropped where the
axis does not divide the dimension. An untied ``head.w`` keeps
``(fsdp, tp)`` in both layouts.
"""
from __future__ import annotations

import re

_F = "data"         # the data-parallel axis in the tables below
_TP = "model"       # the tensor-parallel axis

# the families whose layers the model axis splits (DeepSeek's MLA, an
# "moe" family, among them)
TP_ARCH_TYPES = ("vit", "audio", "dense", "vlm", "moe", "ssm", "hybrid")


def _rules(fsdp, tp=None, embed_sharding="vocab"):
    """``repro/core/sharding.py:32-76``: (pattern on the slash-joined key,
    spec of the unstacked leaf), first match wins; the embedding split on
    its rows ("vocab", Megatron's vocab-parallel) or on its features
    ("dmodel", no data split)."""
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
        (r"embed/tok$", (tp, fsdp) if embed_sharding == "vocab"
         else (None, tp)),
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


def _spec(key, shape, fsdp, world, tp=None, embed_sharding="vocab"):
    """``param_specs``' ``spec_one`` for one leaf of ``shape``, on one
    axis (``fsdp`` or ``tp``) of ``world`` ranks."""
    ks = key.replace(".", "/")
    stacked = is_stacked(ks)
    base = next((spec for pat, spec in _rules(fsdp, tp, embed_sharding)
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
               for_opt_state: bool = False,
               embed_sharding: str = "vocab") -> dict:
    """``{key: sharded dimension or None}`` for ``{key: shape}`` (flat
    dotted keys, e.g. ``stack.attn.wq``), as ``param_specs(...,
    tensor_parallel=False)`` gives on a ``data`` axis of ``world`` ranks.

    ``for_opt_state``: stages 1 and 2 shard the optimizer state while the
    params stay replicated; stage 3 shards both. Under
    ``embed_sharding`` "dmodel" ``embed.tok`` has no data dimension."""
    shard = zero_stage >= 3 or for_opt_state and zero_stage >= 1
    fsdp = _F if shard else None
    out = {}
    for key, shape in shapes.items():
        spec = _spec(key, tuple(shape), fsdp, world,
                     embed_sharding=embed_sharding)
        out[key] = spec.index(_F) if _F in spec else None
    return out


def kv_replicated(cfg, model: int) -> bool:
    """D6: whether the KV projections stay whole on every model rank (the
    model axis does not divide the KV heads). The reference splits them
    into part-heads and lets GSPMD mend that with a replicated ``attn_kv``
    hint; an explicit split needs whole heads."""
    return model > 1 and cfg.num_kv_heads % model != 0


# the leaves of each block that runs whole on every model rank where the
# model axis does not divide its split count (:func:`whole_blocks`)
_BLOCK_LEAVES = {
    "attn": re.compile(r"(^|/)attn/"),
    "mlp": re.compile(r"(^|/)mlp/"),
    "moe": re.compile(r"(^|/)moe/"),
    "mamba": re.compile(r"(^|/)mamba/"),
    "time_mix": re.compile(r"(^|/)time_mix/"),
    "channel_mix": re.compile(r"(^|/)channel_mix/"),
}


def whole_blocks(cfg, model: int) -> frozenset:
    """The kinds of block (of :data:`_BLOCK_LEAVES`) that run whole on
    every one of ``model`` model ranks because the model axis does not
    divide what the port splits of them (ROADMAP F2; the reference's
    ``_sanitize`` replicates any dimension the axis does not divide):
    the attention's (or MLA's) query heads, or query heads that would
    straddle a KV head kept whole (D6); the MLP width ``d_ff``; the MoE's
    experts or its shared-expert width; Mamba2's SSM heads; RWKV6's heads
    (the time mix) and its channel-mix width or model width. A whole
    block needs no collective, and its leaves' gradients are the same on
    every model rank. The reference keeps an attention's ``wq`` split by
    columns and pads the heads (ROADMAP deviation D10)."""
    if model <= 1:
        return frozenset()
    out = set()
    h, kh = cfg.num_heads, cfg.num_kv_heads
    if h % model or kh and kv_replicated(cfg, model) and \
            (h // kh) % (h // model):
        out.add("attn")
    if cfg.d_ff % model:
        out.add("mlp")
    m = cfg.moe
    if cfg.has_moe and (m.num_experts % model or
                        m.d_ff_expert * m.num_shared_experts % model):
        out.add("moe")
    if cfg.ssm is not None and cfg.block_kind == "mamba2" and \
            cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim % model:
        out.add("mamba")
    if cfg.block_kind == "rwkv6":
        if h % model:
            out.add("time_mix")
        if cfg.d_ff % model or cfg.d_model % model:
            out.add("channel_mix")
    return frozenset(out)


def in_whole_block(key: str, whole) -> bool:
    """Whether leaf ``key`` belongs to a block of ``whole`` (from
    :func:`whole_blocks`)."""
    ks = key.replace(".", "/")
    return any(_BLOCK_LEAVES[kind].search(ks) for kind in whole)


def model_summed(key: str, cfg, model: int) -> bool:
    """Whether leaf ``key`` is whole on every rank of a model group of
    ``model`` ranks while each rank's gradient of it is only its share, so
    the gradients are summed over the group: the KV projections under D6,
    Mamba2's D7 leaves, and the MoE router (each rank combines only its
    own experts' outputs); none of a block that runs whole
    (:func:`whole_blocks`)."""
    if model <= 1 or in_whole_block(key, whole_blocks(cfg, model)):
        return False
    ks = key.replace(".", "/")
    return bool(kv_replicated(cfg, model) and _KV.search(ks)
                or _D7.search(ks) or _ROUTER.search(ks))


def model_dims(shapes: dict, cfg, model: int,
               embed_sharding: str = "vocab") -> dict:
    """``{key: the dimension split over the model axis, or None}`` for
    ``{key: shape}`` (whole leaves), as ``param_specs(...,
    tensor_parallel=True, embed_sharding=...)`` puts ``"model"`` on a mesh
    of ``model`` model ranks, but for the leaves of :func:`model_summed`,
    whole on every rank: D6's KV projections where the model axis does not
    divide the KV heads, and D7's Mamba2 in-projection and conv (the
    reference splits them by contiguous columns); and the leaves of the
    blocks that run whole (:func:`whole_blocks`, F2). ``embed.tok`` is
    split on its rows ("vocab") or its columns ("dmodel")."""
    whole = whole_blocks(cfg, model)
    out = {}
    for key, shape in shapes.items():
        spec = _spec(key, tuple(shape), None, model, _TP, embed_sharding)
        dim = spec.index(_TP) if _TP in spec else None
        out[key] = None if model_summed(key, cfg, model) \
            or in_whole_block(key, whole) else dim
    return out


def check_model_axis(cfg, model: int) -> None:
    """Raise ``ValueError`` for a model axis the port cannot lay out: one
    below 1, or a family outside ``TP_ARCH_TYPES``. A count the model
    axis does not divide is no refusal: that block runs whole on every
    model rank (:func:`whole_blocks`)."""
    if model < 1:
        raise ValueError(f"model axis must be >= 1: {model}")
    if model > 1 and cfg.arch_type not in TP_ARCH_TYPES:
        raise ValueError(f"{cfg.name}: tensor parallelism for the "
                         f"{cfg.arch_type!r} family is not yet ported to "
                         f"repro_torch (ROADMAP item 16.1)")


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
# the block whose layer writes each cache leaf
_CACHE_BLOCK = {"k": "attn", "v": "attn", "c_kv": "attn", "k_rope": "attn",
                "wkv": "time_mix", "att_shift": "time_mix",
                "ffn_shift": "channel_mix", "ssd": "mamba", "conv": "mamba"}


def latents_split(cfg, max_len: int, model: int) -> bool:
    """Whether MLA's latent cache (``c_kv``, ``k_rope``) of ``max_len``
    rows is split on the sequence over ``model`` model ranks: where the
    model axis divides the rows and the attention block is split (not in
    :func:`whole_blocks`), as ``cache_specs`` with ``_sanitize``
    (``repro/core/sharding.py:101-108,220-252``) puts it on the model axis
    where it divides. Decode is then a distributed flash-decoding
    (``models/attention.py::mla_block``)."""
    return model > 1 and max_len % model == 0 and \
        "attn" not in whole_blocks(cfg, model)


def cache_dims(cfg, cache_shapes: dict, data: int, model: int) -> dict:
    """``{group: {leaf: (batch dimension, model dimension or None, why)}}``
    for the cache tree ``cache_shapes`` (``{group: {leaf: shape}}``, each
    leaf stacked on a leading L axis), as the port lays it out over
    ``data`` data ranks and ``model`` model ranks: the counterpart of
    ``cache_specs`` (``repro/core/sharding.py:220-252``). Every leaf's
    batch (dimension 1) goes over the data axis. The model axis splits
    heads where the reference's does (RWKV6's ``wkv``, Mamba2's ``ssd``),
    MLA's latents on the sequence (dimension 2) as the reference's does
    (:func:`latents_split`), and attention ``k``/``v`` where the port's
    tensor parallelism gives a rank whole KV heads (the reference splits
    their sequence: ROADMAP deviation D9). ``why`` says why a leaf is not
    split on the model axis, or which part a rank keeps: D6's one KV head,
    MLA's latents where the model axis does not divide their rows, the
    shifts, D7's conv channels, the whole leaf of a block that runs whole
    on every model rank (F2, :func:`whole_blocks`); None for a plain split
    or with no model axis."""
    whole = whole_blocks(cfg, model)
    out = {}
    for group, leaves in cache_shapes.items():
        dims = out[group] = {}
        for key, shape in leaves.items():
            m, why = None, None
            if model > 1 and _CACHE_BLOCK.get(key) in whole:
                why = "F2: the block runs whole on every model rank"
            elif model > 1:
                if _CACHE_HEADS.search(key):
                    m = 2
                elif _CACHE_KV.search(key):
                    if kv_replicated(cfg, model):
                        why = ("D6: the one KV head this rank's query "
                               "heads use")
                    else:
                        m = 3
                elif key in ("c_kv", "k_rope"):
                    if latents_split(cfg, shape[2], model):
                        m = 2
                    else:
                        why = (f"MLA: the latents whole, {model} model "
                               f"ranks do not divide {shape[2]} rows")
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
    batch, m, why = dims
    out = list(shape)
    out[batch] //= data
    if m is not None:
        out[m] //= model
    elif why is not None and why.startswith("D6"):
        out[3] = 1
    elif why is not None and why.startswith("D7"):
        s = cfg.ssm
        out[3] = s.expand * cfg.d_model // model + 2 * s.state_dim
    return tuple(out)


def check_serving(cfg, batch: int, data: int, model: int) -> None:
    """Raise ``ValueError`` for a serving layout the port cannot run: a
    family without a decode step, fewer than one data rank or a batch
    below one row, and what :func:`check_model_axis` refuses. A batch the
    ``data`` ranks do not divide is served whole by every data rank, as
    the reference's ``_sanitize`` replicates it (:func:`serving_rows`)."""
    if not cfg.supports_decode():
        raise ValueError(f"{cfg.name} has no decode step (an encoder or a "
                         f"classifier)")
    if data < 1 or batch < 1:
        raise ValueError(f"a serving batch of {batch} rows over {data} "
                         f"data ranks")
    check_model_axis(cfg, model)


def serving_rows(batch: int, data: int) -> int:
    """The data ranks a serving batch of ``batch`` rows is split over:
    ``data`` where they divide it, else 1 (every data rank serves every
    row, the reference's ``_sanitize`` on the batch)."""
    return data if batch % data == 0 else 1
