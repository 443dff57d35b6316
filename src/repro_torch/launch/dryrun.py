"""The dry run: every (architecture x input shape) pair on the reference's
production layout, counted on ``meta`` tensors (the counterpart of
``repro/launch/dryrun.py``):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
        --shape decode_32k --out results/torch/rec.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out results/torch/baseline_singlepod.jsonl

Each pair builds the port's own entry point for rank 0 of the production
layout (``launch/mesh.py::production_layout``: 16 data x 16 model = 256
ranks, data 32 x model 16 = 512 with ``--multi-pod``) on a
``core/distributed.py::RecordingWorld``, whose collectives move nothing
and record their bytes, with the full-width config's params on ``meta``:
a ``Trainer`` takes one training step, a ``Server`` prefills the prompt
batch into a cache of its length or decodes one token against a cache of
the shape's length. ``launch/op_count.py``'s counter counts the step's
FLOPs, bytes, collectives and peak bytes (the accumulation microbatches
and the blockwise attention's key blocks counted by their trip counts),
and :func:`roofline` turns them into a rank's compute, memory and
collective times on ``core/comm_model.py``'s ``H100_SXM`` (datasheet
constants: modelled, not measured).

The flags, defaults and record keys are the reference's: blockwise
attention (``--use-pallas`` takes the kernels instead, each charging its
analytic work), remat "block" for training, ZeRO-3, gradient accumulation
down to ``--micro`` 2 rows a data rank, ``model_flops`` of 6·N_active·
tokens for training, 2·N_active·tokens for prefill and 2·N_active·B for
decode. There is no compiler here, so ``lower_s``/``compile_s`` are one
``count_s`` and ``xla_cost_analysis`` is the counter's totals by aten op
and kernel. ``seq_parallel`` is the reference's: "ulysses" for a prefill
pair and "none" for the rest unless ``--seq-parallel`` says otherwise,
and the layout follows ``core/ulysses.py::applies`` as the reference's
``make_hints`` does. At the production layout that is HuBERT-XLarge's
prefill (16 query and 16 KV heads at model 16), counted as its forward in
eval mode (the reference lowers an encoder's prefill as its forward
writing a cache) with every leaf whole under the sequence group; every
decoder's heads fall back to the tensor-parallel layout there, as
``make_hints``' do. A decoder's serving pair where the Ulysses layout
would apply (no production layout reaches one) is refused: the port's
``Server`` has no sequence layout yet (ROADMAP 16.2c). ``--embed`` is the
embedding's layout (``EngineConfig.embed_sharding``, "vocab" by default,
or "dmodel"), for the ``Trainer`` and the ``Server`` alike, and the
record's ``embed`` says which ran: under "dmodel" the lookup's rows are
all-gathered on the features where "vocab" all-reduces them, and a tied
head's partial logits (B, S, V) are all-reduced in fp32 where "vocab"
runs the vocab-parallel NLL's reductions. A pair the port refuses is recorded
with ``status: "fail"`` and the refusal's text, and ``--all`` then
exits 1.
A DeepSeek-V3 serving pair's cache holds a rank's rows of the latents
(split on the sequence over the model group, as the reference's
``cache_specs``), and its decode counts the distributed flash-decoding's
collectives (``models/attention.py::mla_block``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, EngineConfig, \
    applicable, get_config, get_shape
from repro_torch.configs.base import EMBED_SHARDING
from repro_torch.core import ulysses
from repro_torch.core.comm_model import H100_SXM, roofline
from repro_torch.core.distributed import recording_world
from repro_torch.core.engine import Server, Trainer
from repro_torch.core.sharding import model_dims, serving_rows
from repro_torch.launch import op_count
from repro_torch.launch.mesh import make_layout, production_layout
from repro_torch.launch.specs import input_specs
from repro_torch.models import shardctx
from repro_torch.models import transformer as model


def param_counts(cfg) -> tuple:
    """(params, active params): the routed experts counted at
    ``top_k / num_experts`` in the second (the 6·N_active·D convention,
    ``repro/models/params.py::count_params_analytic``)."""
    shapes = model.init_params(cfg, device="meta")
    total = sum(p.numel() for p in shapes.values())
    if not cfg.has_moe:
        return total, total
    routed = sum(p.numel() for k, p in shapes.items() if ".experts." in k)
    return total, int(total - routed + routed * cfg.moe.top_k
                      / cfg.moe.num_experts)


def engine_for(arch: str, shape_name: str, layout, *, zero: int = None,
               seq_parallel: str = None, remat: str = None,
               use_pallas: bool = False, moe_impl: str = None,
               bf16_gather: bool = False, embed: str = None,
               chunk: int = 0, micro: int = 0):
    """(the config, the ``EngineConfig``, the shape) of a pair, with the
    reference's defaults (``repro/launch/dryrun.py:73-118``)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    cfg = cfg.replace(attn_impl="blockwise", use_kernels=use_pallas)
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    elif shape.kind == "train":
        cfg = cfg.replace(remat="block")
    if moe_impl:
        cfg = cfg.replace(moe_impl=moe_impl)
    if chunk and cfg.ssm is not None:
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk_size=chunk))
    zero = 3 if zero is None else zero
    if seq_parallel is None:
        seq_parallel = "ulysses" if shape.kind == "prefill" else "none"
    dp = layout.data
    gb = shape.global_batch
    mb = micro or 2
    accum = max(1, gb // (dp * mb)) if gb % dp == 0 else 1
    ecfg = EngineConfig(
        train_batch_size=max(gb, dp) if gb % dp == 0 else gb,
        gradient_accumulation_steps=accum, zero_stage=zero,
        sequence_parallel=seq_parallel, cast_params_bf16=bf16_gather,
        embed_sharding=embed or "vocab", pipeline_stages=layout.pipe,
        guard_anomalies=False)
    return cfg, ecfg, shape


def _bytes(tensors) -> int:
    return sum(op_count.tensor_bytes(t) for t in tensors)


def count_train(cfg, ecfg, world, model_axis, batch, *, where=False):
    """The counter of one ``Trainer.train_step`` of rank ``world.rank`` on
    ``meta``."""
    trainer = Trainer(cfg, ecfg, device="meta", world=world,
                      model_axis=model_axis)
    state = trainer.init_state(model.init_params(cfg, device="meta"))
    opt = [t for tree in (state.opt_state.mu, state.opt_state.nu)
           if tree != () for t in tree.values()]
    args = list(state.params.values()) + opt + list(batch.values())
    with op_count.OpCounter(skip_repeats=True, where=where,
                            args_bytes=_bytes(args),
                            arg_tensors=args) as counter:
        trainer.train_step(state, batch)
    return counter


def count_serve(cfg, shape, world, model_axis, seq_parallel="none", *,
                embed_sharding="vocab", where=False):
    """A ``Server``'s prefill of the shape's prompt batch into a cache of
    its length, or one decode step against a cache of the shape's length,
    for rank ``world.rank`` on ``meta``, its embedding laid out by
    ``embed_sharding``; an encoder's prefill is its
    forward (eval mode) on the data rank's rows under the model group,
    installed as the sequence group with every leaf whole where
    ``ulysses.applies`` (else the tensor-parallel layout). A decoder where
    it applies is refused (ROADMAP 16.2c). Returns the counter."""
    params = model.init_params(cfg, device="meta")
    b, s = shape.global_batch, shape.seq_len
    seq = ulysses.applies(cfg, model_axis, seq_parallel)
    if not cfg.supports_decode():
        lay = make_layout(world, 1, model_axis)
        dims = model_dims({k: v.shape for k, v in params.items()}, cfg,
                          model_axis) if lay.model is not None and not seq \
            else {}
        params = {k: lay.model.chunk(v, dims[k]) if dims.get(k) is not None
                  else v for k, v in params.items()}
        n = b // serving_rows(b, lay.data.size)
        lo = lay.data.rank * n if n < b else 0
        batch = {k: v[lo:lo + n]
                 for k, v in input_specs(cfg, shape).items()}
        with op_count.OpCounter(skip_repeats=True, where=where,
                                args_bytes=_bytes(list(params.values())
                                                  + list(batch.values()))
                                ) as counter, torch.inference_mode(), \
                (shardctx.use_sequence if seq else shardctx.use)(lay.model):
            model.forward(cfg, params, batch, mode="eval")
        return counter
    if seq:
        raise ValueError(f"{cfg.name}: the Server's sequence layout "
                         f"(--seq-parallel ulysses at model axis "
                         f"{model_axis}) is not yet ported to repro_torch "
                         f"(ROADMAP item 16.2c)")
    server = Server(cfg, params, device="meta", world=world,
                    model_axis=model_axis, embed_sharding=embed_sharding)
    cache = server.init_cache(b, s)
    leaves = [t for group in cache.values() for t in group.values()]
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)
        args = list(server.params.values()) + leaves + list(batch.values())
        with op_count.OpCounter(skip_repeats=True, where=where,
                                args_bytes=_bytes(args)) as counter:
            server.prefill(batch, cache)
        return counter
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")
    args = list(server.params.values()) + leaves + [token]
    with op_count.OpCounter(skip_repeats=True, where=where,
                            args_bytes=_bytes(args)) as counter:
        server.decode_step(cache, token, s - 1)
    return counter


def count_pair(arch, shape_name, *, multi_pod=False, where=False, **kw):
    """(the counter, the config, the shape, the engine config, the
    layout) of a pair's rank 0."""
    layout = production_layout(multi_pod=multi_pod)
    cfg, ecfg, shape = engine_for(arch, shape_name, layout, **kw)
    world = recording_world(0, layout.size)
    if shape.kind == "train":
        counter = count_train(cfg, ecfg, world, layout.model,
                              input_specs(cfg, shape), where=where)
    else:
        counter = count_serve(cfg, shape, world, layout.model,
                              ecfg.sequence_parallel,
                              embed_sharding=ecfg.embed_sharding,
                              where=where)
    return counter, cfg, shape, ecfg, layout


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             zero: int = None, seq_parallel: str = None, remat: str = None,
             use_pallas: bool = False, verbose: bool = True,
             moe_impl: str = None, bf16_gather: bool = False,
             embed: str = None, chunk: int = 0, micro: int = 0,
             tag: str = "") -> dict:
    """One pair's record (the reference's ``run_pair``)."""
    t0 = time.time()
    layout = production_layout(multi_pod=multi_pod)
    chips = layout.size
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
           "chips": chips, "status": "skip", "reason": reason}
    if not ok:
        return rec
    counter, cfg, shape, ecfg, layout = count_pair(
        arch, shape_name, multi_pod=multi_pod, zero=zero,
        seq_parallel=seq_parallel, remat=remat, use_pallas=use_pallas,
        moe_impl=moe_impl, bf16_gather=bf16_gather, embed=embed,
        chunk=chunk, micro=micro)
    rec["tag"] = tag
    rec["options"] = {"moe_impl": moe_impl, "bf16_gather": bf16_gather,
                      "embed": embed, "chunk": chunk, "micro": micro,
                      "zero": zero, "seq_parallel": seq_parallel}
    n_params, n_active = param_counts(cfg)
    if shape.kind == "train":
        model_flops = 6.0 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2.0 * n_active * shape.global_batch
    totals = counter.totals
    rl = roofline(totals, chips=chips, model_flops=model_flops)
    count_s = time.time() - t0
    rec.update({
        "status": "ok",
        "params": n_params,
        "active_params": n_active,
        "zero": ecfg.zero_stage,
        "seq_parallel": ecfg.sequence_parallel,
        "layout": {"data": layout.data, "pipe": layout.pipe,
                   "model": layout.model},
        "embed": ecfg.embed_sharding,
        "attn": "kernels" if cfg.use_kernels else cfg.attn_impl,
        "argument_bytes_per_dev": counter.args_bytes,
        # the port's step updates its state in place
        "output_bytes_per_dev": 0,
        "temp_bytes_per_dev": counter.peak_bytes - counter.args_bytes,
        "peak_bytes_per_dev": counter.peak_bytes,
        "collectives": dict(totals.coll),
        "collectives_network": dict(totals.coll_network),
        "xla_cost_analysis": {"flops": totals.flops,
                              "bytes accessed": totals.hbm_bytes,
                              **{f"flops {k}": v[0] for k, v in
                                 counter.by_op.items() if v[0]}},
        "roofline": rl,
        "hw": H100_SXM.name,
        "count_s": round(count_s, 1),
    })
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} (pods={2 if multi_pod else 1})"
              f" params={n_params / 1e9:.1f}B"
              f" mem/dev={rec['peak_bytes_per_dev'] / 2 ** 30:.2f}GiB"
              f" dominant={rl['dominant']}"
              f" compute={rl['compute_s'] * 1e3:.2f}ms"
              f" memory={rl['memory_s'] * 1e3:.2f}ms"
              f" coll={rl['collective_s'] * 1e3:.2f}ms"
              f" (count {count_s:.0f}s)", flush=True)
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="the dry run on meta tensors")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (assigned arch x shape)")
    ap.add_argument("--zero", type=int, default=None)
    ap.add_argument("--seq-parallel", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--use-pallas", action="store_true",
                    help="the hand-written kernels (each charges its "
                         "analytic work) instead of blockwise attention")
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--bf16-gather", action="store_true")
    ap.add_argument("--embed", default=None, choices=EMBED_SHARDING,
                    help="the token embedding's layout over the model "
                         "axis (default vocab)")
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--micro", type=int, default=0)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None, help="append JSONL here")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.all:
        pairs = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("[dryrun] --arch and --shape, or --all")
        pairs = [(args.arch, args.shape)]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
    n_fail = 0
    for arch, shape in pairs:
        try:
            rec = run_pair(arch, shape, multi_pod=args.multi_pod,
                           zero=args.zero, seq_parallel=args.seq_parallel,
                           remat=args.remat, use_pallas=args.use_pallas,
                           moe_impl=args.moe_impl,
                           bf16_gather=args.bf16_gather, embed=args.embed,
                           chunk=args.chunk, micro=args.micro,
                           tag=args.tag)
        except Exception as e:   # noqa: BLE001 - report, keep sweeping
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "multi_pod": args.multi_pod,
                   "status": "fail", "error": f"{type(e).__name__}: {e}"}
            n_fail += 1
        if rec["status"] == "skip":
            print(f"[dryrun] {arch} x {shape}: SKIP ({rec['reason']})")
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
