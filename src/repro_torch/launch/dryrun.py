"""Dry run of the sharded step on a mesh of ``meta`` devices: the twin of
the JAX package's ``launch/dryrun.py``, which ``.lower().compile()``\\ s
every (architecture x input shape) cell on the production meshes and
records memory, cost and collective statistics.

The port has no compiler to ask.  It runs its own sharded entry point
(``parallel/sharded.py``: ``sharded_train_step``, AdamW included, as the
reference's ``train_step``; ``sharded_prefill``; ``sharded_decode_step``)
on parameters, optimizer state, batch and cache that are ``meta`` tensors
(shapes and types, no storage), placed by ``parallel/sharding.py``'s
specs, and reads what rank 0 did (``spmd.tracing``).  By default rank 0
runs alone, each collective returning its result's shape with no
rendezvous: one rank's trace stands for the one SPMD program the
reference compiles for every device (every rank of the step runs the
same code on blocks of the same shapes).  ``rank0_only=False`` runs every
rank (one thread each), which a test holds equal to rank 0 alone.

The row keeps the reference's keys, filled from rank 0:

* ``memory.argument_size_in_bytes``: the bytes of rank 0's shards of
  every argument; ``output_size_in_bytes``: the bytes of its results and
  of the arguments it writes in place (their version counters moved: the
  parameters and optimizer state of a train step, the cache of a serving
  step; the reference returns them).  There is no temp size: ``meta``
  has no allocator (the card's peaks are ``chip_smoke.py`` phases 15-16's).
* ``cost.flops``: rank 0's FLOPs, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` entered inside rank 0's
  thread (a dispatch mode is per thread), the backward's included, on
  oplib's ``torch`` backend (the kernels take no ``meta`` tensors).
  There is no ``bytes accessed`` (``cost_note`` says so): ``roofline``
  falls back to its analytic bytes.
* ``collectives``: by HLO kind (``hlo_stats.COLLECTIVES``): ``psum`` and
  ``pmax`` are ``all-reduce``, ``psum_scatter`` ``reduce-scatter``,
  ``all_gather`` ``all-gather`` and ``ppermute`` ``collective-permute``;
  each kind's count, operand bytes (what rank 0 sends) and result bytes.
  Every layer's are counted (there is no loop body costed once, so
  ``scan_trip_count`` is 1).  A collective over a group of one rank moves
  no data and is left out; so is ``constrain``, which in the port only
  checks a layout (``parallel/constrain.py``) and moves nothing.
* ``trace_s`` (host seconds to place the arguments and trace the step)
  stands for the reference's ``lower_s`` and ``compile_s``.

On the multi-pod mesh (``--multi-pod``: 2 x 16 x 16, ``('pod', 'data',
'model')``, 512 ``meta`` devices) the step cuts the batch, and a batch-1
cache's sequence, over ``('pod', 'data')`` and keeps every parameter
whole over 'pod', as the reference's rules do.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out dryrun_results.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from typing import Any, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import configs
from .. import tree as T
from ..configs.base import SHAPES, applicable_shapes
from ..core import oplib
from ..core.lower_torch import torch_dtype
from ..models.build import build_model, input_specs
from ..optim import adamw
from ..parallel import sharded
from ..parallel import sharding as shd
from ..parallel import spmd
from ..parallel.spmd import P
from .hlo_stats import COLLECTIVES
from .mesh import dp_axes, dp_size, make_production_mesh

# the port's collectives by the HLO kind the reference's dry run counts
HLO_KIND = {"psum": "all-reduce", "pmax": "all-reduce", "psum_scatter": "reduce-scatter",
            "all_gather": "all-gather", "ppermute": "collective-permute"}
assert set(HLO_KIND.values()) <= set(COLLECTIVES)


def _eval_param_shapes(model):
    return model.init(torch.Generator().manual_seed(0), device="meta")


def _opt_shapes(param_shapes):
    zeros = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    return {
        "m": T.tree_map(zeros, param_shapes),
        "v": T.tree_map(zeros, param_shapes),
        "step": torch.empty((), dtype=torch.int32, device="meta"),
    }


def _cache_len(cfg, shape) -> int:
    # vlm caches hold the prepended patch positions too
    return shape.seq_len + (cfg.frontend_len if cfg.frontend == "patches" else 0)


def build_step(model, cfg, shape, mesh):
    """Returns (fn, args, in_specs, out_specs): ``fn(*args)`` runs the
    port's sharded entry point on ``args``, ``meta`` tensors placed on
    ``mesh`` (parameters, optimizer state and cache; the batch global, as
    the step cuts it), and the specs the reference's ``jit`` is given."""
    dpx = dp_axes(mesh)
    dps = dp_size(mesh)
    sizes = dict(mesh.shape)
    opt_cfg = adamw.AdamWConfig()
    pshapes = _eval_param_shapes(model)
    pspecs = shd.param_specs(pshapes, sizes)
    specs_in = input_specs(cfg, shape)
    params = sharded.place_params(mesh, pshapes)

    if shape.kind == "train":
        def train_step(params, opt_state, batch):
            return sharded.sharded_train_step(model, mesh, params, opt_state, batch, opt_cfg)

        oshapes = _opt_shapes(pshapes)
        ospecs = {"m": pspecs, "v": pspecs, "step": P()}
        bspecs = shd.batch_specs(specs_in, dpx, sizes)
        args = (params, sharded.place_opt_state(mesh, oshapes), specs_in)
        return train_step, args, (pspecs, ospecs, bspecs), (P(), pspecs, ospecs)

    cache_len = _cache_len(cfg, shape)
    cache = sharded.init_cache(model, mesh, shape.global_batch, cache_len)
    cspecs = shd.cache_specs(model.init_cache(shape.global_batch, cache_len, device="meta"),
                             shape.global_batch, dps, dpx, sizes)

    if shape.kind == "prefill":
        def prefill_step(params, batch, cache):
            return sharded.sharded_prefill(model, mesh, params, batch, cache, pos=0)

        bspecs = shd.batch_specs(specs_in, dpx, sizes)
        return prefill_step, (params, specs_in, cache), (pspecs, bspecs, cspecs), (P(), cspecs)

    # decode: one new token against a cache of seq_len, written into its
    # last position
    tok_spec = {"tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                      device="meta")}
    if cfg.enc_dec:
        # the encoder's output for seq_len frames, placed as sharded_prefill
        # places it (the reference's cache holds None there, and its
        # cross-attention then attends to the new token alone)
        memory = {"memory": torch.empty((shape.global_batch, shape.seq_len, cfg.d_model),
                                        dtype=torch_dtype(cfg.dtype), device="meta")}
        spec = shd.batch_specs(memory, dpx, sizes)
        cache["memory"] = shd.place(memory, shd.make_sharding(mesh, spec))["memory"]

    def serve_step(params, cache, batch):
        return sharded.sharded_decode_step(model, mesh, params, cache, batch["tokens"],
                                           pos=cache_len - 1)

    bspecs = (shd.batch_specs(tok_spec, dpx, sizes) if shape.global_batch >= dps
              else T.tree_map(lambda l: P(), tok_spec))
    return serve_step, (params, cache, tok_spec), (pspecs, cspecs, bspecs), (P(), cspecs)


def collective_stats(calls) -> Dict[str, Dict[str, float]]:
    """``{kind: {count, operand_bytes, result_bytes}}`` over rank 0's
    collective calls (``spmd.Trace.collectives``), by HLO kind; a group of
    one rank moves no data and is left out."""
    out: Dict[str, Dict[str, float]] = {}
    for name, n, sent, got in calls:
        if n < 2:
            continue
        d = out.setdefault(HLO_KIND[name], {"count": 0, "operand_bytes": 0.0,
                                            "result_bytes": 0.0})
        d["count"] += 1
        d["operand_bytes"] += sent
        d["result_bytes"] += got
    return out


def trace_step(model, cfg, shape, mesh, rank0_only: bool = True) -> Dict[str, Any]:
    """Trace one cell's step on ``mesh`` (``meta`` devices): the row's
    ``memory``, ``cost``, ``collectives``, ``collective_bytes`` and
    ``trace_s``, from rank 0."""
    flops = [0]

    @contextlib.contextmanager
    def count_flops():
        with FlopCounterMode(display=False) as fc:
            yield
        flops[0] += fc.get_total_flops()

    t0 = time.perf_counter()
    fn, args, _, _ = build_step(model, cfg, shape, mesh)
    backend = oplib.get_backend()
    oplib.set_backend("torch")    # the kernels take no meta tensors
    try:
        with spmd.tracing(rank0_only=rank0_only, rank0_context=count_flops) as tr:
            fn(*args)
    finally:
        oplib.set_backend(backend)
    trace_s = time.perf_counter() - t0
    arg_bytes = sum(c["args"] for c in tr.calls)
    out_bytes = sum(c["result"] + c["written"] for c in tr.calls)
    colls = collective_stats(tr.collectives)
    return {
        "trace_s": round(trace_s, 1),
        "memory": {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes},
        "cost": {"flops": float(flops[0])},
        "cost_note": "rank 0's FLOPs (FlopCounterMode); no bytes accessed on meta tensors: "
                     "roofline uses its analytic bytes",
        "collectives": colls,
        "collective_bytes": sum(d["operand_bytes"] for d in colls.values()),
    }


def run_cell(arch: str, shape_name, multi_pod: bool = False, rank0_only: bool = True,
             mesh=None, cfg=None) -> Dict[str, Any]:
    """One cell's row (``shape_name``: a key of ``SHAPES``, or a
    ``ShapeSpec``).  ``mesh`` (default: the production mesh over ``meta``
    devices) and ``cfg`` (default: the registry's ``arch``) let a test
    trace a scaled config on a small mesh."""
    cfg = cfg or configs.get(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if mesh is None:
        n = 512 if multi_pod else 256
        mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    model = build_model(cfg)
    return {
        "arch": arch,
        "shape": shape.name,
        "mesh": "x".join(str(s) for s in mesh.shape.values()),
        "n_devices": mesh.size,
        "ok": True,
        "rank0_only": rank0_only,
        **trace_step(model, cfg, shape, mesh, rank0_only=rank0_only),
        "scan_trip_count": 1,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }


def all_cells():
    for arch in configs.names():
        cfg = configs.get(arch)
        for shape in applicable_shapes(cfg):
            yield arch, shape.name


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch} x {shape} [{'2x16x16' if mp else '16x16'}]"
            try:
                r = run_cell(arch, shape, multi_pod=mp)
                mm = r["memory"].get("argument_size_in_bytes", 0) / (1 << 30)
                print(f"OK   {tag}: trace={r['trace_s']}s args={mm:.1f}GiB "
                      f"flops={r['cost'].get('flops', 0):.3e} coll={r['collective_bytes']:.3e}B",
                      flush=True)
                results.append(r)
            except Exception as e:
                n_fail += 1
                print(f"FAIL {tag}: {e}", flush=True)
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape,
                                "mesh": "2x16x16" if mp else "16x16",
                                "ok": False, "error": str(e)})
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    print(f"done: {len(results) - n_fail}/{len(results)} cells passed", flush=True)
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
