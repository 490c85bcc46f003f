#!/usr/bin/env python3
"""Where a call of the multi-device path spends its time, on one NVIDIA
card with four ranks emulated on it (``Mesh(["cuda:0"] * 4)``): what
``chip_smoke.py`` phase 14 does not record.

    python3 scripts/mesh_overhead.py

The host clock (``chip_smoke._host_ms``: median of ``--reps`` calls, each
ending in ``torch.cuda.synchronize()``) of an empty ``shard_map`` (the
ranks' threads and nothing else), one ``all_gather`` of a small tensor
and one ``psum``.  Then one call of phase 14's ffn and halo-conv programs
through ``stripe_jit(mesh=)`` and of their single-device compiles under
``torch.profiler``: the card's busy time, idle share and kernels
(``scripts/model_profile.py``'s ``profile_call``).  One JSON line, with
the card's name and power limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("mesh_overhead: needs an NVIDIA card")
    import chip_smoke
    from model_profile import profile_call
    from repro_torch import api
    from repro_torch.core import cache as stripe_cache
    from repro_torch.parallel import spmd
    from repro_torch.parallel.spmd import Mesh, P

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke._card_line()
    n = chip_smoke.MESH_RANKS
    mesh = Mesh(["cuda:0"] * n, ("x",))
    x = torch.ones(n, 64, device="cuda")
    out = {"card": card, "ranks": n, "reps": args.reps}
    bare = {
        "empty": spmd.shard_map(lambda a: a, mesh, (P("x"),), P("x")),
        "all_gather": spmd.shard_map(lambda a: spmd.all_gather(a, "x", tiled=True), mesh,
                                     (P("x"),), P()),
        "psum": spmd.shard_map(lambda a: spmd.psum(a, "x"), mesh, (P("x"),), P()),
    }
    out["shard_map_host_ms"] = {k: chip_smoke._host_ms(torch, lambda f=f: f(x), args.reps)
                                for k, f in bare.items()}

    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    progs = chip_smoke._mesh_programs(api)
    keys = ("host_ms", "device_busy_ms", "idle_share", "kernels")
    for name in ("ffn", "conv2_x_halo"):
        prog, hw = progs[name]
        cache = stripe_cache.CompilationCache(use_disk=False)
        meshed = api.jit(prog, hw, "cuda", cache=cache, use_disk=False, mesh=mesh)
        single = api.jit(prog, hw, "cuda", cache=cache, use_disk=False)
        env = {k: torch.randn(prog.buffers[k].shape, generator=gen, device="cuda")
               for k in prog.inputs}
        prof = profile_call(torch, lambda: meshed(env))
        row = {"mesh_profile": {k: prof[k] for k in keys + ("top_kernels",)}}
        prof = profile_call(torch, lambda: single(env))
        row["single_profile"] = {k: prof[k] for k in keys}
        out[name] = row
    print(json.dumps(out))
    print(card)


if __name__ == "__main__":
    main()
