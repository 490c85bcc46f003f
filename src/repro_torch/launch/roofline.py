"""Roofline analysis over dry-run results, the twin of the JAX package's
``launch/roofline.py`` with the H100's figures for the chip's.

Per (arch x shape x mesh) cell, derives the three roofline terms from the
row that ``dryrun.py`` records:

    compute term    = FLOPs / peak_FLOPs            (per-card seconds)
    memory term     = bytes / HBM_bw
    collective term = collective_bytes / link_bw

The port's dry run counts rank 0's FLOPs (``FlopCounterMode``), so the
/chips is already applied.  It has no bytes accessed (``meta`` tensors
have no allocator and no compiler costs them): the memory term is the
analytic one alone.  As in the reference, the ANALYTIC columns use
MODEL_FLOPS (6·N·D train / 2·N_active·D inference) and a parameter +
cache traffic model as the lower bound per step, and the larger of each
pair counts.  Every layer's collectives are counted (no loop body is
costed once).

The defaults are the NVIDIA H100 SXM's data-sheet figures: 989e12 dense
bf16 FLOP/s on the tensor cores, 3.35e12 B/s of HBM3, and 450e9 B/s a
direction of NVLink 4 (18 links of 25 GB/s).  None is measured here: on
the one card the port's ranks are host threads, and no link is crossed.
``analyze(rows, peak_flops=..., hbm_bw=..., link_bw=...)`` takes others.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline dryrun_results.json
"""
import json
import sys
from typing import Dict, List

PEAK_FLOPS = 989e12   # bf16 dense per card (data sheet)
HBM_BW = 3.35e12      # bytes/s per card (data sheet)
LINK_BW = 450e9       # bytes/s a direction, NVLink 4 (data sheet)

from .. import configs
from ..configs.base import SHAPES


def model_flops_per_chip(r: Dict) -> float:
    cfg = configs.get(r["arch"])
    shape = SHAPES[r["shape"]]
    chips = r["n_devices"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * cfg.param_count() * tokens / chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * cfg.active_param_count() * tokens / chips
    tokens = shape.global_batch  # one new token per sequence
    return 2.0 * cfg.active_param_count() * tokens / chips


def analytic_bytes_per_chip(r: Dict) -> float:
    """Per-step HBM traffic lower bound: every resident param shard is
    read (weights stream from HBM once per use: fwd+bwd+remat for train),
    plus optimizer state r/w for train, plus the full KV/state cache for
    decode."""
    cfg = configs.get(r["arch"])
    shape = SHAPES[r["shape"]]
    chips = r["n_devices"]
    p = cfg.param_count()
    if shape.kind == "train":
        # params bf16 x (fwd + bwd-read + remat) + grads f32 + adam m,v r/w
        return (3 * 2 * p + 4 * p + 4 * 4 * p) / chips
    if shape.kind == "prefill":
        return 2 * cfg.active_param_count() / chips
    cache = r["memory"].get("argument_size_in_bytes", 0)  # incl. cache shard
    return 2 * cfg.active_param_count() / chips + cache * 0.5


def analyze(results: List[Dict], peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
            link_bw: float = LINK_BW) -> List[Dict]:
    rows = []
    for r in results:
        if not r.get("ok"):
            continue
        flops = r["cost"].get("flops", 0.0)
        byts = r["cost"].get("bytes accessed", 0.0)
        coll = r.get("collective_bytes", 0.0)
        mf = model_flops_per_chip(r)
        ab = analytic_bytes_per_chip(r)

        t_c_raw = flops / peak_flops
        t_m_raw = byts / hbm_bw
        t_x = coll / link_bw
        t_c = max(t_c_raw, mf / peak_flops)
        t_m = max(t_m_raw, ab / hbm_bw)
        terms = {"compute": t_c, "memory": t_m, "collective": t_x}
        dom = max(terms, key=terms.get)
        intrinsic = max(t_c, t_m)                 # hardware-imposed floor
        frac = intrinsic / max(max(terms.values()), 1e-30)
        rows.append({
            **{k: r[k] for k in ("arch", "shape", "mesh", "n_devices")},
            "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
            "t_compute_raw_s": t_c_raw, "t_memory_raw_s": t_m_raw,
            "dominant": dom,
            "model_flops_per_chip": mf,
            "hlo_flops_per_chip": flops,
            "useful_ratio": (mf / flops) if flops else float("inf"),
            "roofline_fraction": frac,
        })
    return rows


NOTES = {
    "compute": "already tensor-core-bound: gains come from stenciling/fusion keeping the "
               "tensor cores fed (wgmma tiles, fewer launches)",
    "memory": "HBM-bound: increase arithmetic intensity (larger tiles, multiquery batching, quantized weights/cache)",
    "collective": "network-bound: fix sharding so activations/grads stay local; overlap with compute (ring collective-matmul); compress inter-node grads",
}


def markdown_table(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | MODEL_FLOPS/chip | HLO_FLOPs/chip | useful | roofline frac |")
    sep = "|" + "---|" * 11
    out = [hdr, sep]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} "
            f"| **{r['dominant']}** | {r['model_flops_per_chip']:.2e} "
            f"| {r['hlo_flops_per_chip']:.2e} | {min(r['useful_ratio'], 99.0):.2f} "
            f"| {r['roofline_fraction']:.3f} |")
    return "\n".join(out)


def worst(rows: List[Dict], n: int = 5) -> List[Dict]:
    """The ``n`` single-pod rows furthest from their roofline."""
    single = [r for r in rows if r["mesh"] == "16x16"]
    return sorted(single, key=lambda r: r["roofline_fraction"])[:n]


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json"
    results = json.load(open(path))
    rows = analyze(results)
    print(markdown_table(rows))
    out = path.replace(".json", "_roofline.json")
    json.dump(rows, open(out, "w"), indent=1)
    print("\nworst roofline fractions (single-pod):")
    for r in worst(rows):
        print(f"  {r['arch']} x {r['shape']}: {r['roofline_fraction']:.3f} ({r['dominant']}) -> {NOTES[r['dominant']]}")


if __name__ == "__main__":
    main()
