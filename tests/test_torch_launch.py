"""The port's last slice of ``launch/`` (``hlo_stats.py``, ``roofline.py``,
``dryrun.py``) and the rank-0 tracing of ``parallel/spmd.py`` against the
JAX package, on the CPU.

* **hlo_stats** is a copy: its ``collective_stats`` equals the
  reference's on the HLO text of ``tests/test_system.py``'s parser test
  and on a text with a ``reduce-scatter``, a ``collective-permute`` and
  tuple-typed async starts.
* **roofline**: given the reference's TPU constants, the port's
  ``analyze`` and ``markdown_table`` equal the reference's on rows the
  test writes for every (arch x shape) of ``applicable_shapes`` on both
  production meshes; under the port's own defaults (the H100's data-sheet
  figures) every ``roofline_fraction`` is at most 1.
* **The dry run against the compiled reference**: the reference's
  ``build_step`` compiled on ``jax.make_mesh((2, 4))`` gives the same
  per-device ``argument_size_in_bytes`` as the port's ``run_cell`` on a
  ``meta`` (2, 4) mesh, exactly, for scaled llama3-8b, qwen3-moe-30b-a3b,
  zamba2-2.7b and xlstm-125m train steps.  No dim pads: the sharding
  rules (``_guard``, in both packages) drop an axis that does not divide
  its dim, so every shard is its dim over the axes, and the per-leaf
  shard bytes of the reference's ``NamedSharding``\\ s add up to its
  ``memory_analysis()`` too.
* **C18**: the reference's dry run of a prefill and a decode step raises
  ``ShardingTypeError`` in JAX 0.9 (its ``dynamic_update_slice`` of the
  KV cache): the day it compiles, this test says so.
* **Rank 0 alone** (``spmd.tracing(rank0_only=True)``) gives the row that
  tracing every rank gives, key for key but the host time, on meta (2, 4)
  and (1, 4), for one config of each family, train, prefill and decode.
* **Against a real run**: the meta dry run's collectives (kind, count,
  bytes sent) and argument bytes equal those of the same sharded step on
  ``Mesh(["cpu"] * 8)`` with real scaled weights, counted by wrapping the
  collectives as ``chip_smoke.collective_census`` does.
* **FLOPs**: rank 0's count times the ranks equals the single-device
  ``FlopCounterMode`` count of ``loss_and_grads``, exactly (tolerance 0),
  where the KV heads divide over 'model'; where they do not (llama3-8b's
  2 KV heads over 4 'model' ranks) the excess is exactly the replicated
  work: each rank projects its q heads' KV head, so 4 ranks project 4
  KV heads where one device projects 2.
* Rank 0 alone on a mesh with any non-``meta`` device raises; a serving
  call on a ``meta`` cache needs its position.
* The CLI: ``python -m repro_torch.launch.dryrun`` on one cell of the
  16 x 16 ``meta`` mesh, read by ``python -m repro_torch.launch.roofline``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.launch import dryrun as j_dryrun  # noqa: E402
from repro.launch import hlo_stats as j_hlo  # noqa: E402
from repro.launch import roofline as j_roof  # noqa: E402
from repro.models.build import build_model as j_build  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.base import ShapeSpec, applicable_shapes  # noqa: E402
from repro_torch.launch import dryrun, hlo_stats, roofline  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.build import build_model, input_specs, make_batch  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharded, spmd  # noqa: E402
from repro_torch.parallel import sharding as t_shd  # noqa: E402
from repro_torch.train.loop import loss_and_grads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the small cells of these tests: batch 4 splits over 'data' = 2 and 4
TRAIN = ShapeSpec("train_small", 16, 4, "train")
PREFILL = ShapeSpec("prefill_small", 16, 4, "prefill")
DECODE = ShapeSpec("decode_small", 16, 4, "decode")
KINDS = {"train": TRAIN, "prefill": PREFILL, "decode": DECODE}
# shorter still where every rank runs (one thread each)
SHORT = {kind: dataclasses.replace(s, seq_len=8) for kind, s in KINDS.items()}
# one config of each family: dense, moe, vlm, hybrid, ssm, audio
FAMILY_CONFIGS = ["llama3-8b", "qwen3-moe-30b-a3b", "internvl2-26b", "zamba2-2.7b",
                  "xlstm-125m", "seamless-m4t-large-v2"]


def _meta_mesh(shape):
    return make_mesh(shape, ("data", "model"), ["meta"] * int(np.prod(shape)))


def _row(name, shape, mesh_shape, rank0_only=True, cfg=None):
    cfg = cfg or t_configs.get(name).scaled()
    return dryrun.run_cell(name, shape, cfg=cfg, mesh=_meta_mesh(mesh_shape),
                           rank0_only=rank0_only)


# ---------------------------------------------------------------------------
# hlo_stats
# ---------------------------------------------------------------------------
SYSTEM_HLO = """
ENTRY %main {
  %p0 = f32[8,16]{1,0} parameter(0)
  %ag = f32[64,16]{1,0} all-gather(%p0), replica_groups={}
  %w = f32[64,16]{1,0} while(%ag), condition=%cond.1, body=%body.2
}
%body.2 (x: f32[64,16]) -> f32[64,16] {
  %x = f32[64,16]{1,0} parameter(0)
  %ar = f32[64,16]{1,0} all-reduce(%x), to_apply=%add
}
"""

ASYNC_HLO = """
ENTRY %main {
  %p0 = bf16[8,128]{1,0} parameter(0)
  %p1 = f32[4]{0} parameter(1)
  %rs = bf16[2,128]{1,0} reduce-scatter(%p0), dimensions={0}, to_apply=%add
  %cp = f32[4]{0} collective-permute(%p1), source_target_pairs={{0,1},{1,0}}
  %ars = (f32[4]{0}, bf16[8,128]{1,0}) all-reduce-start(%p1, %p0), to_apply=%add
  %ags = (bf16[8,128]{1,0}, bf16[32,128]{1,0}) all-gather-start(%p0), dimensions={0}
}
"""


@pytest.mark.parametrize("text,mult,expect", [
    (SYSTEM_HLO, 10, {"all-gather": (1, 512, 4096), "all-reduce": (10, 40960, 40960)}),
    (ASYNC_HLO, 1, {"reduce-scatter": (1, 2048, 512), "collective-permute": (1, 16, 16),
                    "all-reduce": (1, 2064, 2064), "all-gather": (1, 2048, 10240)}),
], ids=["system", "async_tuple"])
def test_collective_stats_matches_reference(text, mult, expect):
    got = hlo_stats.collective_stats(text, body_multiplier=mult)
    assert got == j_hlo.collective_stats(text, body_multiplier=mult)
    assert {k: (v["count"], v["operand_bytes"], v["result_bytes"]) for k, v in got.items()} == expect
    assert hlo_stats.total_collective_bytes(text, mult) == j_hlo.total_collective_bytes(text, mult)
    assert hlo_stats.COLLECTIVES == j_hlo.COLLECTIVES


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------
def _written_rows():
    """A row for every (arch x shape) of ``applicable_shapes`` on both
    production meshes, its numbers drawn from a seed; every fourth without
    ``bytes accessed`` (as the port's dry run writes them)."""
    rng = np.random.RandomState(0)
    rows = []
    for arch in t_configs.names():
        for shape in applicable_shapes(t_configs.get(arch)):
            for mesh, n in (("16x16", 256), ("2x16x16", 512)):
                cost = {"flops": float(10 ** rng.uniform(8, 15))}
                if len(rows) % 4:
                    cost["bytes accessed"] = float(10 ** rng.uniform(8, 12))
                rows.append({"arch": arch, "shape": shape.name, "mesh": mesh, "n_devices": n,
                             "ok": True, "cost": cost,
                             "memory": {"argument_size_in_bytes": int(10 ** rng.uniform(8, 11))},
                             "collective_bytes": float(10 ** rng.uniform(5, 11))})
    rows.append({"arch": "llama3-8b", "shape": "train_4k", "mesh": "16x16", "ok": False,
                 "error": "a failed cell is left out"})
    return rows


def test_roofline_matches_reference_under_its_constants():
    rows = _written_rows()
    assert len(rows) == 2 * 32 + 1
    got = roofline.analyze(rows, peak_flops=j_roof.PEAK_FLOPS, hbm_bw=j_roof.HBM_BW,
                           link_bw=j_roof.LINK_BW)
    want = j_roof.analyze(rows)
    assert got == want and len(got) == 64
    assert roofline.markdown_table(got) == j_roof.markdown_table(want)
    for r in rows[:-1]:
        assert roofline.model_flops_per_chip(r) == j_roof.model_flops_per_chip(r)
        assert roofline.analytic_bytes_per_chip(r) == j_roof.analytic_bytes_per_chip(r)


def test_roofline_defaults_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)
    rows = roofline.analyze(_written_rows())
    assert len(rows) == 64
    assert all(0 < r["roofline_fraction"] <= 1.0 + 1e-12 for r in rows)
    assert len(roofline.worst(rows)) == 5 and all(r["mesh"] == "16x16" for r in roofline.worst(rows))
    assert "MXU" not in json.dumps(roofline.NOTES) and "TPU" not in roofline.__doc__


# ---------------------------------------------------------------------------
# the dry run against the reference's compiled step
# ---------------------------------------------------------------------------
def _j_compiled(name, shape):
    cfg = j_configs.get(name).scaled()
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    fn, args, in_sh, out_sh = j_dryrun.build_step(j_build(cfg), cfg, shape, mesh)
    to = lambda tree: jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                                   is_leaf=lambda x: isinstance(x, JP))
    with mesh:
        shardings = tuple(to(s) for s in in_sh)
        jitted = jax.jit(fn, in_shardings=shardings, out_shardings=to(out_sh))
        return jitted.lower(*args).compile(), args, shardings


@pytest.mark.distributed
@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-moe-30b-a3b", "zamba2-2.7b", "xlstm-125m"])
def test_train_argument_bytes_match_the_compiled_reference(name):
    compiled, args, shardings = _j_compiled(name, JShape("train_small", 16, 4, "train"))
    want = compiled.memory_analysis().argument_size_in_bytes
    shards = sum(int(np.prod(sh.shard_shape(a.shape))) * a.dtype.itemsize
                 for a, sh in zip(jax.tree.leaves(args), jax.tree.leaves(shardings)))
    assert shards == want        # no padding
    row = _row(name, TRAIN, (2, 4))
    assert row["ok"] and row["n_devices"] == 8 and row["mesh"] == "2x4"
    assert row["memory"]["argument_size_in_bytes"] == want


@pytest.mark.distributed
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_reference_serving_dry_run_raises_c18(kind):
    """ROADMAP C18: in JAX 0.9 the reference's dry run of a serving step
    fails to lower (the KV cache's ``dynamic_update_slice`` under the
    cache's and the update's shardings), so the port's serving rows are
    held against its own real runs (``chip_smoke.py`` phase 17 (b) and
    the tests below).  The day this compiles, this test fails."""
    from jax._src.core import ShardingTypeError

    with pytest.raises(ShardingTypeError, match="dynamic_update_slice"):
        _j_compiled("llama3-8b", JShape(f"{kind}_small", 16, 4, kind))
    row = _row("llama3-8b", KINDS[kind], (2, 4))
    assert row["ok"] and row["memory"]["argument_size_in_bytes"] > 0
    # the specs the port's build_step states are the ones the reference's
    # jit is given
    j_cfg, t_cfg = j_configs.get("llama3-8b").scaled(), t_configs.get("llama3-8b").scaled()
    _, _, j_in, j_out = j_dryrun.build_step(j_build(j_cfg), j_cfg, JShape("s", 16, 4, kind),
                                            jax.make_mesh((2, 4), ("data", "model")))
    _, _, t_in, t_out = dryrun.build_step(build_model(t_cfg), t_cfg, KINDS[kind],
                                          _meta_mesh((2, 4)))
    # (a group of one axis is that axis: jax's PartitionSpec writes it so)
    one = lambda spec: tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)
    j_specs = [one(s) for s in jax.tree.leaves((j_in, j_out),
                                               is_leaf=lambda x: isinstance(x, JP))]
    t_specs = []
    t_shd.map_specs(lambda s: t_specs.append(one(s)), (t_in, t_out))
    assert t_specs == j_specs and len(t_specs) >= 20


# ---------------------------------------------------------------------------
# rank 0 alone against every rank
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 4)], ids=["2x4", "1x4"])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", FAMILY_CONFIGS)
def test_rank0_alone_equals_every_rank(name, kind, mesh_shape):
    alone = _row(name, SHORT[kind], mesh_shape, rank0_only=True)
    every = _row(name, SHORT[kind], mesh_shape, rank0_only=False)
    assert alone.pop("rank0_only") and not every.pop("rank0_only")
    alone.pop("trace_s"), every.pop("trace_s")
    assert alone == every
    assert alone["ok"] and alone["cost"]["flops"] > 0 and alone["collective_bytes"] > 0
    assert set(alone["collectives"]) <= set(hlo_stats.COLLECTIVES)


# ---------------------------------------------------------------------------
# the meta dry run against a real run on CPU ranks
# ---------------------------------------------------------------------------
def _census(monkeypatch):
    """Rank 0's collectives by HLO kind, with the bytes each sends, counted
    by wrapping the public collectives (``chip_smoke.collective_census``)."""
    out = {}

    def counted(name, fn):
        def call(x, *a, **kw):
            if spmd.current_rank() == 0:
                row = out.setdefault(dryrun.HLO_KIND[name], [0, 0])
                row[0] += 1
                row[1] += sum(t.numel() * t.element_size() for t in T.leaves(x))
            return fn(x, *a, **kw)
        return call

    for name in ("psum", "pmax", "all_gather", "psum_scatter", "ppermute"):
        monkeypatch.setattr(spmd, name, counted(name, getattr(spmd, name)))
    return out


def _placed_bytes(tree, rank=0):
    return sum(leaf.shards[rank].numel() * leaf.shards[rank].element_size()
               for leaf in T.leaves(tree) if isinstance(leaf, spmd.Placed))


@pytest.mark.parametrize("name,kind", [("llama3-8b", "train"), ("llama3-8b", "prefill"),
                                       ("llama3-8b", "decode"), ("qwen3-moe-30b-a3b", "train"),
                                       ("zamba2-2.7b", "decode")])
def test_meta_collectives_equal_a_real_run(monkeypatch, name, kind):
    shape = KINDS[kind]
    meta = _row(name, shape, (2, 4))
    cfg = t_configs.get(name).scaled()
    model = build_model(cfg)
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    placed = sharded.place_params(mesh, params)
    batch = make_batch(cfg, kind, shape.global_batch, shape.seq_len, seed=0, device="cpu")
    census = _census(monkeypatch)
    if kind == "train":
        state = sharded.place_opt_state(mesh, adamw.init_state(params))
        args = _placed_bytes(placed) + _placed_bytes(state)
        sharded.sharded_train_step(model, mesh, placed, state, batch, adamw.AdamWConfig())
        per_rank = shape.global_batch // 2
        args += sum(t[:per_rank].numel() * t.element_size() for t in batch.values())
    else:
        cache = sharded.init_cache(model, mesh, shape.global_batch, shape.seq_len)
        args = _placed_bytes(placed) + _placed_bytes(cache)
        if kind == "prefill":
            sharded.sharded_prefill(model, mesh, placed, batch, cache)
            args += sum(t[:shape.global_batch // 2].numel() * t.element_size()
                        for t in batch.values())
        else:
            # the dry run decodes into the cache's last position
            for path, leaf in T.flatten_with_path(cache)[0]:
                if path[-1] == "pos":
                    for s in leaf.shards:
                        s.fill_(shape.seq_len - 1)
            tokens = batch["tokens"][:, :1]
            sharded.sharded_decode_step(model, mesh, placed, cache, tokens)
            args += tokens[:shape.global_batch // 2].numel() * 4
    want = {k: (n, b) for k, (n, b) in census.items()}
    got = {k: (d["count"], d["operand_bytes"]) for k, d in meta["collectives"].items()}
    assert got == want
    assert meta["memory"]["argument_size_in_bytes"] == args


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv", [4, 2], ids=["kv_divides", "kv_replicated"])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 1)], ids=["2x4", "4x1"])
def test_rank0_flops_times_ranks_equal_one_device(kv, mesh_shape):
    from torch.utils.flop_counter import FlopCounterMode

    cfg = t_configs.get("llama3-8b").scaled(n_kv_heads=kv)
    model = build_model(cfg)
    with FlopCounterMode(display=False) as fc:
        loss_and_grads(model, model.init(torch.Generator(), device="meta"),
                       input_specs(cfg, TRAIN), remat=False)
    single = fc.get_total_flops()
    row = _row("llama3-8b", TRAIN, mesh_shape, cfg=cfg)
    m = mesh_shape[1]
    # each 'model' rank projects the KV heads of its q heads: max(kv, m)
    # heads in all where one device projects kv (forward, and the
    # backward's two products: 3 products of 2 * tokens * d * hd a head,
    # for k and v, a layer)
    tokens = TRAIN.global_batch * TRAIN.seq_len
    replicated = (max(kv, m) - kv) * 3 * 2 * tokens * cfg.d_model * cfg.hd * 2 * cfg.n_layers
    assert row["cost"]["flops"] * int(np.prod(mesh_shape)) - single == replicated
    assert (replicated > 0) == (kv == 2 and m == 4)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("devices", [["cpu"] * 8, ["meta"] * 7 + ["cpu"]], ids=["cpu", "mixed"])
def test_rank0_alone_refuses_a_mesh_with_real_devices(devices):
    mesh = make_mesh((2, 4), ("data", "model"), devices)
    fn = spmd.shard_map(lambda x: spmd.psum(x, "model"), mesh, (spmd.P(),), spmd.P())
    with spmd.tracing(rank0_only=True), pytest.raises(ValueError, match="meta devices"):
        fn(torch.ones(3))
    if "meta" not in devices:
        assert torch.equal(fn(torch.ones(3)), torch.full((3,), 4.0))


def test_a_meta_cache_needs_its_position():
    cfg = t_configs.get("llama3-8b").scaled()
    model = build_model(cfg)
    mesh = _meta_mesh((1, 4))
    params = sharded.place_params(mesh, model.init(torch.Generator(), device="meta"))
    cache = sharded.init_cache(model, mesh, 4, 16)
    tokens = torch.empty((4, 1), dtype=torch.int32, device="meta")
    with spmd.tracing(rank0_only=True), pytest.raises(ValueError, match="pass pos="):
        sharded.sharded_decode_step(model, mesh, params, cache, tokens)
    with spmd.tracing(rank0_only=True) as tr:
        logits, _ = sharded.sharded_decode_step(model, mesh, params, cache, tokens, pos=15)
    assert logits.device.type == "meta" and logits.shape == (4, 1, cfg.padded_vocab)
    assert len(tr.calls) == 1 and tr.collectives


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------
def test_dryrun_and_roofline_command_lines(tmp_path):
    out = tmp_path / "dry.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "qwen3-4b", "--shape", "decode_32k", "--out", str(out)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    (row,) = json.loads(out.read_text())
    assert row["ok"] and row["mesh"] == "16x16" and row["n_devices"] == 256 and row["rank0_only"]
    assert row["scan_trip_count"] == 1 and "bytes accessed" not in row["cost"]
    assert set(row["collectives"]) <= set(hlo_stats.COLLECTIVES)
    assert row["params"] == j_configs.get("qwen3-4b").param_count()
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", str(out)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "| qwen3-4b | decode_32k | 16x16 |" in run.stdout
    assert "worst roofline fractions" in run.stdout
    (roof,) = json.loads((tmp_path / "dry_roofline.json").read_text())
    assert 0 < roof["roofline_fraction"] <= 1.0
