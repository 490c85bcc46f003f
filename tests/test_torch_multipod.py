"""The multi-pod mesh's 'pod' axis in the port's sharded step
(``parallel/sharded.py`` on ``('pod', 'data', 'model')`` meshes) and the
dry run's multi-pod rows (``launch/dryrun.py``), against the JAX package,
on CPU ranks of the port (``Mesh(["cpu"] * 8)``), at the registry's
``scaled()`` widths, numpy inputs from a seed.

The reference's rules make 'pod' pure data parallelism: parameters are
replicated across pods, batches (and a batch-1 cache's sequence) are cut
on ``('pod', 'data')``, 'pod' major.  The reference has no meshed loss in
JAX 0.9 (ROADMAP C0), so, as in ``test_torch_sharding.py``:

* **training**: the sharded loss and gradients of all ten configs on
  ``(2, 2, 2)`` and ``(2, 1, 4)`` against the reference's single-device
  loss and ``jax.grad`` at ``test_torch_sharding.py``'s bounds (loss rtol
  2e-4, each gradient leaf 1e-4 x (1 + max)), then one
  ``sharded_train_step`` against ``adamw.apply_updates`` (each parameter
  within 1e-5 x (1 + max)); and the loss and gradients against the
  port's own ``(4, 2)`` ``('data', 'model')`` run, whose batch blocks are
  the same, within 1e-6 x (1 + max);
* **serving**: sharded prefill and 3 decode steps against the
  reference's single-device ``prefill`` / ``decode_step``, the logits and
  every cache leaf within 1e-4 x (1 + max): the batch on ``('pod',
  'data')``, and batch 1 with the KV cache's sequence on ``('pod',
  'data')`` (each new position written by the rank that owns it, 'pod'
  major);
* **MoE**: qwen3-moe at capacity 1.0 drops tokens, and the sharded
  dispatch buffer of the first layer (its experts on 'model', its
  capacity on 'data', the same on both pods) holds the reference's tokens
  in the reference's slots: the same tokens dropped;
* **the dry run** on the ``(2, 2, 2)`` mesh: rank 0 alone equals every
  rank; its collectives and argument bytes equal a real run on
  ``["cpu"] * 8``; ``build_step``'s specs equal the reference's
  ``build_step`` on ``jax.make_mesh((2, 2, 2), ("pod", "data",
  "model"))``; its argument bytes equal the reference's compiled
  ``memory_analysis()``, which compiles the train, prefill and decode
  steps on this mesh (C18 reaches only the single-pod one);
* the command line: ``--multi-pod`` and ``--both-meshes`` rows ``ok`` on
  ``2x16x16`` with 512 devices, read by ``roofline``.
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
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.launch import dryrun as j_dryrun  # noqa: E402
from repro.models.build import build_model as j_build  # noqa: E402
from repro.models.build import make_batch as j_batch  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import dp_axes, make_mesh  # noqa: E402
from repro_torch.models.build import build_model, make_batch  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharded, spmd  # noqa: E402
from repro_torch.parallel import sharding as t_shd  # noqa: E402

from test_torch_launch import _census, _placed_bytes  # noqa: E402
from test_torch_sharding import (ALL, GRAD_RTOL, LOGIT_RTOL, LOSS_RTOL, PARAM_RTOL,  # noqa: E402
                                 TIMEOUT, _mesh, _np, _reference, _rel)

POD = ("pod", "data", "model")
POD_MESHES = [(2, 2, 2), (2, 1, 4)]
# the port's own 'data'-only mesh whose batch blocks are (2, 2, 2)'s
DATA_MESH = (4, 2)
SAME_BLOCKS_RTOL = 1e-6
ROOT = Path(__file__).resolve().parents[1]


def _pod_mesh(shape):
    return _mesh(shape, POD)


def _ids(s):
    return "x".join(str(n) for n in s)


def test_the_step_takes_pod_first_and_refuses_other_axes():
    model = api.build_model(api.configs.get("llama3-8b").scaled())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = api.make_batch(model.cfg, "train", 8, 8, device="cpu")
    assert dp_axes(_pod_mesh((2, 2, 2))) == ("pod", "data")
    for shape, names in (((2, 2, 2), ("data", "pod", "model")), ((2, 4), ("pipe", "model"))):
        with pytest.raises(ValueError, match="in that order"):
            sharded.sharded_loss(model, _mesh(shape, names), params, batch)
    # a batch that does not split over ('pod', 'data') is refused in training
    with pytest.raises(ValueError, match="'pod', 'data'"):
        sharded.sharded_loss_and_grads(model, _pod_mesh((2, 2, 2)), params,
                                       api.make_batch(model.cfg, "train", 6, 8, device="cpu"))


# ------------------------------------------------------------------ training
_DATA_RUNS = {}


def _data_mesh_run(name):
    """The port's sharded loss and gradients on (4, 2) ('data', 'model')."""
    if name not in _DATA_RUNS:
        model, params, batch = _reference(name)[:3]
        _DATA_RUNS[name] = sharded.sharded_loss_and_grads(model, _mesh(DATA_MESH), params, batch,
                                                          timeout=TIMEOUT)
    return _DATA_RUNS[name]


@pytest.mark.parametrize("shape", POD_MESHES, ids=_ids)
@pytest.mark.parametrize("name", ALL)
def test_pod_step_matches_single_device_and_the_data_mesh(name, shape):
    model, params, batch, jloss, jgrads, loss, grads = _reference(name)
    mesh = _pod_mesh(shape)
    sloss, sgrads = sharded.sharded_loss_and_grads(model, mesh, params, batch, timeout=TIMEOUT)
    np.testing.assert_allclose(float(sloss), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(sloss), float(loss), rtol=LOSS_RTOL)
    dloss, dgrads = _data_mesh_run(name)
    np.testing.assert_allclose(float(sloss), float(dloss), rtol=SAME_BLOCKS_RTOL)
    paths = [T.key_path(p) for p, _ in T.flatten_with_path(params)[0]]
    for path, got, want, mine, data in zip(paths, sgrads, jgrads, grads, dgrads):
        assert _rel(got, want) <= GRAD_RTOL, (path, _rel(got, want))
        assert _rel(got, mine) <= GRAD_RTOL, (path, _rel(got, mine))
        assert _rel(got, data) <= SAME_BLOCKS_RTOL, (path, _rel(got, data))
    # one AdamW step on the placed shards against apply_updates
    cfg = adamw.AdamWConfig()
    state = adamw.init_state(params)
    want_p, want_s, want_info = adamw.apply_updates(
        params, T.unflatten(T.flatten(params)[1], grads), state, cfg)
    pp, ps = sharded.place_params(mesh, params), sharded.place_opt_state(mesh, state)
    for leaf in T.leaves(pp):
        assert "pod" not in {a for e in leaf.spec for a in ((e,) if isinstance(e, str)
                                                            else (e or ()))}
    info = sharded.sharded_train_step(model, mesh, pp, ps, batch, cfg, timeout=TIMEOUT)
    np.testing.assert_allclose(float(info["grad_norm"]), float(want_info["grad_norm"]),
                               rtol=GRAD_RTOL)
    got_p, got_s = t_shd.assemble(pp), t_shd.assemble(ps)
    for path, a, b in zip(paths, T.leaves(got_p), T.leaves(want_p)):
        assert _rel(a, b) <= PARAM_RTOL, (path, _rel(a, b))
    for key in ("m", "v"):
        for path, a, b in zip(paths, T.leaves(got_s[key]), T.leaves(want_s[key])):
            assert _rel(a, b) <= GRAD_RTOL, (key, path, _rel(a, b))
    assert int(got_s["step"]) == 1


# ----------------------------------------------------------------------- MoE
def _reference_dispatch(name, capacity, monkeypatch):
    """The reference's first-layer dispatch buffer (e, cap, d) on one
    device, and the (token, choice) pairs its capacity drops."""
    import repro.nn.moe as j_moe
    import repro.parallel.constrain as j_constrain
    from repro.nn.attention import attention as j_attention
    from repro.nn.core import apply_norm as j_norm

    jcfg = j_configs.get(name).scaled()
    jcfg = jcfg.scaled(moe=dataclasses.replace(jcfg.moe, capacity_factor=capacity))
    jparams = j_build(jcfg).init(jax.random.PRNGKey(0))
    jbatch = j_batch(jcfg, "train", 8, 32)
    blk = jax.tree.map(lambda a: a[0], jparams["blocks"])
    x = jnp.take(jparams["embed"], jbatch["tokens"], axis=0)
    x = x + j_attention(blk["attn"], j_norm(blk["ln1"], x, jcfg.norm), jcfg)[0]
    seen = []
    monkeypatch.setattr(j_constrain, "constrain", lambda v, *a: seen.append(v) or v)
    j_moe.moe_apply(blk["moe"], j_norm(blk["ln2"], x, jcfg.norm), jcfg)
    h = np.asarray(seen[0])                               # the dispatch buffer
    t, k = x.shape[0] * x.shape[1], jcfg.moe.top_k
    return h, t * k - int(np.count_nonzero(np.abs(h).sum(-1)))


@pytest.mark.parametrize("shape", POD_MESHES, ids=_ids)
def test_moe_at_capacity_one_drops_the_reference_tokens(shape, monkeypatch):
    """At capacity 1.0 the capacity drops tokens; the sharded dispatch
    buffer (the capacity counted from the global token count, positions
    in the global token order, 'pod' major) equals the reference's slot
    by slot: the same tokens kept, in the same places, the same dropped."""
    name = "qwen3-moe-30b-a3b"
    want, dropped = _reference_dispatch(name, 1.0, monkeypatch)
    assert dropped > 0
    model, params, batch = _reference(name, 1.0)[:3]
    mesh = _pod_mesh(shape)
    got = {}
    dispatch = sharded.Rank.moe_dispatch

    def recorded(self, h):
        out = dispatch(self, h)
        got.setdefault(spmd.current_rank(), out.detach().clone())   # the first layer's
        return out

    monkeypatch.setattr(sharded.Rank, "moe_dispatch", recorded)
    sharded.sharded_loss(model, mesh, params, batch, timeout=TIMEOUT)
    pods, data, m = shape
    blocks = {}
    for r, h in got.items():
        c = mesh.coords(r)
        key = (c["model"], c["data"])
        if key in blocks:                     # the pods hold the same buffer
            assert torch.equal(blocks[key], h)
        blocks[key] = h
    def capacity(mi):
        # cut over 'data' where the capacity divides, else whole on each
        parts = [blocks[(mi, di)] for di in range(data)]
        return torch.cat(parts, dim=1) if sum(p.shape[1] for p in parts) == want.shape[1] \
            else parts[0]

    full = torch.cat([capacity(mi) for mi in range(m)], dim=0).numpy()
    assert full.shape == want.shape
    np.testing.assert_array_equal(np.abs(full).sum(-1) != 0, np.abs(want).sum(-1) != 0)
    assert np.abs(full - want).max() <= 1e-5 * (1 + np.abs(want).max())


# ------------------------------------------------------------------- serving
SERVE_CASES = [("llama3-8b", (2, 2, 2), 8), ("llama3-8b", (2, 2, 1), 1),
               ("chatglm3-6b", (2, 1, 4), 4), ("qwen3-moe-30b-a3b", (2, 2, 2), 8),
               ("qwen3-moe-30b-a3b", (2, 2, 1), 1), ("internvl2-26b", (2, 1, 4), 2),
               ("zamba2-2.7b", (2, 2, 2), 8), ("zamba2-2.7b", (2, 2, 1), 1),
               ("zamba2-2.7b", (2, 1, 2), 2), ("xlstm-125m", (2, 2, 2), 8),
               ("xlstm-125m", (2, 2, 1), 1), ("seamless-m4t-large-v2", (2, 2, 2), 8),
               ("seamless-m4t-large-v2", (2, 2, 1), 1)]


@pytest.mark.parametrize("name,shape,batch", SERVE_CASES,
                         ids=[f"{n}-{_ids(s)}-b{b}" for n, s, b in SERVE_CASES])
def test_pod_prefill_and_decode_match_single_device(name, shape, batch):
    jcfg = j_configs.get(name).scaled()
    jm = j_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    jb = j_batch(jcfg, "prefill", batch, 12)
    max_len = 32 + (jcfg.frontend_len if jcfg.frontend == "patches" else 0)
    jlog, jcache = jm.prefill(jparams, jb, jm.init_cache(batch, max_len))
    model = api.build_model(api.configs.get(name).scaled())
    params = api.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tb = {k: _np(v) for k, v in jb.items()}
    mesh = _pod_mesh(shape)
    placed = sharded.place_params(mesh, params)
    scache = sharded.init_cache(model, mesh, batch, max_len)
    kv = next((leaf for path, leaf in T.flatten_with_path(scache)[0] if path[-1] == "k"), None)
    if kv is not None:
        # the batch, or at batch 1 the cached positions, on ('pod', 'data')
        dim = list(kv.spec).index(("pod", "data"))
        assert len(kv.shape) - dim == (4 if batch > 1 else 3)
    slog, scache = sharded.sharded_prefill(model, mesh, placed, tb, scache, timeout=TIMEOUT)
    assert _rel(slog, _np(jlog)) <= LOGIT_RTOL
    tok = slog[:, -1:, :model.cfg.vocab].argmax(-1).int()
    for _ in range(3):
        jlog, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok.numpy()))
        slog, scache = sharded.sharded_decode_step(model, mesh, placed, scache, tok,
                                                   timeout=TIMEOUT)
        assert _rel(slog, _np(jlog)) <= LOGIT_RTOL
        tok = _np(jlog)[:, -1:, :model.cfg.vocab].argmax(-1).int()
    full = t_shd.assemble(scache)
    got, want = T.flatten_with_path(full)[0], jax.tree.leaves(jcache)
    assert len(got) == len(want)
    for (path, a), c in zip(got, want):
        assert tuple(a.shape) == tuple(np.shape(c)), T.key_path(path)
        assert _rel(a, _np(c)) <= LOGIT_RTOL, (T.key_path(path), _rel(a, _np(c)))


# ------------------------------------------------------------------- dry run
SHORT = {"train": ShapeSpec("train_short", 8, 4, "train"),
         "prefill": ShapeSpec("prefill_short", 8, 4, "prefill"),
         "decode": ShapeSpec("decode_short", 8, 4, "decode"),
         "decode_b1": ShapeSpec("decode_b1", 8, 1, "decode")}
FAMILY_CONFIGS = ["llama3-8b", "qwen3-moe-30b-a3b", "internvl2-26b", "zamba2-2.7b",
                  "xlstm-125m", "seamless-m4t-large-v2"]


def _meta_row(name, shape, rank0_only=True, mesh_shape=(2, 2, 2)):
    mesh = make_mesh(mesh_shape, POD, ["meta"] * int(np.prod(mesh_shape)))
    return dryrun.run_cell(name, shape, cfg=t_configs.get(name).scaled(), mesh=mesh,
                           rank0_only=rank0_only)


@pytest.mark.parametrize("kind", list(SHORT))
@pytest.mark.parametrize("name", FAMILY_CONFIGS)
def test_pod_rank0_alone_equals_every_rank(name, kind):
    """Rank 0 alone answers every collective over ('pod', 'data') groups
    with its result's shape: the row equals tracing every rank."""
    alone = _meta_row(name, SHORT[kind], rank0_only=True)
    every = _meta_row(name, SHORT[kind], rank0_only=False)
    assert alone.pop("rank0_only") and not every.pop("rank0_only")
    alone.pop("trace_s"), every.pop("trace_s")
    assert alone == every
    assert alone["ok"] and alone["mesh"] == "2x2x2" and alone["n_devices"] == 8
    assert alone["cost"]["flops"] > 0 and alone["collective_bytes"] > 0


@pytest.mark.parametrize("name,kind", [("llama3-8b", "train"), ("llama3-8b", "prefill"),
                                       ("llama3-8b", "decode"), ("llama3-8b", "decode_b1"),
                                       ("qwen3-moe-30b-a3b", "train"),
                                       ("zamba2-2.7b", "decode_b1")])
def test_pod_meta_collectives_equal_a_real_run(monkeypatch, name, kind):
    shape = SHORT[kind]
    meta = _meta_row(name, shape)
    cfg = t_configs.get(name).scaled()
    model = build_model(cfg)
    mesh = make_mesh((2, 2, 2), POD, ["cpu"] * 8)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    placed = sharded.place_params(mesh, params)
    batch = make_batch(cfg, shape.kind, shape.global_batch, shape.seq_len, seed=0, device="cpu")
    census = _census(monkeypatch)
    # rank 0's block of a batch cut over ('pod', 'data'); a batch of 1 is whole
    block = shape.global_batch // 4 if shape.global_batch % 4 == 0 else shape.global_batch
    if shape.kind == "train":
        state = sharded.place_opt_state(mesh, adamw.init_state(params))
        args = _placed_bytes(placed) + _placed_bytes(state)
        sharded.sharded_train_step(model, mesh, placed, state, batch, adamw.AdamWConfig())
        args += sum(t[:block].numel() * t.element_size() for t in batch.values())
    else:
        cache = sharded.init_cache(model, mesh, shape.global_batch, shape.seq_len)
        args = _placed_bytes(placed) + _placed_bytes(cache)
        if shape.kind == "prefill":
            sharded.sharded_prefill(model, mesh, placed, batch, cache)
            args += sum(t[:block].numel() * t.element_size() for t in batch.values())
        else:
            for path, leaf in T.flatten_with_path(cache)[0]:
                if path[-1] == "pos":
                    for s in leaf.shards:
                        s.fill_(shape.seq_len - 1)
            tokens = batch["tokens"][:, :1]
            sharded.sharded_decode_step(model, mesh, placed, cache, tokens)
            args += tokens[:block].numel() * 4
    want = {k: (n, b) for k, (n, b) in census.items()}
    got = {k: (d["count"], d["operand_bytes"]) for k, d in meta["collectives"].items()}
    assert got == want
    assert meta["memory"]["argument_size_in_bytes"] == args


def _j_pod_step(name, kind):
    cfg = j_configs.get(name).scaled()
    mesh = jax.make_mesh((2, 2, 2), POD)
    return mesh, j_dryrun.build_step(j_build(cfg), cfg, JShape(f"{kind}_short", 16, 4, kind),
                                     mesh)


def _one(spec):
    # a group of one axis is that axis: jax's PartitionSpec writes it so
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


@pytest.mark.distributed
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-moe-30b-a3b", "zamba2-2.7b",
                                  "xlstm-125m", "seamless-m4t-large-v2"])
def test_pod_build_step_specs_equal_the_reference(name, kind):
    _, (_, _, j_in, j_out) = _j_pod_step(name, kind)
    cfg = t_configs.get(name).scaled()
    _, _, t_in, t_out = dryrun.build_step(build_model(cfg), cfg,
                                          ShapeSpec(f"{kind}_short", 16, 4, kind),
                                          make_mesh((2, 2, 2), POD, ["meta"] * 8))
    j_specs = [_one(s) for s in jax.tree.leaves((j_in, j_out),
                                                is_leaf=lambda x: isinstance(x, JP))]
    t_specs = []
    t_shd.map_specs(lambda s: t_specs.append(_one(s)), (t_in, t_out))
    assert t_specs == j_specs
    assert any(("pod", "data") in s for s in t_specs)


def _chunk_state_bytes(name):
    """Rank 0's bytes of a cache's chunked-scan states: ``C`` and the ``n``
    beside it (a Mamba2 layer's or an mLSTM block's), which a prefill does
    not read (its chunked scan starts from zero)."""
    cfg = t_configs.get(name).scaled()
    cache = sharded.init_cache(build_model(cfg), make_mesh((2, 2, 2), POD, ["meta"] * 8), 4, 16)
    pairs = T.flatten_with_path(cache)[0]
    chunked = {tuple(path[:-1]) for path, _ in pairs if path[-1] == "C"}
    return sum(leaf.shards[0].numel() * leaf.shards[0].element_size() for path, leaf in pairs
               if tuple(path[:-1]) in chunked and path[-1] in ("C", "n"))


@pytest.mark.distributed
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-moe-30b-a3b", "zamba2-2.7b",
                                  "xlstm-125m"])
def test_pod_argument_bytes_equal_the_compiled_reference(name, kind):
    """The reference compiles its train, prefill and decode steps on the
    (2, 2, 2) mesh.  Its argument bytes equal the port's row, less a
    prefill's chunked-scan states (zamba2's SSD and the xLSTM's mLSTM
    ``C`` and ``n``), which the prefill does not read: ``jax.jit`` prunes
    an argument that the program does not read, and the port counts
    every shard it is given."""
    mesh, (fn, args, in_sh, out_sh) = _j_pod_step(name, kind)
    to = lambda tree: jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                                   is_leaf=lambda x: isinstance(x, JP))
    with mesh:
        compiled = jax.jit(fn, in_shardings=tuple(to(s) for s in in_sh),
                           out_shardings=to(out_sh)).lower(*args).compile()
    want = compiled.memory_analysis().argument_size_in_bytes
    row = _meta_row(name, ShapeSpec(f"{kind}_short", 16, 4, kind))
    assert row["ok"] and row["mesh"] == "2x2x2" and row["n_devices"] == 8
    pruned = _chunk_state_bytes(name) if kind == "prefill" else 0
    assert row["memory"]["argument_size_in_bytes"] - pruned == want
    assert (pruned > 0) == (kind == "prefill" and name in ("zamba2-2.7b", "xlstm-125m"))


def _cli(args, out):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
                          str(out)], env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    return json.loads(out.read_text()), env


def test_multi_pod_command_line(tmp_path):
    (row,), _ = _cli(["--multi-pod", "--arch", "llama3-8b", "--shape", "train_4k"],
                     tmp_path / "dry.json")
    assert row["ok"] and row["mesh"] == "2x16x16" and row["n_devices"] == 512
    assert row["memory"]["argument_size_in_bytes"] > 0 and row["collective_bytes"] > 0


def test_both_meshes_command_line_and_roofline(tmp_path):
    out = tmp_path / "dry.json"
    rows, env = _cli(["--both-meshes", "--arch", "zamba2-2.7b", "--shape", "long_500k"], out)
    assert [(r["ok"], r["mesh"], r["n_devices"]) for r in rows] == [
        (True, "16x16", 256), (True, "2x16x16", 512)]
    single, multi = rows
    # the batch-1 cache's positions cut 32 ways instead of 16
    assert multi["memory"]["argument_size_in_bytes"] < single["memory"]["argument_size_in_bytes"]
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", str(out)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "| zamba2-2.7b | long_500k | 2x16x16 |" in run.stdout
    roof = json.loads((tmp_path / "dry_roofline.json").read_text())
    assert [r["mesh"] for r in roof] == ["16x16", "2x16x16"]
    worst = run.stdout.split("worst roofline fractions")[1]
    assert "long_500k" in worst and worst.count("zamba2-2.7b") == 1
