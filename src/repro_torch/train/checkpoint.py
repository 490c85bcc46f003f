"""Fault-tolerant checkpointing, the twin of the JAX package's
``train/checkpoint.py``, in its file format, so that each package reads
the other's checkpoints:

* ``<dir>/step_<step:010d>/<name>.npz`` holds a tree's leaves as ``a{i}``
  in ``jax.tree``'s leaf order (``repro_torch.tree``), and
  ``manifest.json`` the step and each tree's ``/``-joined key paths
  (``trees.<name>.keys``; its ``treedef`` string is this package's own,
  which the reference never reads);
* a bfloat16 leaf is stored as the reference stores it, a 2-byte void
  array (``V2``) of its bits: numpy has no bfloat16;
* **atomic**: written to ``<dir>/tmp.<step>`` then renamed, so a crash
  mid-save never corrupts the latest checkpoint;
* **mesh-elastic**: a placed tree (``parallel.sharding.place``) is saved
  unsharded, and ``restore(shardings=)`` places each named tree onto
  whatever mesh the new job uses;
* **retention**: keeps the newest ``keep`` checkpoints.

``restore`` reads a ``V2`` leaf back as bfloat16 bits where ``like`` is
bfloat16; the reference's ``astype`` raises there (ROADMAP C12).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tree as T
from ..parallel import sharding as shd
from ..parallel.spmd import Placed

_BF16_BITS = np.dtype("V2")


def _to_numpy(leaf: Any) -> np.ndarray:
    """A leaf as the reference's ``np.asarray`` gives it (bfloat16 as the
    ``V2`` array of its bits; a placed leaf whole); CPU tensors are
    copied, since the trainer updates its tensors in place."""
    if isinstance(leaf, Placed):
        leaf = shd.assemble(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_BITS)
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> List[Tuple[str, np.ndarray]]:
    pairs, _ = T.flatten_with_path(tree)
    return [(T.key_path(path), _to_numpy(leaf)) for path, leaf in pairs]


def save(ckpt_dir: str, step: int, state: Dict[str, Any], keep: int = 3) -> str:
    """Atomic checkpoint save.  ``state`` is a dict of trees / scalars."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest: Dict[str, Any] = {"step": step, "trees": {}}
    for name, tree in state.items():
        if tree is None:
            continue
        pairs = _flatten(tree)
        arrays = {f"a{i}": arr for i, (key, arr) in enumerate(pairs)}
        np.savez(os.path.join(tmp, f"{name}.npz"), **arrays)
        manifest["trees"][name] = {
            "keys": [k for k, _ in pairs],
            "treedef": repr(T.flatten(tree)[1]),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    if not steps:
        return None
    return int(steps[-1].split("_")[1])


def _torch_dtype(like: Any) -> Optional[torch.dtype]:
    dt = getattr(like, "dtype", None)
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.zeros((), dt)).dtype


def _leaf(saved: np.ndarray, want: Optional[torch.dtype], device) -> torch.Tensor:
    if saved.dtype == _BF16_BITS:
        t = torch.from_numpy(saved.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(saved, copy=True))
    if want is not None and t.dtype != want:
        t = t.to(want)
    return t.to(device)


def restore(ckpt_dir: str, like: Dict[str, Any], step: Optional[int] = None,
            shardings: Optional[Dict[str, Any]] = None, device="cuda"
            ) -> Tuple[int, Dict[str, Any]]:
    """Restore into the structure of ``like`` (trees of tensors, numpy
    arrays, meta tensors or placed values: only each leaf's dtype is read)
    as tensors on ``device``: the card unless the caller passes
    ``"cpu"``; without a card that raises.  ``shardings`` maps tree names
    to trees of ``parallel.sharding.Sharding`` (``make_sharding``): those
    trees are placed with them instead, one shard a rank on the rank's
    device (``sharding.place``), which is what makes restore
    mesh-elastic."""
    shardings = shardings or {}
    device = torch.device(device)
    placed_only = all(shardings.get(name) is not None for name in like)
    if device.type == "cuda" and not torch.cuda.is_available() and not placed_only:
        raise RuntimeError("restore: device 'cuda' but torch.cuda.is_available() is False; "
                           "pass device='cpu' to restore onto the CPU")
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    out: Dict[str, Any] = {}
    for name, tree in like.items():
        if tree is None or name not in manifest["trees"]:
            out[name] = tree
            continue
        with np.load(os.path.join(path, f"{name}.npz")) as data:
            leaves = [data[f"a{i}"] for i in range(len(data.files))]
        like_leaves, treedef = T.flatten(tree)
        if len(leaves) != len(like_leaves):
            raise ValueError(f"{name}: checkpoint has {len(leaves)} leaves, expected "
                             f"{len(like_leaves)}")
        sharded = shardings.get(name) is not None
        restored = T.unflatten(treedef, [_leaf(saved, _torch_dtype(want),
                                               "cpu" if sharded else device)
                                         for saved, want in zip(leaves, like_leaves)])
        out[name] = shd.place(restored, shardings[name]) if sharded else restored
    return step, out


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight).  The
    tensors are copied to the host before ``save`` returns."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, state: Dict[str, Any]) -> None:
        self.wait()
        host_state = {k: (None if v is None else T.tree_map(_to_numpy, v))
                      for k, v in state.items()}
        self._thread = threading.Thread(
            target=save, args=(self.ckpt_dir, step, host_state, self.keep), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
