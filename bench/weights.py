"""The weights, made by the benchmark from the seed, on the device.

The program's ``Model.init`` on the ``meta`` device gives the layout
(each leaf's shape and type, the layers stacked on a leading axis); the
benchmark fills every leaf itself with one call a leaf, from a generator
on the device: N(0, 0.02^2) for the embedding and the LM head, N(0,
1/fan_in) for a matrix (fan_in its second-to-last axis), ones for a norm's
scale, zeros for a bias.  The program and the reference read the same
tensors; the reference knows them by their place in the tree, as it
would read a checkpoint.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

ONES = ("scale", "q_norm", "k_norm")
TABLES = ("embed", "unembed")


def _fill(path: str, meta: torch.Tensor, gen: torch.Generator, device) -> torch.Tensor:
    leaf = path.rsplit("/", 1)[-1]
    out = torch.empty(meta.shape, dtype=meta.dtype, device=device)
    if leaf in ONES:
        return out.fill_(1.0)
    if leaf == "bias":
        return out.zero_()
    std = 0.02 if leaf in TABLES else float(meta.shape[-2]) ** -0.5
    return out.normal_(0.0, std, generator=gen)


def make(model, seed: int, device) -> Dict[str, Any]:
    layout = model.init(torch.Generator(), device="meta")
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        return _fill(path, tree, gen, device)

    return walk(layout, "")
