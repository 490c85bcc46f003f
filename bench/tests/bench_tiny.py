"""Tiny sizes of each cell for the CPU tests: the configuration's own
layout and engine, a handful of layers, rows and requests."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from bench import spec  # noqa: E402

# the tiny runs measure windows of a second or two: a few threads each, so
# that test processes side by side do not starve one another's windows
torch.set_num_threads(min(torch.get_num_threads(), 2))

CELLS = ("chatglm3-6b.chat", "qwen3-moe-30b-a3b.docs", "chatglm3-6b.rag")


def overrides(cell_name: str, d_model: int = 128):
    c = spec.resolve(cell_name)
    arch = dict(c.config, n_layers=2, d_model=d_model, n_heads=4, n_kv_heads=2,
                head_dim=d_model // 4, d_ff=2 * d_model, vocab=256, vocab_pad_multiple=32)
    if arch.get("moe"):
        # at these widths bf16's router near-ties flip a token's experts (2
        # of 8) and with them its output: the tiny MoE runs in float32
        arch["moe"] = dict(arch["moe"], n_experts=8, top_k=2, d_ff_expert=d_model // 2)
        arch["dtype"] = "float32"
    mix = dict(c.traffic)
    if mix["engine"] == "continuous":
        mix.update(clients=4, slots=4, max_len=64, block=4,
                   prompt_tokens=dict(min=4, max=24, median=10, sigma=0.5),
                   output_tokens=dict(min=2, max=12, median=6, sigma=0.5), check_tokens=150)
    else:
        mix.update(clients=4, slots=2, max_len=40, block=4, warm_waves=4,
                   prompt_tokens=dict(min=8, max=24, median=16, sigma=0.3),
                   output_tokens=dict(min=1, max=8, median=4, sigma=0.4), check_tokens=40)
    return {"config": arch, "traffic": mix}
