"""The wave driver (``bench/drivers/wave.py``) for a layered hybrid
(``models/layered.py``: a Mamba2 or attention mixer in each layer, each
followed by the MoE and its shared expert).

Its warm-up also compiles, at every wave's prefill rows and at the decode
rows, the shapes of the projections that the attention's alone do not
cover: the Mamba2 layers' ``in_proj`` and ``out_proj`` and the shared
expert's three (its gate with the activation fused), and the attention's
at the decode rows.  The layered model calls its MoE layer as
``lm.moe_apply``, which the wave driver's hook already runs inside a
``bench.moe`` range."""
from __future__ import annotations

import torch

from bench.drivers import wave


class Driver(wave.Driver):
    def warm(self, api) -> None:
        super().warm(api)
        a = self.arch
        d, h, kv = a["d_model"], a["n_heads"], a["n_kv_heads"]
        hd = int(a.get("head_dim") or d // h)
        ssm, moe = a["ssm"], a["moe"]
        inner = ssm["expand"] * d
        heads = ssm.get("n_ssm_heads") or inner // ssm["head_dim"]
        n_in = 2 * inner + 2 * ssm["d_state"] + heads
        act = a["act"].split("_")[0]
        shapes = [(d, n_in, None), (inner, d, None)]
        if moe.get("d_ff_shared"):
            f = moe["d_ff_shared"]
            shapes += [(d, f, act), (d, f, None), (f, d, None)]
        decode = [(d, h * hd, None), (d, kv * hd, None), (h * hd, d, None)]
        dtype = getattr(torch, a["dtype"])
        widths = sorted(set(self.widths(int(self.mix["warm_waves"]))))
        for m, todo in [(self.slots * w, shapes) for w in widths] + [(self.slots,
                                                                       shapes + decode)]:
            for k, n, fn in todo:
                api.linear(torch.zeros((m, k), dtype=dtype, device=self.device),
                           torch.zeros((k, n), dtype=dtype, device=self.device), act=fn)
