#!/usr/bin/env python3
"""Where a train step of the port's ``Trainer`` spends its time, on one
NVIDIA card.

    python3 scripts/train_profile.py                       # llama3-8b, 8 layers
    python3 scripts/train_profile.py --model xlstm-125m --layers 12 --seq 512 --batch 8

``chip_smoke.py``'s phase 13 (a) / (e) without its checks: random bf16
weights from a seeded generator at full width, ``--layers`` deep, a
``Trainer`` (``oplib`` on ``torch``; AdamW as phase 13 sets it) on
``--batch`` x ``--seq`` tokens a step.  Two steps run untimed, then one
step with CUDA events around its parts (``model.loss``, the backward
pass with the gradients' collection, and ``adamw.apply_updates_``, each
patched to record an event before and after), then two more steps
through ``scripts/model_profile.py``'s ``profile_call`` (one untimed,
one under ``torch.profiler``): the card's busy time and idle share, the
launches, the device time by kernel group (cuBLAS's matrix products,
and the rest) and the 8 kernels that take most of it.  One JSON line, with
the card's name and power limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]


def timed_parts(torch, trainer, batch) -> dict:
    """One ``trainer.train_step`` with CUDA events around the loss and the
    update: ms of the forward, the backward and the update."""
    from repro_torch.optim import adamw

    ev = {k: torch.cuda.Event(enable_timing=True)
          for k in ("start", "loss", "update", "end")}
    real_loss, real_update = trainer.model.loss, adamw.apply_updates_

    def loss(*a, **kw):
        out = real_loss(*a, **kw)
        ev["loss"].record()
        return out

    def update(*a, **kw):
        ev["update"].record()
        out = real_update(*a, **kw)
        ev["end"].record()
        return out

    trainer.model = dataclasses.replace(trainer.model, loss=loss)
    adamw.apply_updates_ = update
    try:
        ev["start"].record()
        trainer.train_step(batch)
        torch.cuda.synchronize()
    finally:
        trainer.model = dataclasses.replace(trainer.model, loss=real_loss)
        adamw.apply_updates_ = real_update
    return {"forward_ms": ev["start"].elapsed_time(ev["loss"]),
            "backward_ms": ev["loss"].elapsed_time(ev["update"]),
            "adamw_ms": ev["update"].elapsed_time(ev["end"])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="llama3-8b", help="a config of the registry")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("train_profile: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from model_profile import profile_call
    from repro_torch import api

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = dataclasses.replace(api.configs.get(args.model), n_layers=args.layers)
    opt = chip_smoke.TRAIN_OPT if cfg.name == chip_smoke.TRAIN_MODEL else chip_smoke.XLSTM_OPT
    trainer = api.Trainer(api.build_model(cfg), api.adamw.AdamWConfig(**opt),
                          api.DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                         global_batch=args.batch),
                          api.TrainConfig(steps=1),
                          gen=torch.Generator(device="cuda").manual_seed(chip_smoke.SEED))
    try:
        def batch():
            return {k: torch.from_numpy(v).cuda() for k, v in trainer.pipeline.next().items()}

        for _ in range(2):
            trainer.train_step(batch())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        parts = timed_parts(torch, trainer, batch())
        b = batch()
        prof = profile_call(torch, lambda: trainer.train_step(b))
    finally:
        trainer.pipeline.close()
    prof.pop("projection_device_ms_by_group")
    print(json.dumps({
        "model": cfg.name, "layers": cfg.n_layers, "tokens_per_step": args.seq * args.batch,
        **parts, **prof,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}),
        flush=True)


if __name__ == "__main__":
    main()
