"""End-to-end training on the PyTorch/CUDA port: data pipeline -> model
-> AdamW -> fault-tolerant loop with checkpointing.  The twin of
``train_tiny_lm.py``.

Training runs on oplib's ``torch`` backend: the hand-written kernels have
no backward (ROADMAP C11).  The default preset trains a reduced
llama-family model for 200 steps on the card; ``--arch xlstm-125m
--full`` trains the real 125M-parameter xLSTM config.

    PYTHONPATH=src python examples/torch_train_tiny_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_tiny_lm.py --steps 20 --device cpu
"""
import argparse
import tempfile

import torch

from repro_torch import api


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true", help="use the full config")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: a fresh temporary one)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()

    cfg = api.configs.get(args.arch)
    if not args.full:
        cfg = cfg.scaled(n_layers=4, d_model=128, d_ff=256 if cfg.d_ff else 0,
                         vocab=512, vocab_pad_multiple=64)
    api.set_backend("torch")
    model = api.build_model(cfg)
    data = api.DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    opt = api.adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    with tempfile.TemporaryDirectory() as tmp:
        tc = api.TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir or tmp, ckpt_every=50,
                             log_every=10)
        trainer = api.Trainer(model, opt, data, tc,
                              gen=torch.Generator(device=args.device).manual_seed(0),
                              device=args.device)
        print(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) for {args.steps} "
              f"steps on {args.device}")
        out = trainer.run()
    for h in out["history"]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  {h['dt']*1e3:.0f} ms")
    print("final loss:", out["final_loss"], "| stragglers flagged:", len(out["stragglers"]))


if __name__ == "__main__":
    main()
