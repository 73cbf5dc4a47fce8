"""End-to-end LM training driver of the PyTorch port, the twin of
``examples/train_lm.py``: trains a ~100M-param variant of a reduced
architecture on synthetic tokens and reports the loss curve, through the
same model / optimizer / data / checkpoint stack as
``repro_torch.launch.train lm``.

Default arch is musicgen-large (vocab 2048) so the LM head does not
dominate; pass --steps 300 for a full curve.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 40
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 4

It runs on the card unless given ``--device cpu``.
"""
import argparse
import dataclasses
import json
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_reduced
from repro_torch.data import synthetic_token_batches
from repro_torch.launch.serve import resolve_device, set_fp32_numerics
from repro_torch.models.transformer import (init_model, param_count,
                                            train_step_fn)
from repro_torch.optim import adamw


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="musicgen-large")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)      # raises for cuda without CUDA
    set_fp32_numerics()

    # ~100M-class variant: reduced family config widened to 10 layers/1024d
    cfg = dataclasses.replace(get_reduced(args.arch), num_layers=10,
                              d_model=1024, n_heads=16, n_kv_heads=8,
                              d_ff=2816, dtype="float32")
    n = param_count(cfg)
    print(f"training {cfg.name} variant: {n/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq_len}")

    params = init_model(cfg, torch.Generator().manual_seed(0), device)
    opt = adamw(args.lr)
    opt_state = opt.init(params)
    step = train_step_fn(cfg, opt)
    gen = synthetic_token_batches(cfg.vocab_size, args.seq_len, args.batch,
                                  seed=0)
    losses = []
    t0 = time.perf_counter()
    for i, hb in zip(range(args.steps), gen):
        batch = {k: torch.from_numpy(hb[k]).to(device)
                 for k in ("tokens", "labels")}
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if (i + 1) % 25 == 0:
            print(f"  step {i+1:4d}  loss {losses[-1]:.4f}")
    wall = time.perf_counter() - t0
    out = {"arch": cfg.name, "params_m": round(n / 1e6, 1),
           "loss_first": losses[0], "loss_last": losses[-1],
           "loss_decreased": losses[-1] < losses[0],
           "tokens_per_s": round(args.steps * args.batch * args.seq_len
                                 / wall, 1)}
    print(json.dumps(out, indent=1))
    if args.ckpt_dir:
        # the payload of repro_torch.launch.train lm, so `train lm --resume`
        # can continue from this checkpoint
        save_checkpoint(args.ckpt_dir, args.steps,
                        {"params": params, "opt_state": opt_state})
        print("checkpoint saved to", args.ckpt_dir)
    return out


if __name__ == "__main__":
    main()
