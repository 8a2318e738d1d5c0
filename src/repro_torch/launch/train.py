"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Trains the smoke-scale variant of the chosen arch end to end (data
pipeline, prefetch, checkpoints, optional simulated failure); ``--full``
takes the published config and trains it on the one card, ``--layers``
cuts its depth. Runs on ``cuda`` unless ``--device cpu``. Every family
trains (encdec and vlm on seeded frames / patches).
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.train.loop import TrainConfig, TrainResult, train
from repro_torch.train.optimizer import OptConfig


def main(argv: list[str] | None = None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a node failure at this step")
    ap.add_argument("--full", action="store_true",
                    help="the full published config, on the one card")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    tc = TrainConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     simulate_failure_at=args.fail_at)
    oc = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                   total_steps=args.steps)

    def log(step, metrics):
        if step % 10 == 0 or step == 1:
            extra = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items()
                             if k != "loss")
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} {extra}",
                  flush=True)

    r = train(cfg, tc, oc, on_step=log, device=args.device)
    print(f"\ndone: {r.steps_done} steps, {r.restarts} restarts, "
          f"{r.wall_seconds:.1f}s, loss {r.losses[0]:.3f} -> {r.losses[-1]:.3f}")
    return r


if __name__ == "__main__":
    main()
