"""End to end: train a ~100M-param LM for a few hundred steps (the
port of ``examples/train_lm.py``).

The full training stack: the synthetic corpus, the prefetching loader, the
train step with AdamW, asynchronous checkpoints, and a simulated node failure
mid-run with a restart from the last checkpoint.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import param_count
from repro_torch.train.loop import TrainConfig, TrainResult, train
from repro_torch.train.optimizer import OptConfig

# ~100M params: a granite-family dense GQA decoder
CFG_100M = ModelConfig(
    name="granite-100m", family="dense",
    n_layers=8, d_model=768, n_heads=12, n_kv_heads=4,
    d_ff=2048, vocab=32768,
)


def run(cfg: ModelConfig = CFG_100M, *, steps: int = 300, batch: int = 8,
        seq: int = 256, fail_at: int | None = 150,
        device: str | torch.device | None = None) -> TrainResult:
    """Trains ``cfg`` for ``steps`` steps with checkpoints every 50 and a
    simulated failure at ``fail_at`` (None: none); the loss must fall."""
    print(f"model: {cfg.name}  params={param_count(cfg)/1e6:.1f}M  "
          f"steps={steps}  tokens/step={batch * seq}")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tc = TrainConfig(steps=steps, batch=batch, seq=seq,
                         ckpt_dir=ckpt_dir, ckpt_every=50,
                         simulate_failure_at=fail_at or None)
        oc = OptConfig(lr=6e-4, warmup_steps=30, total_steps=steps)

        def log(step, metrics):
            if step % 20 == 0:
                print(f"  step {step:4d}  loss={float(metrics['loss']):.4f}  "
                      f"lr={float(metrics['lr']):.2e}  "
                      f"gnorm={float(metrics['grad_norm']):.2f}", flush=True)

        r = train(cfg, tc, oc, on_step=log, device=device)

    print(f"\nloss {r.losses[0]:.3f} -> {r.losses[-1]:.3f} over "
          f"{r.steps_done} steps ({r.wall_seconds:.0f}s, "
          f"{r.restarts} failure-restart(s), "
          f"{batch * seq * r.steps_done / r.wall_seconds:,.0f} tok/s)")
    assert r.losses[-1] < r.losses[0], "training must reduce loss"
    return r


def main(argv: list[str] | None = None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--fail-at", type=int, default=150,
                    help="simulate a node failure at this step (0 = off)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(steps=args.steps, batch=args.batch, seq=args.seq,
               fail_at=args.fail_at, device=args.device)


if __name__ == "__main__":
    main()
