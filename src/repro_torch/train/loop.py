"""The training loop (the port of ``repro.train.loop``): prefetched data,
the train step, asynchronous checkpoints and restart after a failure.

Fault-tolerance contract, as the reference's:
  * checkpoint every ``ckpt_every`` steps, asynchronously (one in flight),
    in the reference's format and stacked layout;
  * ``simulate_failure_at`` drops the in-memory model and optimizer state at
    that step; the loop restores the newest checkpoint (or, before the
    first one, starts again from the seeded init) and continues; the steps
    since that checkpoint run again;
  * the data pipeline is deterministic by step, so a restart replays the
    exact batches.

Initial weights come from ``init_params`` on a ``torch.Generator`` seeded
with ``tc.seed`` (``jax.random`` cannot be reproduced, so the numbers are not
the reference's). The loop runs on ``cuda`` unless ``device`` says
otherwise, and raises without a card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch._bridge import (load_reference, opt_state_from_reference,
                                 opt_state_to_reference, to_reference)
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import PrefetchingLoader, SyntheticCorpus
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 50
    batch: int = 8
    seq: int = 64
    ckpt_every: int = 20
    ckpt_dir: str | None = None
    prefetch_depth: int = 2
    log_every: int = 10
    simulate_failure_at: int | None = None
    seed: int = 0
    microbatches: int = 1       # gradient accumulation (make_train_step's)


@dataclasses.dataclass
class TrainResult:
    losses: list[float]
    steps_done: int
    restarts: int
    wall_seconds: float
    data_waits: int


def extras_fn(cfg: ModelConfig, batch_np: dict, rng: np.random.Generator
              ) -> dict:
    """Attach stub modality inputs (frames/patches) where the family needs."""
    out = dict(batch_np)
    B = batch_np["tokens"].shape[0]
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model), np.float32).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model), np.float32).astype(np.float32)
    return out


def train(cfg: ModelConfig, tc: TrainConfig,
          opt_cfg: OptConfig | None = None,
          on_step: Callable[[int, dict], None] | None = None, *,
          device: str | torch.device | None = None) -> TrainResult:
    opt_cfg = opt_cfg or OptConfig(warmup_steps=10, total_steps=tc.steps)
    cfg.validate()
    dev = resolve_device(device)

    def init_model():
        return M.make_trainable(cfg, M.init_params(cfg, tc.seed, device=dev))

    model = init_model()
    opt_state = init_opt_state(opt_cfg, dict(model.named_parameters()))
    step_fn = make_train_step(cfg, opt_cfg, microbatches=tc.microbatches)

    corpus = SyntheticCorpus(cfg.vocab, seed=tc.seed)
    checkpointer = (ckpt.AsyncCheckpointer(tc.ckpt_dir)
                    if tc.ckpt_dir else None)

    losses: list[float] = []
    restarts = 0
    failed_once = False
    step = 0
    t0 = time.perf_counter()

    def make_loader(start: int) -> PrefetchingLoader:
        it = corpus.batches(tc.batch, tc.seq, start_step=start)
        return PrefetchingLoader(
            (extras_fn(cfg, b, np.random.default_rng((tc.seed, i + start)))
             for i, b in enumerate(it)),
            depth=tc.prefetch_depth, device=dev)

    loader = make_loader(0)
    try:
        while step < tc.steps:
            if (tc.simulate_failure_at is not None and not failed_once
                    and step == tc.simulate_failure_at):
                # ---- simulated node failure: lose in-memory state ---------
                failed_once = True
                del model, opt_state
                if checkpointer:
                    checkpointer.wait()
                restore_step = (ckpt.latest_step(tc.ckpt_dir)
                                if tc.ckpt_dir else None)
                model = init_model()
                if restore_step is None:
                    # failed before the first checkpoint: cold restart —
                    # deterministic init + data pipeline replay from step 0
                    opt_state = init_opt_state(
                        opt_cfg, dict(model.named_parameters()))
                    restore_step = 0
                else:
                    state = ckpt.restore(tc.ckpt_dir, restore_step)
                    load_reference(cfg, model, state["p"])
                    opt_state = opt_state_from_reference(cfg, model,
                                                         state["o"])
                    del state
                step = restore_step
                restarts += 1
                loader.close()
                loader = make_loader(step)
                continue

            batch = next(loader)
            model, opt_state, metrics = step_fn(model, opt_state, batch)
            step += 1
            loss = float(metrics["loss"])
            losses.append(loss)
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {step}")
            if on_step:
                on_step(step, metrics)
            if checkpointer and step % tc.ckpt_every == 0:
                checkpointer.save_async(
                    {"p": to_reference(cfg, model, "cpu"),
                     "o": opt_state_to_reference(cfg, model, opt_state,
                                                 "cpu")}, step)
        if checkpointer:
            checkpointer.wait()
    finally:
        data_waits = loader.waits
        loader.close()

    return TrainResult(losses=losses, steps_done=step, restarts=restarts,
                       wall_seconds=time.perf_counter() - t0,
                       data_waits=data_waits)
