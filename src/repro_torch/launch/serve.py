"""Serving launcher: batched generation with location-aware routing.

``python -m repro_torch.launch.serve --arch granite-3-2b --engines 2 --requests 12``

The counterpart of ``python -m repro.launch.serve``: engines sharing one
model behind the Router, sessions pinned in the location service, follow-up
requests routed to the engine holding the KV cache. Runs on ``--device cuda``
by default (and fails without a card); ``--device cpu`` runs the plain
versions. ``--full`` serves the published configuration instead of
``smoke()``, with random weights from seed 0; ``--layers N`` cuts its depth
and keeps its width (deepseek-v3 and llama-3.2-vision do not fit one card
whole; zamba2-7b and rwkv6-1.6b do, at full depth). Every family of
``--arch`` is served; the encdec and vlm families get seeded frames or
patches with every prompt (their frontends are stubbed, as in the
reference).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.core.locstore import LocStore
from repro_torch.models import init_params
from repro_torch.serve.engine import Router, ServingEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="granite-3-2b")
    ap.add_argument("--engines", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the published config (random weights, seed 0)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: keep it)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    # whisper's text context is 448 tokens
    max_seq = (448 if cfg.family == "encdec" else 2048) if args.full else 96
    extra = {"encdec": ("frames", cfg.n_frames),
             "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    params = init_params(cfg, 0, device=args.device)
    store = LocStore(args.engines)
    engines = [ServingEngine(cfg, params, max_batch=args.max_batch,
                             max_seq=max_seq, node=i, store=store,
                             device=args.device)
               for i in range(args.engines)]
    router = Router(engines, store)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    sessions = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=8).tolist()
        extras = None if extra is None else {extra[0]: rng.normal(
            size=(1, extra[1], cfg.d_model)).astype(np.float32)}
        eng = router.engine_for()
        sid = eng.submit(prompt, extras)
        sessions.append((eng, sid))
        print(f"req {i}: engine {eng.node} slot session {sid}")
    # decode everything to completion, round-robin across engines
    for _ in range(args.max_new):
        for eng in engines:
            eng.step()
    for eng, sid in sessions:
        toks = eng.finish(sid)
        print(f"engine {eng.node} session {sid}: {toks[:args.max_new]}")
    dt = time.perf_counter() - t0
    total_tokens = sum(len(e.finish(s)) for e, s in sessions)
    print(f"\n{args.requests} requests, {total_tokens} tokens, "
          f"{dt:.2f}s ({total_tokens / dt:.1f} tok/s)")
    print("router locality:", router.locality_hits, "hits /",
          router.locality_misses, "misses")


if __name__ == "__main__":
    main()
