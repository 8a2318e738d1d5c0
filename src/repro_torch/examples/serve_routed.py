"""Location-aware multi-engine serving (the port of
``examples/serve_routed.py``).

Two engines ("nodes") serve sessions; a conversation's follow-up requests
are routed by the location service to the engine already holding the
session's KV cache, so no follow-up pays a re-prefill.

    PYTHONPATH=src python -m repro_torch.examples.serve_routed [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke
from repro_torch.core.locstore import LocStore
from repro_torch.models import init_params
from repro_torch.serve.engine import Router, ServingEngine

SESSIONS, TURNS = 4, 3


def config():
    """The reference example's model: granite-3-2b's smoke config in f32."""
    return dataclasses.replace(get_smoke("granite-3-2b"), dtype="float32")


def run(device: str | torch.device | None = None, model=None) -> dict:
    """Opens SESSIONS conversations on two engines and serves TURNS
    follow-up turns each; ``model`` defaults to seeded weights (a test
    passes the reference's, bridged). Returns the router's hits and misses,
    the prefills and every session's tokens."""
    dev = resolve_device(device)
    cfg = config()
    model = init_params(cfg, 0, device=dev) if model is None else model
    store = LocStore(2)
    engines = [ServingEngine(cfg, model, max_batch=4, max_seq=96, node=i,
                             store=store, device=dev) for i in range(2)]
    router = Router(engines, store)
    rng = np.random.default_rng(0)

    sids = []
    for _ in range(SESSIONS):
        eng = router.engine_for()
        sid = eng.submit(rng.integers(0, cfg.vocab, 8).tolist())
        sids.append(sid)
        print(f"session {sid} opened on engine {eng.node} "
              f"(cache pinned via location service)")

    for turn in range(TURNS):
        for sid in sids:
            eng = router.engine_for(sid)
            eng.step()
            tokens = eng.sessions[sid].tokens
            print(f"  turn {turn}: session {sid} -> engine {eng.node} "
                  f"(hit) last_token={tokens[-1]}")

    prefills = sum(e.prefills for e in engines)
    print(f"\nlocation-service routing: {router.locality_hits} hits, "
          f"{router.locality_misses} misses")
    print(f"prefills run: {prefills} (= {SESSIONS} initial; every follow-up "
          f"was served from the resident cache)")
    tokens = {sid: next(e.sessions[sid].tokens for e in engines
                        if sid in e.sessions) for sid in sids}
    return {"hits": router.locality_hits, "misses": router.locality_misses,
            "prefills": prefills, "tokens": tokens}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    assert res["misses"] == 0 and res["prefills"] == SESSIONS, \
        "every follow-up must be a routing hit served without a prefill"
    return res


if __name__ == "__main__":
    main()
