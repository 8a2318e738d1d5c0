"""The chat cell's knee: its time to first token and backlog at a sweep of
arrival rates, found once on the card when the cell is defined.

    python3 bench/tools/knee.py --workload granite-3-2b.chat --seconds 40 --seed 5 --rates 2 3 4 5

Runs the cell's driver in this process at each rate (the mix's
``trace.req_rate`` replaced, everything else as committed) and prints one
JSON line a rate: the turns that arrived in the window, their p50 and p90
time to first token, and the turns waiting every 5 s (a backlog that grows
through the window means the rate is past the knee).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402
import run  # noqa: E402


def sweep(cell: harness.Cell, rates, seconds: float, seed: int,
          device: str) -> list[dict]:
    out = []
    for rate in rates:
        c = copy.deepcopy(cell)
        c.mix["trace"]["req_rate"] = float(rate)
        rec, metrics, _ = run.run_cell(c, seed, seconds, False, device,
                                       time.time())
        row = {"rate": rate, "turns": rec.attempted, "failed": rec.failed,
               "ttft_p90_s": metrics.get("ttft_p90_s", {}).get("value"),
               "ttft_p50_s": rec.notes.get("ttft_p50_s"),
               "backlog_every_5s": rec.notes.get("backlog_every_5s"),
               "decode_step_ms": 1e3 * sum(rec.spans["decode_step"])
               / max(1, len(rec.spans["decode_step"])),
               "counters": rec.counters,
               "memory_peak_bytes": rec.memory_peak_bytes,
               "correct": rec.correct}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    sweep(harness.load_cell(args.workload), args.rates, args.seconds,
          args.seed, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
