"""The control of a served cell's check, beside the program's own reading.

    python3 bench/tools/control.py --workload granite-3-2b.chat --seconds 20 --seeds 11 12 13

Runs the cell's driver in this process once per seed (a short window at
the cell's own load and sizes), and on the very samples its check compares
reads both the program's widest logit gap and the control's: the plain
reference computed in float8 put in the program's place (at each served
position, the token it ranks first, read under the f32 reference). Prints
one JSON line per seed and a summary: the program's largest reading (the
lower end of the limit) and the control's smallest (the upper end).
"""

from __future__ import annotations

import argparse
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
from drivers import serving  # noqa: E402
from reference import served  # noqa: E402


def with_control(quant: str = "fp8"):
    """Wrap the serving drivers' check so that it also reads the control
    on the same samples (``rec.notes["control_gap"]``)."""
    plain = serving.check_served

    def check(rec, config, w, samples, limit):
        plain(rec, config, w, samples, limit)
        ref = serving.reference_of(config)
        gap, n = served.control_gap(ref.logits_at, w,
                                    ref.dims_of(config["model"]), samples,
                                    quant)
        rec.notes["control_gap"] = gap
        rec.notes["control_tokens"] = n
    return plain, check


def control_runs(cell: harness.Cell, seeds, seconds: float, device: str
                 ) -> list[dict]:
    plain, check = with_control()
    serving.check_served = check
    out = []
    try:
        for seed in seeds:
            rec, metrics, _ = run.run_cell(cell, seed, seconds, False, device,
                                           time.time())
            row = {"seed": seed, "program_gap": rec.checks[-1][1],
                   "control_gap": rec.notes["control_gap"],
                   "tokens": rec.notes["compared_tokens"],
                   "kinds": rec.notes.get("sample_kinds"),
                   "metrics": {k: v["value"] for k, v in metrics.items()}}
            print(json.dumps(row), flush=True)
            out.append(row)
    finally:
        serving.check_served = plain
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    rows = control_runs(harness.load_cell(args.workload), args.seeds,
                        args.seconds, "cuda")
    print(json.dumps({"program_gap_max": max(r["program_gap"] for r in rows),
                      "control_gap_min": min(r["control_gap"] for r in rows),
                      "seeds": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
