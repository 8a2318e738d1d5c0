"""The comparison that decides ``correct`` for a served model: every served
token of a sample of finished requests against the plain reference.

A sample is ``(tokens, a, b)``: the sequence the program consumed and
produced, of which ``tokens[a:b]`` were served (greedy); the reference
runs once over ``tokens[:b - 1]`` and reads, at each served position, how
far the served token's logit lies below its best logit. The widest such
gap over the sample is the number compared. The control puts the reference
computed in float8 in the program's place: at the same positions, the
token it ranks first, read under the f32 reference.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

Sample = tuple[list[int], int, int]
Logits = Callable[..., torch.Tensor]


def _positions(sample: Sample) -> tuple[list[int], list[int], list[int]]:
    tokens, a, b = sample
    if not 0 < a < b <= len(tokens):
        raise ValueError(f"bad served range [{a}, {b}) of {len(tokens)}")
    return tokens[:b - 1], list(range(a - 1, b - 1)), tokens[a:b]


def widest_gap(logits_at: Logits, w: dict, dims: dict,
               samples: Sequence[Sample]) -> tuple[float, int]:
    """(widest gap, served tokens compared) of the program's tokens."""
    worst, n = 0.0, 0
    for s in samples:
        seq, at, served = _positions(s)
        lg = logits_at(w, dims, seq, at)
        idx = torch.tensor(served, device=lg.device)[:, None]
        gap = lg.max(-1).values - lg.gather(-1, idx)[:, 0]
        worst = max(worst, float(gap.max()))
        n += len(served)
        del lg
    return worst, n


def control_gap(logits_at: Logits, w: dict, dims: dict,
                samples: Sequence[Sample], quant: str = "fp8"
                ) -> tuple[float, int]:
    """(widest gap, tokens compared) of the tokens the reference computed
    in ``quant`` ranks first, at the served positions of ``samples``."""
    worst, n = 0.0, 0
    for s in samples:
        seq, at, _ = _positions(s)
        low = logits_at(w, dims, seq, at, quant=quant).argmax(-1)
        lg = logits_at(w, dims, seq, at)
        gap = lg.max(-1).values - lg.gather(-1, low[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        n += len(at)
        del lg
    return worst, n
