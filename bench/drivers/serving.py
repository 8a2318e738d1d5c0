"""What the serving drivers share: the model from the benchmark's weights,
host timing of the program's calls, the served tokens of each request, and
the check of a sample of them against the plain reference."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import time

import numpy as np
import torch

import weights as W
from reference import served


def model_config(config: dict):
    """The program's ModelConfig from a configuration file's ``model``."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**config["model"])


@contextlib.contextmanager
def host_range(name: str):
    """A ``bench.*`` range around a call into the program: the traced
    slice labels the device's idle gaps by it."""
    with torch.autograd.profiler.record_function(name):
        yield


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class Piece:
    """Tokens ``[a, b)`` of one program session, served for one request."""

    sid: int
    a: int
    b: int
    kind: str


class Ledger:
    """Each program session's prompt and engine, and the pieces served."""

    def __init__(self) -> None:
        self.prompt: dict[int, list[int]] = {}
        self.engine: dict[int, object] = {}
        self.pieces: list[Piece] = []

    def opened(self, sid: int, prompt: list[int], engine) -> None:
        self.prompt[sid] = prompt
        self.engine[sid] = engine

    def tokens(self, sid: int) -> list[int]:
        return self.engine[sid].sessions[sid].tokens

    def sample(self, piece: Piece) -> served.Sample:
        p = self.prompt[piece.sid]
        return p + self.tokens(piece.sid)[:piece.b], len(p) + piece.a, \
            len(p) + piece.b

    def context(self, piece: Piece) -> int:
        return len(self.prompt[piece.sid]) + piece.b


def pick_samples(ledger: Ledger, pieces: list[Piece], n: int, seed: int
                 ) -> list[Piece]:
    """``n`` finished pieces drawn from the seed: the one with the longest
    context, one of each kind, then the rest at random."""
    if not pieces:
        return []
    rng = np.random.default_rng([seed, 7])
    chosen = [max(pieces, key=ledger.context)]
    for kind in sorted({p.kind for p in pieces}):
        pool = [p for p in pieces if p.kind == kind and p not in chosen]
        if pool and len(chosen) < n:
            chosen.append(pool[rng.integers(len(pool))])
    rest = [p for p in pieces if p not in chosen]
    for i in rng.permutation(len(rest))[:max(0, n - len(chosen))]:
        chosen.append(rest[int(i)])
    return chosen


def check_served(rec, config: dict, w: dict, samples: list[served.Sample],
                 limit: float) -> None:
    """The widest logit gap of the served tokens against the plain
    reference, beside its limit (``rec.check``)."""
    ref = reference_of(config)
    dims = ref.dims_of(config["model"])
    t0 = time.perf_counter()
    gap, n = served.widest_gap(ref.logits_at, w, dims, samples)
    rec.notes["reference_s"] = time.perf_counter() - t0
    rec.notes["compared_tokens"] = n
    rec.check("served_logit_gap_max", gap, limit, n > 0 and gap <= limit)


def reference_of(config: dict):
    """The plain reference of the configuration's model family:
    ``bench/reference/<family>.py``."""
    return importlib.import_module(f"reference.{config['model']['family']}")


def free_program(device) -> None:
    """Return the program's freed state to the card (the caller has dropped
    its references) before the reference runs, or the next run starts."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def make_model(config: dict, seed: int, device):
    """(ModelConfig, the program's model, the weights by name)."""
    from repro_torch.models import model as M
    cfg = model_config(config)
    free_program(device)
    tree, flat = W.make_weights(cfg, seed, device)
    return cfg, M.build_model(cfg, tree), flat


def percentile(values, q: float) -> float:
    """Linear-interpolation percentile (numpy's default)."""
    return float(np.percentile(np.asarray(values, float), q))
