"""Random weights from the seed, made by the benchmark and handed to both
the program and the plain reference.

The leaves' names and shapes are the program's layout (read from the
program's model built on the meta device: shapes only, no values); each
leaf's distribution is its family's ``leaf_init``
(``bench/families/<family>.py``). The values are drawn here, on the card,
from a ``torch.Generator`` seeded with the run's seed, in one ``randn``
call per dtype into one flat buffer; each leaf is a view of it, and leaves
of one (scale, shift) are scaled and shifted together.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import torch

import harness


def _nest(flat: dict[str, torch.Tensor]) -> dict:
    """Dotted names as the program's tree: dicts, with a layer index
    (``blocks.3``) as a list position."""
    root: dict = {}
    for name, t in flat.items():
        node: dict = root
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def make_weights(cfg, seed: int, device: str,
                 families: Path = harness.BENCH / "families"
                 ) -> tuple[dict, dict]:
    """(tree, flat): the weights in the program's tree layout and by dotted
    name, all views of one buffer per dtype drawn from ``seed`` on
    ``device``. Every leaf's rule is looked up before any value is drawn."""
    from repro_torch.models import model as M
    model = dataclasses.asdict(cfg)
    rules = harness.family_rules(model, families)
    meta = M.init_params(cfg, device="meta")
    leaves = [(n, tuple(p.shape), p.dtype) for n, p in meta.named_parameters()]
    del meta
    init = {n: rules.leaf_init(n, s, model) for n, s, _ in leaves}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat: dict[str, torch.Tensor] = {}
    for dtype in sorted({d for _, _, d in leaves}, key=str):
        group = [(n, s, init[n]) for n, s, d in leaves if d == dtype]
        group.sort(key=lambda x: x[2])              # leaves of one rule
        total = sum(math.prod(s) for _, s, _ in group)
        buf = torch.randn(total, generator=gen, dtype=dtype, device=device)
        off, runs = 0, []
        for n, s, rule in group:
            k = math.prod(s)
            flat[n] = buf[off:off + k].view(s)
            if runs and runs[-1][2] == rule:
                runs[-1][1] = off + k
            else:
                runs.append([off, off + k, rule])
            off += k
        for a, b, (scale, shift) in runs:
            if scale == 0.0:
                buf[a:b].fill_(shift)
                continue
            buf[a:b].mul_(scale)
            if shift != 0.0:
                buf[a:b].add_(shift)
    return _nest(flat), flat
