"""Random weights from the seed, made by the benchmark and handed to both
the program and the plain reference.

The leaves' names and shapes are the program's layout (read from the
program's model built on the meta device: shapes only, no values). The
values are drawn here, on the card, from a ``torch.Generator`` seeded with
the run's seed, in one ``randn`` call per dtype into one flat buffer; each
leaf is a view of it, and leaves of one scale are scaled together.
"""

from __future__ import annotations

import math
import re

import torch


def _scale(name: str, shape: tuple, n_layers: int) -> float:
    """The init scale of one leaf of a dense decoder (0: zeros). Norm gains
    enter as ``1 + gain`` and start at 0; the embedding takes N(0, 0.02);
    a projection (d_in, d_out) takes 1/sqrt(d_in), the residual's output
    projections (``wo``, ``w2``) also 1/sqrt(2 L)."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 1:
        return 0.0
    if name == "embed.tok":
        return 0.02
    if len(shape) == 2 and re.fullmatch(r"w[qkvo123]|head", leaf):
        s = 1.0 / math.sqrt(shape[0])
        return s / math.sqrt(2.0 * n_layers) if leaf in ("wo", "w2") else s
    raise ValueError(f"no init rule for leaf {name} {shape}")


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


def make_weights(cfg, seed: int, device: str) -> tuple[dict, dict]:
    """(tree, flat): the weights in the program's tree layout and by dotted
    name, all views of one buffer per dtype drawn from ``seed`` on
    ``device``."""
    from repro_torch.models import model as M
    meta = M.init_params(cfg, device="meta")
    leaves = [(n, tuple(p.shape), p.dtype) for n, p in meta.named_parameters()]
    del meta
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat: dict[str, torch.Tensor] = {}
    for dtype in sorted({d for _, _, d in leaves}, key=str):
        group = [(n, s, _scale(n, s, cfg.n_layers))
                 for n, s, d in leaves if d == dtype]
        group.sort(key=lambda x: x[2])              # leaves of one scale
        total = sum(math.prod(s) for _, s, _ in group)
        buf = torch.randn(total, generator=gen, dtype=dtype, device=device)
        off, runs = 0, []
        for n, s, sc in group:
            k = math.prod(s)
            flat[n] = buf[off:off + k].view(s)
            if runs and runs[-1][2] == sc:
                runs[-1][1] = off + k
            else:
                runs.append([off, off + k, sc])
            off += k
        for a, b, sc in runs:
            if sc == 0.0:
                buf[a:b].zero_()
            else:
                buf[a:b].mul_(sc)
    return _nest(flat), flat
