"""The dense GQA decoder (``family: dense``): its weights' init, its model
FLOPs and its attention calls, as ``harness.family_rules`` finds them."""

from __future__ import annotations

import math
import re

from work import roofline


def leaf_init(name: str, shape: tuple, model: dict) -> tuple[float, float]:
    """(scale, shift) of one leaf of a dense decoder: N(0, scale^2), zeros
    where scale is 0. Norm gains enter as ``1 + gain`` and start at 0; the
    embedding takes N(0, 0.02); a projection (d_in, d_out) takes
    1/sqrt(d_in), the residual's output projections (``wo``, ``w2``) also
    1/sqrt(2 L)."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 1:
        return 0.0, 0.0
    if name == "embed.tok":
        return 0.02, 0.0
    if len(shape) == 2 and re.fullmatch(r"w[qkvo123]|head", leaf):
        s = 1.0 / math.sqrt(shape[0])
        if leaf in ("wo", "w2"):
            s /= math.sqrt(2.0 * model["n_layers"])
        return s, 0.0
    raise ValueError(f"no init rule for leaf {name} {shape}")


def dims(model: dict) -> tuple[int, int, int, int, int, int, int]:
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    return (model["n_layers"], model["d_model"], model["n_heads"],
            model["n_kv_heads"], hd, model["d_ff"], model["vocab"])


def layer_params(model: dict) -> int:
    """Matmul weights of the decoder layers (a dense GQA decoder)."""
    L, d, Hq, Hkv, hd, ff, _ = dims(model)
    return L * (2 * d * Hq * hd + 2 * d * Hkv * hd + 3 * d * ff)


def serve_flops(model: dict, prefill_lengths, decode_tokens: int,
                decode_ctx: int) -> float:
    """2 FLOPs a weight a token through the layers, the head once a
    prefill (its last position) and once a decoded token, plus attention:
    K1's causal pairs at prefill, 4 Hq hd a cached row at decode."""
    L, d, Hq, Hkv, hd, _, V = dims(model)
    P = layer_params(model)
    total = 0.0
    for S in prefill_lengths:
        ops, _ = roofline.flash_work((1, S, S, Hq, Hkv, hd, True, 0, 0), 2)
        total += 2.0 * P * S + 2.0 * d * V + L * ops
    total += decode_tokens * 2.0 * (P + d * V)
    total += L * 4.0 * Hq * hd * decode_ctx
    return total


def attention_calls(model: dict) -> list[tuple[int, int, int, int, int]]:
    """One call a layer, full causal attention at the head's width."""
    L, _, Hq, Hkv, hd, _, _ = dims(model)
    return [(Hq, Hkv, hd, hd, 0)] * L
