"""Model FLOPs of the work a window did, from the configuration's sizes."""

from __future__ import annotations

from work import roofline


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
