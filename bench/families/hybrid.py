"""The published Zamba2 block (``family: hybrid`` with ``hybrid_layer_ids``):
its weights' init, its model FLOPs and its attention calls, as
``harness.family_rules`` finds them.

The model: L Mamba2 layers (``layers.<i>``); before each layer listed in
``hybrid_layer_ids`` one of ``num_mem_blocks`` shared blocks
(``blocks.<b>``: attention over ``concat[h, e]``, a gated MLP), with the
application's own adapter and linear (``apps.<k>``).
"""

from __future__ import annotations

import math
import re

from work import roofline

SSD_CHUNK = 128     # the program's SSD chunk (repro_torch.models.ssm.CHUNK)

# (d_in, d_out) projections drawn N(0, 1 / d_in); ``out_proj`` writes the
# residual and also takes 1 / sqrt(2 L), as the dense family's ``wo``
_PROJ = re.compile(r"(layers\.\d+\.mamba\.(in_proj|out_proj)"
                   r"|blocks\.\d+\.(attn\.w[qkvo]|mlp\.fc[12])"
                   r"|apps\.\d+\.(linear|adapter_in|adapter_out))")


def _log_arange(n: int) -> tuple[float, float]:
    """(standard deviation, mean) of log(1 .. n): the published ``A_log``
    init, ``log(arange(1, H + 1))``, as a normal of its moments."""
    v = [math.log(i) for i in range(1, n + 1)]
    mu = sum(v) / n
    return math.sqrt(sum((x - mu) ** 2 for x in v) / n), mu


def leaf_init(name: str, shape: tuple, model: dict) -> tuple[float, float]:
    """(scale, shift) of one leaf: N(shift, scale^2), the constant
    ``shift`` where scale is 0.

    Norm gains enter as ``1 + gain`` and start at 0 (the published ones);
    ``D`` is 1; ``A_log`` the moments of the published log(1 .. H);
    ``dt_bias`` the published inverse softplus of a dt log-uniform on
    [0.001, 0.1], as a normal of its moments (mean ln sqrt(0.001 x 0.1),
    sd ln(100) / sqrt(12)); the conv's taps and bias PyTorch's ``Conv1d``
    default U(+-1/sqrt(K)) as a normal of its variance 1 / (3K); the
    embedding N(0, 0.02^2) (``initializer_range``); a projection (d_in,
    d_out) N(0, 1/d_in), ``out_proj`` also over sqrt(2 L)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "A_log":
        return _log_arange(shape[0])
    if leaf == "dt_bias":
        return math.log(100.0) / math.sqrt(12.0), \
            0.5 * math.log(0.001 * 0.1)
    if leaf == "D":
        return 0.0, 1.0
    if leaf in ("conv_w", "conv_b"):
        K = model.get("ssm_conv", 4)
        return 1.0 / math.sqrt(3.0 * K), 0.0
    if len(shape) == 1 and (leaf in ("norm", "ln", "ln2")
                            or name == "final_norm"):
        return 0.0, 0.0
    if name == "embed.tok":
        return 0.02, 0.0
    if len(shape) == 2 and _PROJ.fullmatch(name):
        s = 1.0 / math.sqrt(shape[0])
        if leaf == "out_proj":
            s /= math.sqrt(2.0 * model["n_layers"])
        return s, 0.0
    raise ValueError(f"no init rule for leaf {name} {shape}")


def dims(model: dict) -> dict:
    d = model["d_model"]
    d_in = model.get("ssm_expand", 2) * d
    P = model.get("ssm_head_dim", 64)
    return {"L": model["n_layers"], "d": d, "V": model["vocab"],
            "Hq": model["n_heads"], "Hkv": model["n_kv_heads"],
            "hd": model.get("head_dim") or d // model["n_heads"],
            "ff": model["d_ff"], "da": 2 * d,
            "d_in": d_in, "H": d_in // P, "P": P, "N": model["ssm_state"],
            "G": model.get("mamba_ngroups", 1),
            "r": model["adapter_rank"],
            "apps": sum(i < model["n_layers"]
                        for i in model["hybrid_layer_ids"])}


def token_params(model: dict) -> int:
    """Matmul weights one token passes through, the head left out: every
    Mamba2 layer's two projections, and each application's block
    (attention, gated MLP), adapter and linear."""
    m = dims(model)
    mamba = m["d"] * (2 * m["d_in"] + 2 * m["G"] * m["N"] + m["H"]) \
        + m["d_in"] * m["d"]
    block = m["da"] * (m["Hq"] + 2 * m["Hkv"]) * m["hd"] \
        + m["Hq"] * m["hd"] * m["d"] + 3 * m["d"] * m["ff"] \
        + m["r"] * (m["d"] + 2 * m["ff"]) + m["d"] * m["d"]
    return m["L"] * mamba + m["apps"] * block


def _ssd_pairs(S: int) -> int:
    """Causal (t, s) pairs inside the program's SSD chunks over S tokens."""
    Q = min(SSD_CHUNK, S)
    full, rest = divmod(S, Q)
    return full * Q * (Q + 1) // 2 + rest * (rest + 1) // 2


def serve_flops(model: dict, prefill_lengths, decode_tokens: int,
                decode_ctx: int) -> float:
    """2 FLOPs a weight a token through the layers; the tied head once a
    prefill (its last position) and once a decoded token; the SSD: at
    prefill its intra-chunk products over the causal pairs of each chunk,
    ``C B^T`` per group and the weighted sum of x per head (2 (G N + H P) a
    pair a layer), and the state's increment and read-out (4 H P N a token
    a layer), the same 4 H P N a decoded token; attention: K1's causal
    pairs at each application, 4 Hq hd a cached row a decoded token at
    each."""
    m = dims(model)
    W = token_params(model)
    state = 4.0 * m["H"] * m["P"] * m["N"] * m["L"]
    pair = 2.0 * (m["G"] * m["N"] + m["H"] * m["P"]) * m["L"]
    total = 0.0
    for S in prefill_lengths:
        ops, _ = roofline.flash_work((1, S, S, m["Hq"], m["Hkv"], m["hd"],
                                      True, 0, 0), 2)
        total += 2.0 * W * S + 2.0 * m["d"] * m["V"] + state * S \
            + pair * _ssd_pairs(S) + m["apps"] * ops
    total += decode_tokens * (2.0 * (W + m["d"] * m["V"]) + state)
    total += m["apps"] * 4.0 * m["Hq"] * m["hd"] * decode_ctx
    return total


def attention_calls(model: dict) -> list[tuple[int, int, int, int, int]]:
    """One call an application of a shared block, full causal attention at
    the block's head width."""
    m = dims(model)
    return [(m["Hq"], m["Hkv"], m["hd"], m["hd"], 0)] * m["apps"]
