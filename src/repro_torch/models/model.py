"""Model API of the port: the dense and localglobal (gemma3) families.

Public surface, mirroring ``repro.models.model``:

  init_params(cfg, seed, device)         -> DenseLM (an nn.Module)
  loss_fn(cfg, model, batch)            -> (loss, metrics)     [forward only]
  prefill(cfg, model, batch, max_seq)   -> (last_logits, decode_state)
  init_decode_state(cfg, batch, max_seq, device) -> decode_state
  decode_step(cfg, model, state, tok)   -> (logits, decode_state)
  param_count(cfg)

The decode state keeps the reference's names and layout —
``{"pos": (B,) int32, "k": (L, B, S, Hkv, hd), "v": ...}`` — so slot reads and
writes, slot signatures and parked slices mean the same thing in both
packages. Unlike the reference, ``decode_step`` writes the new K/V row into
the state's cache IN PLACE (one cache buffer, no copy per step); the returned
state holds the same tensors.

Attention goes through :mod:`repro_torch.kernels.ops`: the hand-written
kernels for CUDA tensors, their plain versions for CPU tensors. The other
families raise ``NotImplementedError`` until their slice of the port lands.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import attention_op, decode_attention_op
from repro_torch.models.layers import (AttnDims, apply_rope, cache_update,
                                       embed_tokens, init_attn, init_linear,
                                       init_mlp, mlp_block, rms_norm,
                                       softmax_xent, uniform_scale_init,
                                       unembed)

DENSE_FAMILIES = ("dense", "localglobal")
_PORTED_LATER = {"moe": "Queue 1 item 7 (moe + mla)",
                 "hybrid": "Queue 1 item 7 (hybrid)",
                 "rwkv": "Queue 1 item 7 (rwkv)",
                 "encdec": "Queue 1 item 7 (encdec + vlm)",
                 "vlm": "Queue 1 item 7 (encdec + vlm)"}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in DENSE_FAMILIES:
        raise NotImplementedError(
            f"repro_torch: family {cfg.family!r} ({cfg.name}) is not ported "
            f"yet; ROADMAP.md {_PORTED_LATER.get(cfg.family, 'Queue 1')}")


def padded_vocab(cfg: ModelConfig) -> int:
    return int(np.ceil(cfg.vocab / 256) * 256)


def _logit_mask(cfg: ModelConfig, dtype, device) -> torch.Tensor | None:
    """-1e30 on the padded vocab columns (None when nothing is padded)."""
    vp = padded_vocab(cfg)
    if vp == cfg.vocab:
        return None
    cols = torch.arange(vp, device=device)
    return torch.where(cols < cfg.vocab, 0.0, -1e30).to(dtype)


def _dims(cfg: ModelConfig) -> AttnDims:
    return AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer sliding window (0 = full attention)."""
    L = cfg.n_layers
    if cfg.family != "localglobal":
        return np.zeros((L,), np.int32)
    w = np.full((L,), cfg.sliding_window, np.int32)
    w[cfg.global_every - 1::cfg.global_every] = 0        # 1 global per group
    return w


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DenseBlock(nn.Module):
    """One GQA decoder layer's weights (the reference's ``blocks[l]``)."""

    def __init__(self, ln1: torch.Tensor, attn: dict, ln2: torch.Tensor,
                 mlp: dict) -> None:
        super().__init__()
        self.ln1 = _frozen(ln1)
        self.attn = nn.ParameterDict({k: _frozen(v) for k, v in attn.items()})
        self.ln2 = _frozen(ln2)
        self.mlp = nn.ParameterDict({k: _frozen(v) for k, v in mlp.items()})


class DenseLM(nn.Module):
    """Dense / localglobal GQA decoder. Weights keep the reference's
    ``(d_in, d_out)`` layout, so activations multiply as ``h @ w``."""

    def __init__(self, cfg: ModelConfig, embed: dict, blocks: list[dict],
                 final_norm: torch.Tensor) -> None:
        super().__init__()
        cfg.validate()
        _check_family(cfg)
        if len(blocks) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(blocks)} blocks for "
                             f"{cfg.n_layers} layers")
        self.cfg = cfg
        self.embed = nn.ParameterDict({k: _frozen(v) for k, v in embed.items()})
        self.blocks = nn.ModuleList(DenseBlock(**b) for b in blocks)
        self.final_norm = _frozen(final_norm)
        self.windows = [int(w) for w in _windows(cfg)]
        self.register_buffer("logit_mask", _logit_mask(
            cfg, final_norm.dtype, final_norm.device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    # -------------------------------------------------------------- pieces
    def _head(self, h: torch.Tensor) -> torch.Tensor:
        logits = unembed(self.embed, h)
        return logits if self.logit_mask is None else logits + self.logit_mask

    def _qkv(self, blk: DenseBlock, hn: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        B, S, _ = hn.shape
        q = (hn @ blk.attn["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
        k = (hn @ blk.attn["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
        v = (hn @ blk.attn["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta), v)

    def _residual(self, blk: DenseBlock, h: torch.Tensor,
                  o: torch.Tensor) -> torch.Tensor:
        B, S = h.shape[:2]
        h = h + o.reshape(B, S, -1) @ blk.attn["wo"]
        return h + mlp_block(blk.mlp, rms_norm(h, blk.ln2, self.cfg.norm_eps))

    # ---------------------------------------------------------------- paths
    def hidden(self, tokens: torch.Tensor, *, kv_out=None) -> torch.Tensor:
        """Final-normed hidden states of a full causal pass over ``tokens``.
        With ``kv_out=(ck, cv)`` each layer's K/V is written into
        ``ck[l, :, :S]`` / ``cv[l, :, :S]``."""
        B, S = tokens.shape
        h = embed_tokens(self.embed, tokens)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
        for li, (blk, w) in enumerate(zip(self.blocks, self.windows)):
            q, k, v = self._qkv(blk, rms_norm(h, blk.ln1, self.cfg.norm_eps),
                                positions)
            if kv_out is not None:
                kv_out[0][li, :, :S] = k
                kv_out[1][li, :, :S] = v
            o = attention_op(q, k, v, causal=True, window=w)
            h = self._residual(blk, h, o)
        return rms_norm(h, self.final_norm, self.cfg.norm_eps)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits (B, S, padded_vocab) of every position."""
        return self._head(self.hidden(tokens))

    def prefill(self, tokens: torch.Tensor, max_seq: int):
        B, S = tokens.shape
        if S > max_seq:
            raise ValueError(f"prompt of {S} tokens exceeds max_seq {max_seq}")
        state = init_decode_state(self.cfg, B, max_seq, device=self.device)
        h = self.hidden(tokens, kv_out=(state["k"], state["v"]))
        state["pos"].fill_(S)
        return self._head(h[:, -1:]), state

    def decode_step(self, state: dict, tokens: torch.Tensor):
        B = tokens.shape[0]
        pos = state["pos"]                                      # (B,)
        ck, cv = state["k"], state["v"]
        lengths = (pos + 1).to(torch.int32)
        h = embed_tokens(self.embed, tokens)                    # (B, 1, d)
        for li, (blk, w) in enumerate(zip(self.blocks, self.windows)):
            q, k, v = self._qkv(blk, rms_norm(h, blk.ln1, self.cfg.norm_eps),
                                pos[:, None])
            cache_update(ck[li], cv[li], k, v, pos)             # in place
            o = decode_attention_op(q[:, 0], ck[li], cv[li], lengths,
                                    window=w)
            h = self._residual(blk, h, o.reshape(B, 1, -1))
        h = rms_norm(h, self.final_norm, self.cfg.norm_eps)
        return self._head(h), {"pos": pos + 1, "k": ck, "v": cv}


# ================================================================ public API
def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: str | torch.device | None = None) -> DenseLM:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on the
    target device (``cuda`` unless asked otherwise), with the reference's
    init scales. The numbers differ from ``jax.random``'s; parity tests
    bridge the reference's params instead (``repro_torch._bridge``)."""
    cfg.validate()
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = _dtype(cfg)
    d, vp, L = cfg.d_model, padded_vocab(cfg), cfg.n_layers

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=dev)

    embed = {"tok": uniform_scale_init(gen, (vp, d), dt)}
    if not cfg.tie_embeddings:
        embed["head"] = init_linear(gen, d, vp, dt)
    blocks = [{"ln1": zeros(d), "attn": init_attn(gen, _dims(cfg), dt, L),
               "ln2": zeros(d), "mlp": init_mlp(gen, d, cfg.d_ff, dt, L)}
              for _ in range(L)]
    return DenseLM(cfg, embed, blocks, zeros(d))


def loss_fn(cfg: ModelConfig, model: DenseLM, batch: dict):
    """Next-token cross entropy (forward only: this slice serves)."""
    loss = softmax_xent(model(batch["tokens"]), batch["labels"])
    return loss, {"loss": loss}


def prefill(cfg: ModelConfig, model: DenseLM, batch: dict, max_seq: int):
    return model.prefill(batch["tokens"], max_seq)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device: str | torch.device | None = None) -> dict:
    _check_family(cfg)
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev)}


def decode_step(cfg: ModelConfig, model: DenseLM, state: dict,
                tokens: torch.Tensor):
    return model.decode_step(state, tokens)


def param_count(cfg: ModelConfig) -> int:
    """Parameter count from the shapes alone (nothing is allocated)."""
    _check_family(cfg)
    d, vp = cfg.d_model, padded_vocab(cfg)
    q, kv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    block = 2 * d + d * q + 2 * d * kv + q * d + 3 * d * cfg.d_ff
    embed = vp * d * (1 if cfg.tie_embeddings else 2)
    return embed + cfg.n_layers * block + d
