"""Model API of the port: every family of the reference — dense,
localglobal (gemma3), encdec (whisper), vlm (llama-3.2-vision), moe
(deepseek-v3, arctic), hybrid (zamba2) and rwkv.

Public surface, mirroring ``repro.models.model``:

  init_params(cfg, seed, device)         -> the family's nn.Module
  loss_fn(cfg, model, batch)            -> (loss, metrics)     [train step core]
  prefill(cfg, model, batch, max_seq)   -> (last_logits, decode_state)
  init_decode_state(cfg, batch, max_seq, device) -> decode_state
  decode_step(cfg, model, state, tok)   -> (logits, decode_state)
  param_count(cfg)

Batches are ``{"tokens": (B, S), "labels": (B, S)}`` plus ``"frames": (B,
n_frames, d)`` for encdec and ``"patches": (B, n_patches, d)`` for vlm (the
audio and vision frontends are stubbed to precomputed embeddings, as in the
reference).

The decode states keep the reference's names and layouts, so slot reads and
writes, slot signatures and parked slices mean the same thing in both
packages:

  dense / localglobal  {"pos": (B,) int32, "k", "v": (L, B, S, Hkv, hd)}
  encdec               {"pos", "k", "v", "xk", "xv": (L, B, n_frames, Hkv, hd)}
  vlm                  {"pos", "k", "v": (G, S_per, B, S, Hkv, hd),
                        "xk", "xv": (G, B, n_patches, Hkv, hd)}
  moe                  {"pos", "dense_cache": (c1, c2), "moe_cache": (c1, c2)}
                       with MLA latents (n, B, S, kv_lora) / (n, B, S, rope),
                       else GQA (n, B, S, Hkv, hd) pairs
  hybrid               {"pos", "groups": {"conv": (G*A, B, conv-1, d_in+2N),
                        "ssm": (G*A, B, H, P, N)} (f32),
                        "attn_k", "attn_v": (G, B, S, Hkv, hd),
                        "tail": {"conv", "ssm"} of the tail layers}
  rwkv                 {"pos", "tm_x", "cm_x": (L, B, d), "wkv": (L, B, H, K, K)}
                       (f32; the same size whatever the length)

Unlike the reference, ``decode_step`` writes the new cache rows — and the
recurrent conv, SSM and WKV states — into the state's tensors IN PLACE (one
buffer, no copy per step); the returned state holds the same tensors.

A model's weights are frozen (serving) until :func:`make_trainable` lets
autograd record them; every family trains. When autograd records a pass,
each layer is recomputed in the backward (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` with ``nothing_saveable``): every encoder,
decoder, self, gated cross, dense, MoE, Mamba2 and RWKV layer, and each
application of zamba2's shared block. The reference recomputes vlm and
hybrid a whole group at a time; per layer saves a little more and computes
the same numbers. So the flash kernel runs twice per attention application
and microbatch (forward and recompute) and its plain backward once; the MTP
block of the moe loss is not recomputed, as in the reference.

Attention goes through :mod:`repro_torch.kernels.ops`: the hand-written
kernels for CUDA tensors, their plain versions for CPU tensors — self and
cross attention at prefill through the flash kernel, self and cross
attention at decode through the decode kernel. MLA decode (absorbed form)
and the MoE experts stay torch matmuls, as the reference computes them
outside any Pallas kernel; so do the Mamba2 chunked SSD and the RWKV scan
(:mod:`repro_torch.models.ssm`, :mod:`repro_torch.models.rwkv`). zamba2's
one shared attention block runs the flash kernel at prefill and the decode
kernel at every step, at each of its application points.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import attention_op, decode_attention_op
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (AttnDims, apply_rope, cache_update,
                                       cross_attend, cross_kv, embed_tokens,
                                       init_attn, init_linear, init_mlp,
                                       mlp_block, rms_norm,
                                       softmax_xent, uniform_scale_init,
                                       unembed)

DENSE_FAMILIES = ("dense", "localglobal")
FAMILIES = DENSE_FAMILIES + ("encdec", "vlm", "moe", "hybrid", "rwkv")
_EXTRAS = {"encdec": "frames", "vlm": "patches"}   # the stubbed frontends


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"repro_torch: unknown family {cfg.family!r} "
                         f"({cfg.name})")


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


def _vlm_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, self_per_group): groups of (self x k + 1 cross)."""
    per = cfg.cross_every
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"groups of {per}")
    return cfg.n_layers // per, per - 1


def _hybrid_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, n_tail): groups of (attn_every mamba + 1 shared attn)."""
    n_groups = cfg.n_layers // cfg.attn_every
    return n_groups, cfg.n_layers - n_groups * cfg.attn_every


def _sinusoid(n: int, d: int) -> np.ndarray:
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Params(nn.Module):
    """A nested dict of weights as a module of parameters (frozen until
    :func:`make_trainable`), read as the reference reads its pytree:
    ``p["attn"]["wq"]``, ``"w3" in p``."""

    def __init__(self, tree: dict) -> None:
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, Params(v))
            else:
                self.register_parameter(k, _frozen(v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def _blocks(trees: list[dict], n: int, what: str) -> nn.ModuleList:
    if len(trees) != n:
        raise ValueError(f"{len(trees)} {what} for {n} layers")
    return nn.ModuleList(Params(t) for t in trees)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


# ------------------------------------------------------------ shared layers
def _attn_prefill(cfg: ModelConfig, attn, hn: torch.Tensor,
                  positions: torch.Tensor, window: int = 0,
                  kv=None) -> torch.Tensor:
    """Causal GQA self attention of a whole sequence, projected back to d.
    With ``kv=(ck, cv)`` (B, S_max, Hkv, hd) the rotated keys and the values
    are written into ``[:, :S]``."""
    B, S, _ = hn.shape
    q = (hn @ attn["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    k = (hn @ attn["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (hn @ attn["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv is not None:
        kv[0][:, :S] = k
        kv[1][:, :S] = v
    o = attention_op(q, k, v, causal=True, window=window)
    return o.reshape(B, S, -1) @ attn["wo"]


def _attn_decode(cfg: ModelConfig, attn, hn: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, pos: torch.Tensor, lengths: torch.Tensor,
                 window: int = 0) -> torch.Tensor:
    """One decode position of GQA self attention: the new K/V row is written
    into ``ck``/``cv`` (B, S, Hkv, hd) in place, then attended."""
    B = hn.shape[0]
    q = (hn @ attn["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
    k = (hn @ attn["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
    v = (hn @ attn["wv"]).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    cache_update(ck, cv, k, v, pos)
    o = decode_attention_op(q[:, 0], ck, cv, lengths, window=window)
    return o.reshape(B, 1, -1) @ attn["wo"]


def _dense_layer(cfg: ModelConfig, p, h: torch.Tensor, positions,
                 window: int = 0, kv=None) -> torch.Tensor:
    """One GQA decoder layer over a whole sequence (the reference's
    ``_gqa_layer``)."""
    h = h + _attn_prefill(cfg, p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
                          positions, window, kv)
    return h + mlp_block(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps))


def _dense_layer_decode(cfg: ModelConfig, p, h: torch.Tensor, ck, cv, pos,
                        lengths, window: int = 0) -> torch.Tensor:
    h = h + _attn_decode(cfg, p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
                         ck, cv, pos, lengths, window)
    return h + mlp_block(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps))


def _cross_decode(cfg: ModelConfig, attn, hx: torch.Tensor, xk: torch.Tensor,
                  xv: torch.Tensor) -> torch.Tensor:
    """One decode position of cross attention against the whole precomputed
    encoder / patch K/V: every key is live (the reference's ``q_pos =
    F - 1``), so the decode kernel runs at full length for every row."""
    B = hx.shape[0]
    q = (hx @ attn["wq"]).reshape(B, cfg.n_heads, cfg.hd)
    full = torch.full((B,), xk.shape[1], dtype=torch.int32, device=hx.device)
    o = decode_attention_op(q, xk, xv, full)
    return o.reshape(B, 1, -1) @ attn["wo"]


class _LM(nn.Module):
    """What every family shares: the embedding, the final norm and the
    vocab-padding mask of the head. Weights keep the reference's
    ``(d_in, d_out)`` layout, so activations multiply as ``h @ w``."""

    def __init__(self, cfg: ModelConfig, embed: dict,
                 final_norm: torch.Tensor) -> None:
        super().__init__()
        cfg.validate()
        _check_family(cfg)
        self.cfg = cfg
        self.embed = Params(embed)
        self.final_norm = _frozen(final_norm)
        self.register_buffer("logit_mask", _logit_mask(
            cfg, final_norm.dtype, final_norm.device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def _final(self, h: torch.Tensor) -> torch.Tensor:
        return rms_norm(h, self.final_norm, self.cfg.norm_eps)

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        logits = unembed(self.embed, h)
        return logits if self.logit_mask is None else logits + self.logit_mask

    def _check_prompt(self, S: int, max_seq: int) -> None:
        if S > max_seq:
            raise ValueError(f"prompt of {S} tokens exceeds max_seq {max_seq}")

    def _remat(self, writes_state: bool) -> bool:
        """Whether autograd records this pass (a training pass): then each
        layer keeps only its inputs and is recomputed in the backward. A
        pass that writes a cache or a state never is."""
        return (torch.is_grad_enabled() and self.final_norm.requires_grad
                and not writes_state)


def _run(remat: bool, fn, *args):
    """``fn(*args)``, under per-layer recompute when ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ============================================================ dense / gemma3
class DenseLM(_LM):
    """Dense / localglobal GQA decoder: ``blocks[l]`` is the reference's
    ``params["blocks"]`` at layer l."""

    def __init__(self, cfg: ModelConfig, tree: dict) -> None:
        super().__init__(cfg, tree["embed"], tree["final_norm"])
        self.blocks = _blocks(tree["blocks"], cfg.n_layers, "blocks")
        self.windows = [int(w) for w in _windows(cfg)]

    def hidden(self, tokens: torch.Tensor, *, kv_out=None) -> torch.Tensor:
        """Final-normed hidden states of a full causal pass over ``tokens``.
        With ``kv_out=(ck, cv)`` each layer's K/V is written into
        ``ck[l, :, :S]`` / ``cv[l, :, :S]``."""
        B, S = tokens.shape
        h = embed_tokens(self.embed, tokens)
        positions = _positions(B, S, tokens.device)
        remat = self._remat(kv_out is not None)
        for li, (p, w) in enumerate(zip(self.blocks, self.windows)):
            kv = None if kv_out is None else (kv_out[0][li], kv_out[1][li])
            h = _run(remat, _dense_layer, self.cfg, p, h, positions, w, kv)
        return self._final(h)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits (B, S, padded_vocab) of every position."""
        return self._head(self.hidden(tokens))

    def prefill(self, tokens: torch.Tensor, max_seq: int):
        B, S = tokens.shape
        self._check_prompt(S, max_seq)
        state = init_decode_state(self.cfg, B, max_seq, device=self.device)
        h = self.hidden(tokens, kv_out=(state["k"], state["v"]))
        state["pos"].fill_(S)
        return self._head(h[:, -1:]), state

    def decode_step(self, state: dict, tokens: torch.Tensor):
        pos = state["pos"]                                      # (B,)
        ck, cv = state["k"], state["v"]
        lengths = (pos + 1).to(torch.int32)
        h = embed_tokens(self.embed, tokens)                    # (B, 1, d)
        for li, (p, w) in enumerate(zip(self.blocks, self.windows)):
            h = _dense_layer_decode(self.cfg, p, h, ck[li], cv[li], pos,
                                    lengths, w)
        return self._head(self._final(h)), {"pos": pos + 1, "k": ck, "v": cv}


# ==================================================================== encdec
class EncDecLM(_LM):
    """whisper: a non-causal encoder over frame embeddings, and a decoder
    whose layers run causal self attention, cross attention against the
    encoder output, then a (non-gated, tanh-GELU) MLP."""

    def __init__(self, cfg: ModelConfig, tree: dict) -> None:
        super().__init__(cfg, tree["embed"], tree["final_norm"])
        self.enc_blocks = _blocks(tree["enc_blocks"], cfg.encoder_layers,
                                  "encoder blocks")
        self.enc_norm = _frozen(tree["enc_norm"])
        self.dec_blocks = _blocks(tree["dec_blocks"], cfg.n_layers,
                                  "decoder blocks")

    def _enc_layer(self, p, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, F, _ = h.shape
        hn = rms_norm(h, p["ln1"], cfg.norm_eps)
        q = (hn @ p["attn"]["wq"]).reshape(B, F, cfg.n_heads, cfg.hd)
        k = (hn @ p["attn"]["wk"]).reshape(B, F, cfg.n_kv_heads, cfg.hd)
        v = (hn @ p["attn"]["wv"]).reshape(B, F, cfg.n_kv_heads, cfg.hd)
        o = attention_op(q, k, v, causal=False)
        h = h + o.reshape(B, F, -1) @ p["attn"]["wo"]
        return h + mlp_block(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps))

    def encode(self, frames: torch.Tensor, *,
               remat: bool = False) -> torch.Tensor:
        """Encoder output (B, F, d), in ``cfg.dtype``. The frames are taken
        in the model's dtype and the sinusoid is added there, as the
        reference adds it in the frames' dtype: for the bf16 configs the
        engine serves (bf16 frames) the two are the same rounding. The
        reference's encoder scan refuses frames in another dtype than its
        weights (the carry changes dtype at the first residual: ROADMAP.md
        Queue 3); the port casts them instead."""
        B, F, d = frames.shape
        frames = frames.to(self.final_norm.dtype)
        h = frames + torch.from_numpy(_sinusoid(F, d)).to(
            frames.device, frames.dtype)[None]
        for p in self.enc_blocks:
            h = _run(remat, self._enc_layer, p, h)
        return rms_norm(h, self.enc_norm, self.cfg.norm_eps)

    def _dec_layer(self, p, h: torch.Tensor, enc_out: torch.Tensor,
                   positions, kv=None, xkv=None) -> torch.Tensor:
        """One decoder layer: causal self attention, cross attention over
        ``enc_out`` (its K/V computed here, and written into ``xkv`` when
        given), the MLP."""
        cfg, dims = self.cfg, _dims(self.cfg)
        h = h + _attn_prefill(cfg, p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
                              positions, 0, kv)
        xk, xv = cross_kv(p["xattn"], enc_out, dims)
        if xkv is not None:
            xkv[0].copy_(xk)
            xkv[1].copy_(xv)
        h = h + cross_attend(p["xattn"], rms_norm(h, p["lnx"], cfg.norm_eps),
                             xk, xv, dims)
        return h + mlp_block(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps))

    def hidden(self, tokens: torch.Tensor, frames: torch.Tensor, *,
               state: dict | None = None) -> torch.Tensor:
        """Final-normed decoder states over ``tokens``. With ``state`` each
        layer's self K/V goes into ``state["k"/"v"][l, :, :S]`` and its cross
        K/V into ``state["xk"/"xv"][l]``. The encoder output is an input of
        every decoder layer's recompute."""
        remat = self._remat(state is not None)
        enc_out = self.encode(frames, remat=remat)
        B, S = tokens.shape
        h = embed_tokens(self.embed, tokens)
        positions = _positions(B, S, tokens.device)
        for li, p in enumerate(self.dec_blocks):
            kv = xkv = None
            if state is not None:
                kv = (state["k"][li], state["v"][li])
                xkv = (state["xk"][li], state["xv"][li])
            h = _run(remat, self._dec_layer, p, h, enc_out, positions, kv, xkv)
        return self._final(h)

    def forward(self, tokens: torch.Tensor,
                frames: torch.Tensor) -> torch.Tensor:
        return self._head(self.hidden(tokens, frames))

    def prefill(self, tokens: torch.Tensor, max_seq: int,
                frames: torch.Tensor):
        """Encode the frames, precompute every layer's cross K/V, then run
        the prompt through the decoder building the self-attention cache."""
        B, S = tokens.shape
        self._check_prompt(S, max_seq)
        state = init_decode_state(self.cfg, B, max_seq, device=self.device)
        h = self.hidden(tokens, frames, state=state)
        state["pos"].fill_(S)
        return self._head(h[:, -1:]), state

    def decode_step(self, state: dict, tokens: torch.Tensor):
        cfg = self.cfg
        pos = state["pos"]
        lengths = (pos + 1).to(torch.int32)
        h = embed_tokens(self.embed, tokens)
        for li, p in enumerate(self.dec_blocks):
            h = h + _attn_decode(cfg, p["attn"],
                                 rms_norm(h, p["ln1"], cfg.norm_eps),
                                 state["k"][li], state["v"][li], pos, lengths)
            h = h + _cross_decode(cfg, p["xattn"],
                                  rms_norm(h, p["lnx"], cfg.norm_eps),
                                  state["xk"][li], state["xv"][li])
            h = h + mlp_block(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps))
        return self._head(self._final(h)), dict(state, pos=pos + 1)


# ======================================================================== vlm
class VisionLM(_LM):
    """llama-3.2-vision: groups of ``cross_every - 1`` GQA self-attention
    layers and one gated cross-attention layer over the patch embeddings
    (gates are f32 scalars, applied as ``tanh(gate)`` in the activations'
    dtype)."""

    def __init__(self, cfg: ModelConfig, tree: dict) -> None:
        super().__init__(cfg, tree["embed"], tree["final_norm"])
        G, S_per = _vlm_layout(cfg)
        if len(tree["self_groups"]) != G:
            raise ValueError(f"{len(tree['self_groups'])} self groups for {G}")
        self.self_groups = nn.ModuleList(
            _blocks(g, S_per, "self blocks") for g in tree["self_groups"])
        self.cross_blocks = _blocks(tree["cross_blocks"], G, "cross blocks")

    def _gated(self, xp, h: torch.Tensor, xo: torch.Tensor) -> torch.Tensor:
        """The cross layer's two gated residuals around its attention
        output ``xo``."""
        h = h + torch.tanh(xp["gate"]).to(h.dtype) * xo
        return h + torch.tanh(xp["gate_mlp"]).to(h.dtype) * mlp_block(
            xp["mlp"], rms_norm(h, xp["ln2"], self.cfg.norm_eps))

    def _cross_layer(self, xp, h: torch.Tensor, patches: torch.Tensor,
                     xkv=None) -> torch.Tensor:
        """The gated cross layer: K/V of the patches (written into ``xkv``
        when given), cross attention, the two gated residuals."""
        cfg, dims = self.cfg, _dims(self.cfg)
        xk, xv = cross_kv(xp["attn"], patches, dims)
        if xkv is not None:
            xkv[0].copy_(xk)
            xkv[1].copy_(xv)
        xo = cross_attend(xp["attn"], rms_norm(h, xp["ln"], cfg.norm_eps),
                          xk, xv, dims)
        return self._gated(xp, h, xo)

    def hidden(self, tokens: torch.Tensor, patches: torch.Tensor, *,
               state: dict | None = None) -> torch.Tensor:
        cfg = self.cfg
        remat = self._remat(state is not None)
        # bf16 patches (the engine's) enter an f32 model exactly, as JAX
        # promotes them at the reference's ``patches @ wk``
        patches = patches.to(self.final_norm.dtype)
        B, S = tokens.shape
        h = embed_tokens(self.embed, tokens)
        positions = _positions(B, S, tokens.device)
        for g, (group, xp) in enumerate(zip(self.self_groups,
                                            self.cross_blocks)):
            for s, p in enumerate(group):
                kv = None if state is None \
                    else (state["k"][g, s], state["v"][g, s])
                h = _run(remat, _dense_layer, cfg, p, h, positions, 0, kv)
            xkv = None if state is None else (state["xk"][g], state["xv"][g])
            h = _run(remat, self._cross_layer, xp, h, patches, xkv)
        return self._final(h)

    def forward(self, tokens: torch.Tensor,
                patches: torch.Tensor) -> torch.Tensor:
        return self._head(self.hidden(tokens, patches))

    def prefill(self, tokens: torch.Tensor, max_seq: int,
                patches: torch.Tensor):
        B, S = tokens.shape
        self._check_prompt(S, max_seq)
        state = init_decode_state(self.cfg, B, max_seq, device=self.device)
        h = self.hidden(tokens, patches, state=state)
        state["pos"].fill_(S)
        return self._head(h[:, -1:]), state

    def decode_step(self, state: dict, tokens: torch.Tensor):
        cfg = self.cfg
        pos = state["pos"]
        lengths = (pos + 1).to(torch.int32)
        ck, cv = state["k"], state["v"]
        h = embed_tokens(self.embed, tokens)
        for g, (group, xp) in enumerate(zip(self.self_groups,
                                            self.cross_blocks)):
            for s, p in enumerate(group):
                h = _dense_layer_decode(cfg, p, h, ck[g, s], cv[g, s], pos,
                                        lengths)
            xo = _cross_decode(cfg, xp["attn"],
                               rms_norm(h, xp["ln"], cfg.norm_eps),
                               state["xk"][g], state["xv"][g])
            h = self._gated(xp, h, xo)
        return self._head(self._final(h)), dict(state, pos=pos + 1)


# ======================================================================= moe
class MoeLM(_LM):
    """deepseek-v3 (MLA attention, leading dense layers, shared expert, MTP)
    and arctic (GQA attention, dense residual FFN beside the experts)."""

    def __init__(self, cfg: ModelConfig, tree: dict) -> None:
        super().__init__(cfg, tree["embed"], tree["final_norm"])
        self.dense_blocks = _blocks(tree.get("dense_blocks", []),
                                    cfg.first_dense_layers, "dense blocks")
        self.moe_blocks = _blocks(tree["moe_blocks"],
                                  cfg.n_layers - cfg.first_dense_layers,
                                  "moe blocks")
        # multi-token prediction: used only by the loss
        self.mtp = Params(tree["mtp"]) if "mtp" in tree else None

    def _attn(self, attn, hn: torch.Tensor, positions,
              cache=None) -> torch.Tensor:
        """Self attention of a whole sequence; ``cache=(c1, c2)`` (B, S_max,
        ...) receives the MLA latents or the GQA K/V in ``[:, :S]``."""
        cfg = self.cfg
        if cfg.mla is None:
            return _attn_prefill(cfg, attn, hn, positions, 0, cache)
        lat = mla_mod._latents(cfg, attn, hn, positions)
        if cache is not None:
            S = hn.shape[1]
            cache[0][:, :S] = lat[0]
            cache[1][:, :S] = lat[1]
        return mla_mod.mla_attention(cfg, attn, hn, positions, latents=lat)

    def _ffn(self, p, h: torch.Tensor, moe: bool):
        """The layer's second residual: routed experts (plus arctic's dense
        residual) or the dense MLP. Returns (h, router aux or None)."""
        hn = rms_norm(h, p["ln2"], self.cfg.norm_eps)
        if not moe:
            return h + mlp_block(p["mlp"], hn), None
        y, aux = moe_mod.moe_ffn(self.cfg, p["moe"], hn)
        if self.cfg.dense_residual:
            y = y + mlp_block(p["dense_mlp"], hn)
        return h + y, aux

    def _layer(self, p, h, positions, moe: bool, cache=None):
        h = h + self._attn(p["attn"], rms_norm(h, p["ln1"], self.cfg.norm_eps),
                           positions, cache)
        return self._ffn(p, h, moe)

    def hidden(self, tokens: torch.Tensor, *, state: dict | None = None):
        """(final-normed hidden states, summed router aux loss)."""
        B, S = tokens.shape
        remat = self._remat(state is not None)
        h = embed_tokens(self.embed, tokens)
        positions = _positions(B, S, tokens.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for key, blocks, moe in (("dense_cache", self.dense_blocks, False),
                                 ("moe_cache", self.moe_blocks, True)):
            for li, p in enumerate(blocks):
                cache = None if state is None \
                    else (state[key][0][li], state[key][1][li])
                # the router aux is one of the recomputed layer's outputs
                h, aux = _run(remat, self._layer, p, h, positions, moe, cache)
                if aux is not None:
                    aux_total = aux_total + aux
        return self._final(h), aux_total

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor):
        """Next-token cross entropy + router aux, plus the MTP head's
        (t+2)-prediction loss when the config has one (forward only)."""
        cfg = self.cfg
        h, aux = self.hidden(tokens)
        xent = softmax_xent(self._head(h), labels)
        loss = xent + aux
        metrics = {"loss": loss, "xent": xent, "aux": aux}
        if cfg.mtp_depth:
            m = self.mtp
            emb_next = embed_tokens(self.embed, labels.clamp(min=0))
            z = torch.cat([rms_norm(h, m["norm"], cfg.norm_eps), emb_next],
                          dim=-1) @ m["proj"]
            B, S = tokens.shape
            z, _ = self._layer(m["block"], z, _positions(B, S, tokens.device),
                               False)
            labels2 = torch.cat([labels[:, 1:],
                                 torch.full_like(labels[:, :1], -1)], dim=1)
            mtp = softmax_xent(self._head(z), labels2)
            loss = loss + 0.3 * mtp
            metrics.update({"mtp": mtp, "loss": loss})
        return loss, metrics

    def prefill(self, tokens: torch.Tensor, max_seq: int):
        B, S = tokens.shape
        self._check_prompt(S, max_seq)
        state = init_decode_state(self.cfg, B, max_seq, device=self.device)
        h, _ = self.hidden(tokens, state=state)
        state["pos"].fill_(S)
        return self._head(h[:, -1:]), state

    def decode_step(self, state: dict, tokens: torch.Tensor):
        cfg = self.cfg
        pos = state["pos"]
        lengths = (pos + 1).to(torch.int32)
        h = embed_tokens(self.embed, tokens)
        for key, blocks, moe in (("dense_cache", self.dense_blocks, False),
                                 ("moe_cache", self.moe_blocks, True)):
            for li, p in enumerate(blocks):
                c1, c2 = state[key][0][li], state[key][1][li]
                hn = rms_norm(h, p["ln1"], cfg.norm_eps)
                if cfg.mla is not None:
                    o, _ = mla_mod.mla_decode(cfg, p["attn"], hn,
                                              {"c_kv": c1, "k_rope": c2}, pos)
                else:
                    o = _attn_decode(cfg, p["attn"], hn, c1, c2, pos, lengths)
                h, _ = self._ffn(p, h + o, moe)
        return self._head(self._final(h)), dict(state, pos=pos + 1)


# ============================================================ hybrid (zamba2)
class HybridLM(_LM):
    """zamba2: ``G`` groups of ``attn_every`` Mamba2 layers, each followed by
    the ONE shared attention block (``ln``, ``attn``, ``ln2``, ``mlp``; its
    params shared by every application point, its KV cache not), then the
    tail's Mamba2 layers. ``groups[g][i]`` is the reference's
    ``params["groups"]`` at (g, i)."""

    def __init__(self, cfg: ModelConfig, tree: dict) -> None:
        super().__init__(cfg, tree["embed"], tree["final_norm"])
        G, tail = _hybrid_layout(cfg)
        if len(tree["groups"]) != G:
            raise ValueError(f"{len(tree['groups'])} mamba groups for {G}")
        self.groups = nn.ModuleList(_blocks(g, cfg.attn_every, "mamba layers")
                                    for g in tree["groups"])
        self.shared_attn = Params(tree["shared_attn"])
        self.tail = _blocks(tree.get("tail", []), tail, "tail layers")

    def _layers(self):
        """(params, state key, index into that state) of every Mamba2 layer
        in order, with None after each group's last: the shared block."""
        A = self.cfg.attn_every
        for g, group in enumerate(self.groups):
            for i, p in enumerate(group):
                yield p, "groups", g * A + i
            yield None, "attn", g
        for i, p in enumerate(self.tail):
            yield p, "tail", i

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        sa = self.shared_attn
        return h + mlp_block(sa["mlp"], rms_norm(h, sa["ln2"], self.cfg.norm_eps))

    def _shared_block(self, h: torch.Tensor, positions,
                      kv=None) -> torch.Tensor:
        """One application of the shared attention block (its K/V written
        into ``kv`` when given)."""
        sa = self.shared_attn
        h = h + _attn_prefill(self.cfg, sa["attn"],
                              rms_norm(h, sa["ln"], self.cfg.norm_eps),
                              positions, 0, kv)
        return self._mlp(h)

    def _mamba_layer(self, p, h: torch.Tensor,
                     st: dict | None = None) -> torch.Tensor:
        """One Mamba2 layer; with ``st`` ({conv, ssm} of this layer) its
        exact post-sequence state is written there."""
        x = rms_norm(h, p["norm"], self.cfg.norm_eps)
        if st is None:
            return h + ssm_mod.mamba2_block(self.cfg, p["mamba"], x)
        y, new = ssm_mod.mamba2_block(self.cfg, p["mamba"], x,
                                      return_state=True)
        st["conv"].copy_(new["conv"])
        st["ssm"].copy_(new["ssm"])
        return h + y

    def hidden(self, tokens: torch.Tensor, *,
               state: dict | None = None) -> torch.Tensor:
        """Final-normed hidden states of the chunked (parallel) pass. With
        ``state`` each Mamba2 layer's exact post-sequence {conv, ssm} state
        and each application point's K/V (``[:, :S]``) are written into it."""
        remat = self._remat(state is not None)
        B, S = tokens.shape
        h = embed_tokens(self.embed, tokens)
        positions = _positions(B, S, tokens.device)
        for p, key, i in self._layers():
            if p is None:
                kv = None if state is None \
                    else (state["attn_k"][i], state["attn_v"][i])
                h = _run(remat, self._shared_block, h, positions, kv)
                continue
            st = None if state is None else {k: state[key][k][i]
                                             for k in ("conv", "ssm")}
            h = _run(remat, self._mamba_layer, p, h, st)
        return self._final(h)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._head(self.hidden(tokens))

    def prefill(self, tokens: torch.Tensor, max_seq: int):
        B, S = tokens.shape
        self._check_prompt(S, max_seq)
        state = init_decode_state(self.cfg, B, max_seq, device=self.device)
        h = self.hidden(tokens, state=state)
        state["pos"].fill_(S)
        return self._head(h[:, -1:]), state

    def decode_step(self, state: dict, tokens: torch.Tensor):
        cfg = self.cfg
        sa, eps = self.shared_attn, cfg.norm_eps
        pos = state["pos"]
        lengths = (pos + 1).to(torch.int32)
        h = embed_tokens(self.embed, tokens)
        for p, key, i in self._layers():
            if p is None:
                h = h + _attn_decode(cfg, sa["attn"], rms_norm(h, sa["ln"], eps),
                                     state["attn_k"][i], state["attn_v"][i],
                                     pos, lengths)
                h = self._mlp(h)
                continue
            conv, ssm = state[key]["conv"][i], state[key]["ssm"][i]
            y, new = ssm_mod.mamba2_step(cfg, p["mamba"],
                                         {"conv": conv, "ssm": ssm},
                                         rms_norm(h, p["norm"], eps))
            conv.copy_(new["conv"])
            ssm.copy_(new["ssm"])
            h = h + y
        return self._head(self._final(h)), dict(state, pos=pos + 1)


# ======================================================================= rwkv
class RwkvLM(_LM):
    """RWKV-6: ``blocks[l]`` (``ln1``, ``tm``, ``ln2``, ``cm``) is the
    reference's ``params["blocks"]`` at layer l. One stateful pass serves
    prefill (from a zero state) and decode (S >= 1 new tokens)."""

    def __init__(self, cfg: ModelConfig, tree: dict) -> None:
        super().__init__(cfg, tree["embed"], tree["final_norm"])
        self.blocks = _blocks(tree["blocks"], cfg.n_layers, "blocks")

    def hidden(self, tokens: torch.Tensor, *,
               state: dict | None = None) -> torch.Tensor:
        """Final-normed hidden states over ``tokens``, carrying ``state``
        (its token-shift inputs and WKV states are updated IN PLACE; ``None``
        starts from zeros and keeps nothing)."""
        remat = self._remat(state is not None)
        h = embed_tokens(self.embed, tokens)
        for li, p in enumerate(self.blocks):
            h = _run(remat, self._block, p, h, state, li)
        return self._final(h)

    def _block(self, p, h: torch.Tensor, state: dict | None,
               li: int) -> torch.Tensor:
        """One RWKV block (time mix, channel mix), carrying layer ``li`` of
        ``state`` when given (written in place)."""
        cfg, eps = self.cfg, self.cfg.norm_eps
        kw = {} if state is None else dict(last_x=state["tm_x"][li],
                                           state=state["wkv"][li])
        out, tm_new, wkv = rwkv_mod.time_mix(
            cfg, p["tm"], rms_norm(h, p["ln1"], eps), **kw)
        h = h + out
        out, cm_new = rwkv_mod.channel_mix(
            cfg, p["cm"], rms_norm(h, p["ln2"], eps),
            last_x=None if state is None else state["cm_x"][li])
        h = h + out
        if state is not None:
            state["tm_x"][li].copy_(tm_new)              # stored in f32
            state["cm_x"][li].copy_(cm_new)
            state["wkv"][li].copy_(wkv)
        return h

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._head(self.hidden(tokens))

    def prefill(self, tokens: torch.Tensor, max_seq: int):
        """The stateful pass from a zero state; the state has no sequence
        axis, so ``max_seq`` sizes nothing (as in the reference)."""
        B, S = tokens.shape
        state = init_decode_state(self.cfg, B, max_seq, device=self.device)
        h = self.hidden(tokens, state=state)
        state["pos"].fill_(S)
        return self._head(h[:, -1:]), state

    def decode_step(self, state: dict, tokens: torch.Tensor):
        """S >= 1 tokens per row; logits of every one, ``pos`` + S."""
        h = self.hidden(tokens, state=state)
        return self._head(h), dict(state, pos=state["pos"] + tokens.shape[1])


# ===================================================================== init
def _init_tree(cfg: ModelConfig, gen: torch.Generator | None,
               dev: torch.device) -> dict:
    """The family's weights as the reference's pytree, its stacked layers as
    lists, with the reference's init scales (``gen=None``: meta tensors)."""
    dt, d, L = _dtype(cfg), cfg.d_model, cfg.n_layers

    def zeros(shape=(d,), dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def attn(n_layers=L):
        return init_attn(gen, _dims(cfg), dt, n_layers)

    def mlp(n_layers=L, gated=True, d_ff=cfg.d_ff):
        return init_mlp(gen, d, d_ff, dt, n_layers, gated=gated)

    def dense_block():
        return {"ln1": zeros(), "attn": attn(), "ln2": zeros(), "mlp": mlp()}

    embed = {"tok": uniform_scale_init(gen, (padded_vocab(cfg), d), dt)}
    if not cfg.tie_embeddings:
        embed["head"] = init_linear(gen, d, padded_vocab(cfg), dt)
    tree = {"embed": embed, "final_norm": zeros()}
    if cfg.family in DENSE_FAMILIES:
        tree["blocks"] = [dense_block() for _ in range(L)]
    elif cfg.family == "encdec":
        E = cfg.encoder_layers
        tree["enc_blocks"] = [{"ln1": zeros(), "attn": attn(E), "ln2": zeros(),
                               "mlp": mlp(E, gated=False)} for _ in range(E)]
        tree["enc_norm"] = zeros()
        tree["dec_blocks"] = [{"ln1": zeros(), "attn": attn(), "lnx": zeros(),
                               "xattn": attn(), "ln2": zeros(),
                               "mlp": mlp(gated=False)} for _ in range(L)]
    elif cfg.family == "vlm":
        G, S_per = _vlm_layout(cfg)
        tree["self_groups"] = [[dense_block() for _ in range(S_per)]
                               for _ in range(G)]
        tree["cross_blocks"] = [
            {"ln": zeros(), "attn": attn(), "gate": zeros((), torch.float32),
             "ln2": zeros(), "mlp": mlp(),
             "gate_mlp": zeros((), torch.float32)} for _ in range(G)]
    elif cfg.family == "hybrid":
        G, tail = _hybrid_layout(cfg)

        def mamba_layer():
            return {"norm": zeros(),
                    "mamba": ssm_mod.init_mamba2(gen, cfg, dt, L, device=dev)}

        tree["groups"] = [[mamba_layer() for _ in range(cfg.attn_every)]
                          for _ in range(G)]
        tree["shared_attn"] = {"ln": zeros(), "attn": attn(), "ln2": zeros(),
                               "mlp": mlp()}
        if tail:
            tree["tail"] = [mamba_layer() for _ in range(tail)]
    elif cfg.family == "rwkv":
        tree["blocks"] = [{"ln1": zeros(), "ln2": zeros(),
                           **rwkv_mod.init_rwkv_block(gen, cfg, dt, L,
                                                      device=dev)}
                          for _ in range(L)]
    else:                                                      # moe

        def moe_attn():
            if cfg.mla is not None:
                return mla_mod.init_mla(gen, cfg, dt, L, device=dev)
            return attn()

        def ffn_block():
            return {"ln1": zeros(), "attn": moe_attn(), "ln2": zeros(),
                    "mlp": mlp()}

        def moe_block():
            p = {"ln1": zeros(), "attn": moe_attn(), "ln2": zeros(),
                 "moe": moe_mod.init_moe(gen, cfg, dt, L)}
            if cfg.dense_residual:
                p["dense_mlp"] = mlp()
            return p

        if cfg.first_dense_layers:
            tree["dense_blocks"] = [ffn_block()
                                    for _ in range(cfg.first_dense_layers)]
        tree["moe_blocks"] = [moe_block()
                              for _ in range(L - cfg.first_dense_layers)]
        if cfg.mtp_depth:
            tree["mtp"] = {"proj": init_linear(gen, 2 * d, d, dt),
                           "block": ffn_block(), "norm": zeros()}
    return tree


_CLASSES = {"dense": DenseLM, "localglobal": DenseLM, "encdec": EncDecLM,
            "vlm": VisionLM, "moe": MoeLM, "hybrid": HybridLM, "rwkv": RwkvLM}


def build_model(cfg: ModelConfig, tree: dict) -> _LM:
    """The family's module around a weight tree in the layout of
    :func:`_init_tree` (``repro_torch._bridge`` builds one from the
    reference's params)."""
    _check_family(cfg)
    return _CLASSES[cfg.family](cfg, tree)


# ================================================================ public API
def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: str | torch.device | None = None) -> _LM:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on the
    target device (``cuda`` unless asked otherwise; ``"meta"`` builds shapes
    only), with the reference's init scales. The numbers differ from
    ``jax.random``'s; parity tests bridge the reference's params instead
    (``repro_torch._bridge``)."""
    cfg.validate()
    _check_family(cfg)
    if str(device) == "meta":
        return build_model(cfg, _init_tree(cfg, None, torch.device("meta")))
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return build_model(cfg, _init_tree(cfg, gen, dev))


def _extras(cfg: ModelConfig, batch: dict) -> list[torch.Tensor]:
    key = _EXTRAS.get(cfg.family)
    return [] if key is None else [batch[key]]


def make_trainable(cfg: ModelConfig, model: _LM) -> _LM:
    """Let autograd record ``model``'s weights (in place; returns it)."""
    _check_family(cfg)
    return model.requires_grad_(True)


def loss_fn(cfg: ModelConfig, model: _LM, batch: dict):
    """Next-token cross entropy, the same in serving checks and in the
    train step (with grad, every layer is recomputed in the backward);
    the moe family adds its router aux and MTP terms, as the reference does.
    rwkv's pass starts from a zero state, as the reference's training
    pass."""
    if cfg.family == "moe":
        return model.loss(batch["tokens"], batch["labels"])
    loss = softmax_xent(model(batch["tokens"], *_extras(cfg, batch)),
                        batch["labels"])
    return loss, {"loss": loss}


def prefill(cfg: ModelConfig, model: _LM, batch: dict, max_seq: int):
    return model.prefill(batch["tokens"], max_seq, *_extras(cfg, batch))


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device: str | torch.device | None = None) -> dict:
    """Zeros in the family's decode-state layout (cross caches hold
    ``cfg.n_frames`` / ``cfg.n_patches`` rows, as the reference's; the
    recurrent states are f32 and have no sequence axis)."""
    _check_family(cfg)
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    dt = _dtype(cfg)

    def z(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    kv = (cfg.n_kv_heads, cfg.hd)
    state = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.family in DENSE_FAMILIES:
        state.update(k=z(cfg.n_layers, batch, max_seq, *kv),
                     v=z(cfg.n_layers, batch, max_seq, *kv))
    elif cfg.family == "encdec":
        F = cfg.n_frames
        state.update(k=z(cfg.n_layers, batch, max_seq, *kv),
                     v=z(cfg.n_layers, batch, max_seq, *kv),
                     xk=z(cfg.n_layers, batch, F, *kv),
                     xv=z(cfg.n_layers, batch, F, *kv))
    elif cfg.family == "vlm":
        G, S_per = _vlm_layout(cfg)
        P = cfg.n_patches
        state.update(k=z(G, S_per, batch, max_seq, *kv),
                     v=z(G, S_per, batch, max_seq, *kv),
                     xk=z(G, batch, P, *kv), xv=z(G, batch, P, *kv))
    elif cfg.family == "hybrid":
        G, tail = _hybrid_layout(cfg)

        def mamba_states(n):
            st = ssm_mod.mamba2_init_state(cfg, n * batch, device=dev)
            return {k: v.reshape(n, batch, *v.shape[1:]) for k, v in st.items()}

        state.update(groups=mamba_states(G * cfg.attn_every),
                     attn_k=z(G, batch, max_seq, *kv),
                     attn_v=z(G, batch, max_seq, *kv))
        if tail:
            state["tail"] = mamba_states(tail)
    elif cfg.family == "rwkv":
        H, K = rwkv_mod.rwkv_dims(cfg)
        L, d, f32 = cfg.n_layers, cfg.d_model, torch.float32
        state.update(tm_x=torch.zeros((L, batch, d), dtype=f32, device=dev),
                     cm_x=torch.zeros((L, batch, d), dtype=f32, device=dev),
                     wkv=torch.zeros((L, batch, H, K, K), dtype=f32,
                                     device=dev))
    else:
        def cache(n):
            if cfg.mla is not None:
                m = cfg.mla
                return (z(n, batch, max_seq, m.kv_lora_rank),
                        z(n, batch, max_seq, m.qk_rope_head_dim))
            return (z(n, batch, max_seq, *kv), z(n, batch, max_seq, *kv))

        if cfg.first_dense_layers:
            state["dense_cache"] = cache(cfg.first_dense_layers)
        state["moe_cache"] = cache(cfg.n_layers - cfg.first_dense_layers)
    return state


def decode_step(cfg: ModelConfig, model: _LM, state: dict,
                tokens: torch.Tensor):
    return model.decode_step(state, tokens)


def param_count(cfg: ModelConfig) -> int:
    """Parameter count from the shapes alone (built on the meta device,
    nothing is allocated)."""
    return sum(p.numel() for p in init_params(cfg, device="meta").parameters())
