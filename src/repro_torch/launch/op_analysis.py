"""What one step dispatches, counted op by op (the port's counterpart of
``repro.launch.hlo_analysis``).

The reference parses XLA's optimized HLO, recovers each while loop's trip
count and multiplies. Eager PyTorch has no HLO and no loop construct: every
op of a step is dispatched each time it runs, so :class:`OpCounter` (a
``TorchDispatchMode``) sees each one as it happens, on ``cuda``, ``cpu`` or
``meta`` tensors alike, and :func:`analyze` reports the reference's keys
where their meaning carries over:

  * ``dot_flops``        every matmul, bmm, einsum and convolution (the
                         formulas of ``torch.utils.flop_counter``: 2 per
                         multiply-add), plus the attention kernels' own work
                         (below);
  * ``collective_bytes`` result bytes by collective type, of the
                         ``_c10d_functional`` ops (``dist/collectives.py``,
                         DTensor's redistributions) and the ``c10d`` ones;
    ``collective_total``, ``collective_count``;
  * ``result_bytes``     the bytes of every op's outputs: in eager mode each
                         is written to memory. Views and uninitialised
                         allocations (``empty``) write nothing and are left
                         out (an ``empty`` storage still counts as held
                         memory); an in-place op counts the whole tensor it
                         updates, as the reference counts a
                         dynamic-update-slice's whole result.

On DTensors (the sharded step) every count is one device's: the counter
declines each DTensor-level op (its shapes are global) and counts the ops
DTensor then runs on this rank's local shards and the collectives of its
redistributions, leaving out the meta-tensor runs of its sharding
propagation; the kernel ops report their local calls (``kernels.ops``).

``n_while`` is dropped: there is no loop to multiply, each layer's ops are
counted as they run. :func:`top_dots` and :func:`top_collectives` group the
ops by where they come from (the parameter they read, with the layer index
replaced by ``*``, else the innermost function of the port on the stack) and
report the multiplicity as the number of times that group ran: the number of
layers for a layer's matmul.

Attention is counted as the kernels' work, the same on every device: K1
``2 * B * Hq * (hd + dv) * visible pairs`` (:func:`flash_work`), K2
``4 * Hq * hd * sum of live rows`` (:func:`decode_work`). While a counter is
entered, every call of ``kernels.ops.attention_op`` and
``decode_attention_op`` goes through it (``kernels.ops.observer``: the
counter is found on the dispatch mode stack, which autograd carries into a
CUDA backward's threads, so a recompute is counted too); it adds that work
and counts nothing of what the call runs inside (the plain version's masked
square on the CPU, which is twice the causal work). The plain chunked backward of K1 is real work on every device
and is counted op by op. A decode on ``meta`` tensors has no lengths to
read: the counter takes ``live_rows`` (each sequence's live rows, capped at
each cache's length) instead.

:func:`forward_flops` is the model FLOPs of one forward pass, for MFU.
"""

from __future__ import annotations

import os
import re
import sys
import weakref
from collections import defaultdict

import numpy as np
import torch
import torch.distributed.tensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops as kernel_ops

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_OPS = {
    "all-gather": ("all_gather_into_tensor", "all_gather_into_tensor_out",
                   "all_gather_into_tensor_coalesced", "allgather_",
                   "_allgather_base_", "allgather_into_tensor_coalesced_"),
    "all-reduce": ("all_reduce", "all_reduce_", "all_reduce_coalesced",
                   "all_reduce_coalesced_", "allreduce_",
                   "allreduce_coalesced_"),
    "reduce-scatter": ("reduce_scatter_tensor",
                       "reduce_scatter_tensor_coalesced", "reduce_scatter_",
                       "_reduce_scatter_base_"),
    "all-to-all": ("all_to_all_single", "alltoall_", "alltoall_base_"),
    "collective-permute": ("send", "recv_", "recv_any_source_"),
}
_COLLECTIVE_OF = {op: kind for kind, ops in _COLLECTIVE_OPS.items()
                  for op in ops}
_NO_WRITE = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided")
_LAYER_INDEX = re.compile(r"\.\d+(?=\.|$)")
_PORT = "repro_torch"
_SKIP = (__name__, kernel_ops.__name__)       # frames that group nothing


# ------------------------------------------------------- the kernels' work
def flash_work(case, itemsize: int, dv: int | None = None
               ) -> tuple[float, float]:
    """(operations, bytes) K1 needs for ``case`` = (B, Sq, Sk, Hq, Hkv, hd,
    causal, window, q_offset): 2 * (hd + dv) per visible (q, k) pair per
    q-head; q, k, v read once and o written once. ``dv`` is V's and the
    output's width (default hd)."""
    B, Sq, Sk, Hq, Hkv, hd, causal, window, off = case
    dv = hd if dv is None else dv
    qp = off + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Sk - 1, qp) if causal else np.full(Sq, Sk - 1, np.int64)
    lo = np.maximum(0, qp - window + 1) if window > 0 else 0
    pairs = int(np.maximum(0, hi - lo + 1).sum())
    ops = 2.0 * B * Hq * (hd + dv) * pairs
    nbytes = itemsize * (B * Sq * Hq * (hd + dv) + B * Sk * Hkv * (hd + dv))
    return ops, nbytes


def decode_work(case, lengths: list[int], itemsize: int
                ) -> tuple[float, float]:
    """(operations, bytes) K2 needs for ``case`` = (B, S, Hq, Hkv, hd,
    window) at these lengths: only the live rows of the cache are read
    (clamped to S, cut to the window)."""
    B, S, Hq, Hkv, hd, window = case
    live = [min(n, S) if window <= 0 else min(min(n, S), window)
            for n in lengths]
    ops = 4.0 * Hq * hd * sum(live)
    nbytes = itemsize * (2 * Hkv * hd * sum(live) + 2 * B * Hq * hd) \
        + 4 * B
    return ops, nbytes


# ------------------------------------------------------------ the counter
_DTensor = torch.distributed.tensor.DTensor
_PROPAGATION = os.path.join("tensor", "_sharding_prop.py")


def _propagating() -> bool:
    """Whether DTensor's sharding propagation is on the stack: it runs the
    op on meta tensors of the global shapes to learn the output's, which
    no device computes."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (what this rank holds), else ``t``."""
    return getattr(t, "_local_tensor", t)


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _shapes(args) -> tuple:
    return tuple(tuple(t.shape) for t in _tensors(args))


class OpCounter(TorchDispatchMode):
    """Counts a step's dispatched ops while entered (see the module's
    docstring). ``params`` (a module or ``{name: tensor}``) names the
    matmuls that read a parameter; ``live_rows`` stands in for the decode
    lengths of ``meta`` tensors. After the ``with`` block, :meth:`summary`
    gives the totals and the grouped rows; ``peak_live_bytes`` is the most
    bytes the ops' own outputs held at once (storages made inside the block,
    freed when the last tensor on them goes). The same allocations and
    frees, in their order, go through a model of the CUDA caching allocator
    (:mod:`launch.allocator`) that first holds ``held`` (the sizes of the
    step's arguments): its peaks are ``allocator_peak_bytes`` (the blocks,
    what ``torch.cuda.max_memory_allocated`` reads) and
    ``allocator_reserved_peak_bytes`` (the segments)."""

    def __init__(self, params=None, live_rows: int | None = None,
                 held=()) -> None:
        from repro_torch.launch.allocator import CachingAllocator
        super().__init__()
        if isinstance(params, torch.nn.Module):
            params = dict(params.named_parameters())
        self._param_of = {}
        for name, p in (params or {}).items():
            self._param_of[_local(p).untyped_storage()._cdata] = \
                _LAYER_INDEX.sub(".*", name)
        self.live_rows = live_rows
        self.dot_flops = 0.0
        self.collective_bytes = {c: 0.0 for c in COLLECTIVES}
        self.collective_count = 0
        self.result_bytes = 0.0
        self.n_ops = 0
        self.dots: dict = defaultdict(lambda: [0, 0.0])
        self.colls: dict = defaultdict(lambda: [0, 0.0])
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: dict[int, int] = {}
        self.allocator = CachingAllocator()
        for i, n in enumerate(held):
            self.allocator.malloc(("held", i), n)
        self._quiet = 0
        self._sharded = False

    # -- the kernel ops' observer (``kernels.ops.observer``)
    observe_kernel_ops = True

    def _kernel(self, label: str, op: str, shapes, ops: float, fn):
        """Adds a kernel's work and runs ``fn`` with nothing counted inside;
        the output is counted as the kernel writes it."""
        self.dot_flops += ops
        row = self.dots[(label, op, shapes)]
        row[0] += 1
        row[1] += ops
        self._quiet += 1
        try:
            out = fn()
        finally:
            self._quiet -= 1
        self.result_bytes += _nbytes(out)
        self._track(out)
        return out

    def flash(self, run, q, k, v, causal, window, q_offset):
        """``attention_op``'s call ``run``, counted as K1's work."""
        B, Sq, Hq, hd = q.shape
        Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
        ops, _ = flash_work((B, Sq, Sk, Hq, Hkv, hd, causal, window,
                             q_offset), q.element_size(), dv)
        return self._kernel(self._where(), "K1 flash_attention",
                            _shapes((q, k, v)), ops, run)

    def decode(self, run, q, k_cache, v_cache, lengths, window):
        """``decode_attention_op``'s call ``run``, counted as K2's work."""
        B, Hq, hd = q.shape
        S, Hkv = k_cache.shape[1], k_cache.shape[2]
        if lengths.device.type == "meta":
            if self.live_rows is None:
                raise ValueError("op_analysis: a decode on meta tensors "
                                 "needs live_rows")
            lens = [self.live_rows] * B
        else:
            lens = lengths.tolist()
        ops, _ = decode_work((B, S, Hq, Hkv, hd, window), lens,
                             q.element_size())
        return self._kernel(self._where(), "K2 decode_attention",
                            _shapes((q, k_cache, v_cache)), ops, run)

    # -- dispatch
    def _where(self, tensors=()) -> str:
        """The group of an op: the parameter one of its tensors reads (layer
        index as ``*``), else the innermost function of the port on the
        stack, else ``(autograd)``."""
        for t in tensors:
            name = self._param_of.get(_local(t).untyped_storage()._cdata)
            if name is not None:
                return name
        f = sys._getframe(1)
        while f is not None:
            mod = f.f_globals.get("__name__", "")
            if mod.startswith(_PORT) and mod not in _SKIP:
                return f"{mod.removeprefix(_PORT + '.')}:{f.f_code.co_name}"
            f = f.f_back
        return "(autograd)"

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = _local(t).untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
            self.allocator.malloc(key, n)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)
        self.allocator.free(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _DTensor in types:
            # DTensor runs its local ops (and the collectives of its
            # redistributions) on each rank's shards below: count those
            self._sharded = True
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet or (self._sharded and _propagating()):
            return out
        self.n_ops += 1
        packet = func._overloadpacket
        name = packet.__name__
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.dot_flops += flops
            row = self.dots[(self._where(_tensors((args, kwargs))), name,
                             _shapes(args))]
            row[0] += 1
            row[1] += flops
        kind = _COLLECTIVE_OF.get(name)
        ns = func.namespace
        if kind is not None and ns in ("_c10d_functional", "c10d"):
            b = sum(_nbytes(t) for t in _tensors(out))
            self.collective_bytes[kind] += b
            self.collective_count += 1
            row = self.colls[(self._where(), kind, _shapes(args))]
            row[0] += 1
            row[1] += b
        if name in _NO_WRITE:
            self._track(out)             # allocated, nothing written yet
            return out
        rets = func._schema.returns
        written = []
        for r, t in zip(rets, out if len(rets) > 1 else (out,)):
            alias = r.alias_info
            if alias is not None and not alias.is_write:
                continue                          # a view: nothing written
            written += _tensors(t)
            if alias is None:
                self._track(t)
        self.result_bytes += sum(_nbytes(t) for t in written)
        return out

    def summary(self) -> dict:
        return {"dot_flops": self.dot_flops,
                "collective_bytes": dict(self.collective_bytes),
                "collective_total": sum(self.collective_bytes.values()),
                "collective_count": self.collective_count,
                "result_bytes": self.result_bytes,
                "n_ops": self.n_ops,
                "peak_live_bytes": self.peak_live_bytes,
                "allocator_peak_bytes": self.allocator.peak_allocated,
                "allocator_reserved_peak_bytes":
                    self.allocator.peak_reserved,
                "dots": sorted(((fl, n, op, where, shapes) for
                                (where, op, shapes), (n, fl)
                                in self.dots.items()), reverse=True),
                "collectives": sorted(((b, n, kind, where, shapes) for
                                       (where, kind, shapes), (n, b)
                                       in self.colls.items()),
                                      reverse=True)}


def analyze(fn, *args, params=None, live_rows: int | None = None,
            held=(), **kwargs) -> dict:
    """``fn(*args, **kwargs)`` under an :class:`OpCounter`; its summary,
    with ``fn``'s result under ``"out"``."""
    counter = OpCounter(params=params, live_rows=live_rows, held=held)
    with counter:
        out = fn(*args, **kwargs)
    return dict(counter.summary(), out=out)


def top_dots(analysis: dict, n: int = 14) -> list[str]:
    """The n largest matmul groups (FLOPs over every run x runs)."""
    return [f"{fl / 1e12:10.4f} TF  x{k:5d}  {op:22s} {where} {list(shapes)}"
            for fl, k, op, where, shapes in analysis["dots"][:n]]


def top_collectives(analysis: dict, n: int = 12) -> list[str]:
    """The n largest collective groups (bytes over every run x runs)."""
    return [f"{b / 2**30:10.4f} GiB  x{k:5d}  {kind:16s} {where} "
            f"{list(shapes)}"
            for b, k, kind, where, shapes in analysis["collectives"][:n]]


# ------------------------------------------------------------ model FLOPs
def forward_flops(cfg, B: int, S: int) -> float:
    """Matmul FLOPs (2 per multiply-add) of one forward pass over B x S
    tokens: every projection on the tokens it is applied to (whisper's
    encoder on its frames, the cross K/V on the frames or patches), QK^T and
    PV over the pairs a mask lets through (MLA's PV at V's own 128 columns),
    the router and the experts each token is routed to (top-k routed plus
    the shared ones), the SSD's chunk products, the WKV state products, and
    the head."""
    from repro_torch.models import model as M
    from repro_torch.models import rwkv, ssm
    T, d, H, Hkv, hd = B * S, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def lin(t, i, o):
        return 2.0 * t * i * o

    def attn(sq, sk, causal, dqk=hd, dv=hd):
        pairs = sq * (sq + 1) / 2 if causal else sq * sk
        return 2.0 * B * H * (dqk + dv) * pairs

    def gqa(t, tk=None, tq_len=S, tk_len=None, causal=True):
        tk = t if tk is None else tk
        tk_len = tq_len if tk_len is None else tk_len
        return (lin(t, d, H * hd) + lin(t, H * hd, d) + 2 * lin(tk, d, Hkv * hd)
                + attn(tq_len, tk_len, causal))

    def mlp(t, ff, gated=True):
        return (3 if gated else 2) * lin(t, d, ff)

    head = lin(T, d, M.padded_vocab(cfg))
    fam = cfg.family
    if fam in ("dense", "localglobal"):
        return cfg.n_layers * (gqa(T) + mlp(T, cfg.d_ff)) + head
    if fam == "encdec":
        F, E = cfg.n_frames, cfg.encoder_layers
        enc = E * (gqa(B * F, tq_len=F, causal=False)
                   + mlp(B * F, cfg.d_ff, False))
        dec = cfg.n_layers * (gqa(T) + gqa(T, B * F, tk_len=F, causal=False)
                              + mlp(T, cfg.d_ff, False))
        return enc + dec + head
    if fam == "vlm":
        G, per = M._vlm_layout(cfg)
        P = cfg.n_patches
        return (G * per * (gqa(T) + mlp(T, cfg.d_ff))
                + G * (gqa(T, B * P, tk_len=P, causal=False)
                       + mlp(T, cfg.d_ff)) + head)
    if fam == "moe":
        m = cfg.mla
        if m is None:
            attn_f = gqa(T)
        else:
            attn_f = (lin(T, d, m.q_lora_rank)
                      + lin(T, m.q_lora_rank, H * m.qk_head_dim)
                      + lin(T, d, m.kv_lora_rank + m.qk_rope_head_dim)
                      + lin(T, m.kv_lora_rank,
                            H * (m.qk_nope_head_dim + m.v_head_dim))
                      + lin(T, H * m.v_head_dim, d)
                      + attn(S, S, True, m.qk_head_dim, m.v_head_dim))
        dense = attn_f + mlp(T, cfg.d_ff)
        routed = (lin(T, d, cfg.n_experts)
                  + 3 * lin(T * cfg.experts_per_token, d, cfg.moe_d_ff)
                  + 3 * lin(T, d, cfg.moe_d_ff * cfg.n_shared_experts)
                  + (mlp(T, cfg.d_ff) if cfg.dense_residual else 0.0))
        n_dense = cfg.first_dense_layers
        total = n_dense * dense + (cfg.n_layers - n_dense) * (attn_f + routed)
        if cfg.mtp_depth:
            total += lin(T, 2 * d, d) + dense + head
        return total + head
    if fam == "hybrid":
        d_in, Hs, P, N = ssm.ssm_dims(cfg)
        Q = min(ssm.CHUNK, S)
        nc = -(-S // Q)
        ssd = B * nc * (2.0 * Q * Q * N + 2.0 * Hs * Q * Q * P
                        + 4.0 * Q * Hs * P * N)
        mamba = lin(T, d, 2 * d_in + 2 * N + Hs) + lin(T, d_in, d) + ssd
        G = cfg.n_layers // cfg.attn_every
        return (cfg.n_layers * mamba + G * (gqa(T) + mlp(T, cfg.d_ff))
                + head)
    Hr, K = rwkv.rwkv_dims(cfg)                                 # rwkv
    tm = (lin(T, d, 5 * rwkv.TM_LORA) + 5 * lin(T, rwkv.TM_LORA, d)
          + lin(T, d, rwkv.W_LORA) + lin(T, rwkv.W_LORA, d) + 5 * lin(T, d, d)
          + 4.0 * T * Hr * K * K)
    cm = lin(T, d, cfg.d_ff) + lin(T, cfg.d_ff, d) + lin(T, d, d)
    return cfg.n_layers * (tm + cm) + head
