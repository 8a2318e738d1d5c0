"""Mixture-of-Experts layer — capacity-based token-choice dispatch, the port
of ``repro.models.moe``: its global path and its sharded path.

Covers both MoE architectures:
  * deepseek-v3-671b: 1 shared expert + 256 routed, top-8, softmax router
    with renormalized top-k weights, first 3 layers dense;
  * arctic-480b: 128 routed top-2 + a *dense residual* FFN in parallel.

Dispatch is the GShard/Switch capacity scheme as the reference spells it:
top-k per token, position within its expert from a stable sort of the flat
expert ids, a capacity drop, scatter-add into ``(E * C, d)``, three expert
products, then gather back and weight. Under ``dist.hints.sharding_rules``
with a DeviceMesh, :func:`moe_ffn` takes :func:`_moe_ffn_sharded`, the
reference's shard_map path: each rank dispatches its own tokens to its own
experts with a per-shard capacity, gathers its experts' FSDP shards over
"data" and sums the experts' outputs over "model"; unmeshed, the global
path runs, as in the reference.

On DTensor activations (the sharded step) :func:`_moe_ffn_dtensor` runs the
same per-rank body on each rank's local tokens and expert shards, and the
shared expert on DTensors around it.

Semantics kept from JAX: ``jax.lax.top_k`` puts the lower index first among
equal probabilities — a stable descending sort does the same; the drop sink
``E * C - 1`` takes added zeros (``index_add_``, not a copy that would
overwrite the token parked there); a gather past the buffer clamps, as a JAX
gather does (its weight is zero either way). The router runs in f32.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as coll
from repro_torch.dist import hints as hint_rules
from repro_torch.dist import sharding as shd
from repro_torch.dist.hints import hint
from repro_torch.models.layers import init_linear, uniform_scale_init


def init_moe(gen: torch.Generator | None, cfg: ModelConfig, dtype,
             n_layers: int = 1) -> dict:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    out_scale = 1.0 / ff ** 0.5 / (2.0 * n_layers) ** 0.5
    p = {"router": init_linear(gen, d, E, torch.float32),   # router in f32
         "w1": uniform_scale_init(gen, (E, d, ff), dtype, 0.02),
         "w3": uniform_scale_init(gen, (E, d, ff), dtype, 0.02),
         "w2": uniform_scale_init(gen, (E, ff, d), dtype, out_scale)}
    if cfg.n_shared_experts:
        ff_s = ff * cfg.n_shared_experts
        p["shared"] = {"w1": init_linear(gen, d, ff_s, dtype),
                       "w3": init_linear(gen, d, ff_s, dtype),
                       "w2": init_linear(gen, ff_s, d, dtype, scale=out_scale)}
    return p


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(math.ceil(cfg.capacity_factor * n_tokens * cfg.experts_per_token
                      / cfg.n_experts))
    return max(8, int(math.ceil(c / 8)) * 8)


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), router aux loss scalar f32).

    Under an active mesh (``dist.hints.sharding_rules`` with a DeviceMesh)
    the routed experts run through :func:`_moe_ffn_sharded`; the global path
    below runs unmeshed and is the oracle of the tests."""
    r = hint_rules.get_rules()
    if isinstance(x, DTensor):
        return _moe_ffn_dtensor(cfg, p, x, r)
    # the reference's other condition, tokens divisible over DP, holds by
    # construction: ``x`` is already one DP shard
    if r is not None and r.get("mesh") is not None \
            and not isinstance(r["mesh"], shd.AbstractMesh) \
            and cfg.n_experts % (r["tp_size"] if r["tp"] else 1) == 0:
        xt = x.reshape(-1, x.shape[-1])
        out, aux = _moe_ffn_sharded(cfg, p, xt, r)
        if r["dp"] and r["dp_size"] > 1:
            aux = coll.MeanOverRanks.apply(
                aux, [r["mesh"].get_group(a) for a in r["dp"]], r["dp_size"])
        if "shared" in p:
            out = out + _shared(p["shared"], xt)
        return out.reshape(x.shape), aux
    return _moe_ffn_global(cfg, p, x)


def _route(cfg: ModelConfig, p, xt: torch.Tensor):
    """The router of both paths, for tokens ``xt`` (T, d): renormalised
    top-k weights ``topw`` (T, k), flat expert ids ``e_flat`` (T*k,), each
    assignment's position inside its expert ``pos_flat`` (T*k,), and the
    load-balancing aux loss (Switch: E * sum_e f_e * P_e), all in f32."""
    T = xt.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token
    logits = xt.float() @ p["router"].float()                  # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :k], topi[:, :k]                      # (T, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, slot) inside its expert: one stable sort over
    # the T*k flat assignments, positions from the segment starts
    e_flat = topi.reshape(-1)                                  # (T*k,)
    order = torch.argsort(e_flat, stable=True)
    # bincount's length depends on the data (no meta kernel): count into E
    counts = torch.zeros(E, dtype=e_flat.dtype,
                         device=xt.device).index_add_(0, e_flat,
                                                      torch.ones_like(e_flat))
    seg_start = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(T * k, device=xt.device) - seg_start[e_flat[order]]
    pos_flat = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)

    frac = counts.float() / max(T * k, 1)
    aux = E * torch.sum(frac * probs.mean(0)) * cfg.router_aux_weight
    return topw, e_flat, pos_flat, aux


def _moe_ffn_global(cfg: ModelConfig, p, x: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.experts_per_token
    C = _capacity(cfg, T)
    xt = x.reshape(T, d)
    topw, e_flat, pos_flat, aux = _route(cfg, p, xt)
    keep = pos_flat < C                                        # capacity drop

    # scatter tokens -> (E*C, d); dropped rows add zeros into the sink
    flat_idx = e_flat * C + pos_flat                           # (T*k,)
    src = torch.repeat_interleave(xt, k, dim=0) * keep[:, None].to(x.dtype)
    disp = torch.zeros((E * C, d), dtype=x.dtype, device=x.device)
    disp.index_add_(0, torch.where(keep, flat_idx, E * C - 1),
                    torch.where(keep[:, None], src, torch.zeros_like(src)))
    disp = hint(disp.reshape(E, C, d), "tp", "dp", None)  # EP + capacity on dp

    # expert FFN, batched over experts
    h = hint(torch.bmm(disp, p["w1"]), "tp", "dp", None)
    g = hint(torch.bmm(disp, p["w3"]), "tp", "dp", None)
    y = hint(torch.bmm(F.silu(h) * g, p["w2"]), "tp", "dp", None)

    # gather back with the routing weights (dropped slots weigh zero)
    picked = hint(y.reshape(E * C, d)[flat_idx.clamp(max=E * C - 1)],
                  "dp", None)                                  # (T*k, d)
    w = (topw.reshape(-1) * keep).to(x.dtype)
    out = hint((picked * w[:, None]).reshape(T, k, d).sum(dim=1), "dp", None)

    if "shared" in p:
        out = out + _shared(p["shared"], xt)
    return out.reshape(B, S, d), aux


def _shared(sp, xt):
    return (F.silu(xt @ sp["w1"]) * (xt @ sp["w3"])) @ sp["w2"]


# ------------------------------------------------------------- sharded path
def _expert_shard(w, mesh, spec) -> torch.Tensor:
    """This rank's block of an expert weight: a DTensor's local tensor, or
    the in_spec's block of a whole tensor (autograd flows into it)."""
    from torch.distributed.tensor import DTensor
    if isinstance(w, DTensor):
        return w.to_local()
    return shd.local_block(w, mesh, spec)


def _moe_ffn_sharded(cfg: ModelConfig, p, xt: torch.Tensor, rules: dict
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Routed experts per mesh shard — the reference's shard_map path.

    ``xt`` (T, d) is this rank's share of the tokens (its DP shard), the same on
    every model rank; each rank routes its tokens, dispatches only to its
    own expert range ``[rank * E_loc, (rank + 1) * E_loc)`` with the
    per-shard capacity ``C_loc`` (the rest go to an overflow slot), gathers
    its experts' FSDP shards over "data" (in_specs ``(tp, None, "data")`` /
    ``(tp, "data", None)``), runs three ``bmm``s, and sums the experts'
    outputs over "model". Returns the routed experts' output and this
    rank's aux loss: the caller adds the shared expert and reduces the aux
    over the DP axes. ``E`` must divide over "model".

    Gradients are those of the reference's single loss: the model-axis sum
    passes its cotangent through and the routing weights and dispatched
    tokens collect every model rank's contribution, so every rank holds the
    whole gradient of its replicated values and of its own expert shard;
    over DP each rank's gradient is its tokens' share."""
    mesh = rules["mesh"]
    dp_axes = rules["dp"] or ()
    tp = rules["tp"]
    E, k = cfg.n_experts, cfg.experts_per_token
    tp_size = rules["tp_size"] if tp else 1
    Tl, d = xt.shape
    C_loc = _capacity(cfg, Tl)
    E_loc = E // tp_size
    # a collective over one rank is the identity: skip it
    model_group = mesh.get_group(tp) if tp_size > 1 else None
    topw, e_flat, pos_flat, aux = _route(cfg, p, xt)

    # this model rank dispatches only its expert range
    rank = mesh.get_local_rank(tp) if tp else 0
    lo = rank * E_loc
    keep = (e_flat >= lo) & (e_flat < lo + E_loc) & (pos_flat < C_loc)
    slot = torch.where(keep, (e_flat - lo) * C_loc + pos_flat,
                       E_loc * C_loc)                          # overflow slot
    if model_group is not None:
        xd = coll.FromModel.apply(xt, model_group)
        topw = coll.FromModel.apply(topw, model_group)
    else:
        xd = xt
    src = torch.repeat_interleave(xd, k, dim=0) * keep[:, None].to(xt.dtype)
    disp = torch.zeros((E_loc * C_loc + 1, d), dtype=xt.dtype,
                       device=xt.device).index_add(0, slot, src)
    disp = disp[:-1].reshape(E_loc, C_loc, d)

    # FSDP gather of the local experts' weights (its gradient: a
    # reduce-scatter). Over one data rank the shard is the whole weight and
    # is used as it is: the experts are the layer's largest tensors (22.6 GB
    # in bf16 for one deepseek-v3 layer), and a gathered copy of each would
    # not fit beside them
    w1 = _expert_shard(p["w1"], mesh, shd.P(tp, None, "data"))
    w3 = _expert_shard(p["w3"], mesh, shd.P(tp, None, "data"))
    w2 = _expert_shard(p["w2"], mesh, shd.P(tp, "data", None))
    data_group = mesh.get_group("data") if dp_axes else None
    if data_group is not None and dist.get_world_size(data_group) > 1:
        w1 = coll.GatherData.apply(w1, 2, data_group)
        w3 = coll.GatherData.apply(w3, 2, data_group)
        w2 = coll.GatherData.apply(w2, 1, data_group)
    h = torch.bmm(disp, w1)
    g = torch.bmm(disp, w3)
    y = torch.bmm(F.silu(h) * g, w2)

    yf = torch.cat([y.reshape(E_loc * C_loc, d),
                    torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    picked = yf[slot]                                          # (Tl*k, d)
    w = (topw.reshape(-1) * keep).to(xt.dtype)
    part = (picked * w[:, None]).reshape(Tl, k, d).sum(dim=1)
    out = coll.SumToModel.apply(part, model_group) if model_group is not None \
        else part                                              # combine experts
    return out, aux


def _moe_ffn_dtensor(cfg: ModelConfig, p, x, rules: dict
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_moe_ffn_sharded` on DTensors: ``x`` is redistributed to its
    tokens over the DP axes (replicated over "model"), the per-rank body
    runs on the local tokens, the replicated router and the local expert
    shards, and its output and aux come back as DTensors (the tokens over
    DP; aux replicated). The loss is one replicated value, so the aux mean
    over DP passes each rank its cotangent over the DP size. The shared
    expert runs on DTensors of the local tokens, its output replicated
    over "model". Raises where the experts do not divide over "model" or
    the batch over the DP axes (no global fallback)."""
    from torch.distributed.tensor import Partial, Replicate
    if rules is None or rules.get("mesh") != x.device_mesh:
        raise RuntimeError("moe_ffn: DTensor activations need "
                           "sharding_rules on their mesh")
    mesh = x.device_mesh
    B, S, d = x.shape
    if cfg.n_experts % rules["tp_size"] or B % max(rules["dp_size"], 1):
        raise NotImplementedError(
            f"moe_ffn: {cfg.n_experts} experts over {rules['tp_size']} model "
            f"ranks, batch {B} over {rules['dp_size']} data ranks")
    dp = rules["dp"] or ()
    spec = shd.P(dp if len(dp) > 1 else (dp[0] if dp else None), None, None)
    x = x.redistribute(mesh, shd.placements(mesh, spec))
    router = p["router"].redistribute(mesh, [Replicate()] * mesh.ndim) \
        .to_local(grad_placements=[Partial() if a in dp else Replicate()
                                   for a in mesh.mesh_dim_names])
    tp = rules["tp"]
    routed = {"router": router}
    for k, spec in (("w1", shd.P(tp, None, "data")),
                    ("w3", shd.P(tp, None, "data")),
                    ("w2", shd.P(tp, "data", None))):
        routed[k] = p[k].redistribute(mesh, shd.placements(mesh, spec))
    pl = x.placements
    xt = x.to_local().reshape(-1, d)
    out, aux = _moe_ffn_sharded(cfg, routed, xt, rules)
    if dp and rules["dp_size"] > 1:   # one replicated loss: its cotangent
        for a in dp:                  # reaches each rank once
            aux = coll.SumToModel.apply(aux, mesh.get_group(a))
        aux = aux / rules["dp_size"]
    if "shared" in p:                 # on DTensors of the local tokens
        xd = DTensor.from_local(xt, mesh, pl, run_check=False,
                                shape=(B * S, d), stride=(d, 1))
        out = out + _shared(p["shared"], xd).redistribute(mesh, pl) \
            .to_local()
    out = DTensor.from_local(out.reshape(x.to_local().shape), mesh, pl,
                             run_check=False, shape=x.shape,
                             stride=x.stride())
    aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return out, aux
