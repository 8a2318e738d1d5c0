"""Multi-pod dry run on the meta device: every (arch x shape x mesh) cell
through the port's real step (the counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell with XLA on 512 forced host
devices and records the compiler's memory and cost analyses. PyTorch has no
compiler to ask, so for each cell this module

  1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod) on a
     ``fake`` process group of 512 ranks (:func:`launch.mesh.init_fake_group`;
     nothing is communicated);
  2. builds the meta inputs (:mod:`launch.specs`) and their spec trees
     (:mod:`dist.sharding`: ``param_specs``, ``batch_specs``,
     ``decode_state_specs``) and records the argument and output bytes per
     device, exact, from each leaf's local shard shape (:func:`cell_bytes`);
  3. runs the cell's step (``make_train_step`` with the recipe's
     microbatches and ``grad_specs``, ``make_prefill_step``,
     ``make_serve_step``) on meta tensors under ``sharding_rules(mesh)``, at
     one data rank's batch: the batch dim's local shard as ``batch_specs``
     places it (an indivisible batch, such as ``long_500k``'s 1, is
     replicated), and records what it dispatched (:mod:`launch.op_analysis`:
     matmul FLOPs, collectives, result bytes) and the peak of the bytes its
     own tensors held at once.

Every family has a sharded step (``dist.sharding.SHARDED_FAMILIES``), so
the cell's step runs a second time as the reference compiles it: at the
global batch, its params sharded by ``shard_model``, the batch and decode
state placed by their spec trees, the activations DTensors redistributed
at every hint site (``tp_on_activations: true``); zamba2's chunked SSD and
rwkv's WKV scan run on each rank's local (meta) tensors, its batch rows and
heads. The counter sees one device's work there (rank 0 of the fake
group): ``dot_flops_per_device``, ``result_bytes_per_device``, the
collectives DTensor issues at their per-device bytes, and
``activation_peak_bytes``, the most bytes one device's own tensors held at
once. ``device_argument_bytes`` (what rank 0's inputs hold) equals
``argument_size_in_bytes``. ``fits_h100_80gb`` compares the argument bytes
per device plus that peak with 80 GiB; the peak counts storages, not the
blocks a card's caching allocator keeps (``fits_note``). With causal
attention sharded on query rows, rank 0 holds the first rows, the fewest
visible pairs.

Every cell also runs one data rank's whole step, unsharded: the model axis
splits nothing of its activations (the sharded MoE's experts are the
exception), and ``dot_flops_per_data_rank`` and
``result_bytes_per_data_rank`` count it (``profile_cell`` holds the card's
count to it). ``one_card_estimate_bytes`` is the data rank's whole step on
one card: its arguments and ``data_rank_activation_peak_bytes``, the
storages alive at once. The same step's allocations and frees, in order,
after its arguments, replayed through a model of the CUDA caching allocator
(:mod:`launch.allocator`: rounding, the small and large pools, block
splitting, freed blocks kept cached) give
``one_card_allocator_estimate_bytes`` (its blocks: what
``torch.cuda.max_memory_allocated`` reads) and
``one_card_reserved_estimate_bytes`` (its segments).

A decode step reads lengths from its state, which meta tensors do not hold:
a decode cell's sequences are taken as full (``live_rows`` = the cell's
sequence length, capped at each cache's rows) for the attention kernel's
work.

Importing this module sets no environment variable and starts no process
group: only :func:`main` and :func:`run_cell` do (the reference sets
``XLA_FLAGS`` at import).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k --mesh pod1
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable

import torch

from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, shapes_for
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.launch import specs as S
from repro_torch.train.optimizer import OptConfig

H100_BYTES = 80 * 2**30
FITS_NOTE = ("one device's activation peak (the sharded step); a card's "
             "caching allocator is not counted (PERF.md, section 6)")
MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
FAKE_WORLD = 512


def opt_config_for(cfg: ModelConfig) -> OptConfig:
    from repro_torch.models import param_count
    big = param_count(cfg) > 80e9
    return OptConfig(moment_dtype="bfloat16" if big else "float32")


def microbatches_for(cfg: ModelConfig, shape: InputShape
                     ) -> tuple[int, torch.dtype | None]:
    """Gradient-accumulation depth per train cell (memory-term control):
    activations scale with tokens-per-pass. Giant models also accumulate in
    bf16 (an f32 accumulator alone would be 2.7 TB for deepseek-v3)."""
    from repro_torch.models import param_count
    n = param_count(cfg)
    if shape.kind != "train":
        return 1, None
    if n > 80e9:
        return 8, torch.bfloat16
    if n > 20e9 or cfg.family == "hybrid":
        return 8, None
    if n > 8e9:
        return 4, None
    return 2, None


def cells(arch_filter=None, shape_filter=None, mesh_filter=None):
    for arch in ARCH_NAMES:
        if arch_filter and arch != arch_filter:
            continue
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            if shape_filter and shape.name != shape_filter:
                continue
            for mesh_kind in ("pod1", "pod2"):
                if mesh_filter and mesh_kind != mesh_filter:
                    continue
                yield arch, shape.name, mesh_kind


def abstract_mesh(mesh_kind: str) -> shd.AbstractMesh:
    return shd.AbstractMesh(*MESHES[mesh_kind])


# ------------------------------------------------------------------- bytes
def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, shd.P):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """A leaf's shard shape on one device: each dim divided by the product
    of the mesh axes its spec entry names (the rules only name axes that
    divide)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // shd.axis_size(mesh, e) for d, e in zip(shape, entries))


def spec_bytes(tree, specs, mesh, dtype: torch.dtype | None = None) -> int:
    """Bytes one device holds of a tree of (meta) tensors laid out by a
    matching spec tree; ``dtype`` overrides every leaf's."""
    total = 0
    for t, spec in zip(_leaves(tree), _leaves(specs)):
        n = 1
        for d in local_shape(t.shape, spec, mesh):
            n *= d
        total += n * (dtype or t.dtype).itemsize
    return total


def data_rank_batch(cfg: ModelConfig, shape: InputShape, mesh) -> int:
    """The batch one data rank runs: the global batch's local shard as
    ``batch_specs`` places it (replicated where the DP axes do not divide)."""
    tokens = torch.empty((shape.global_batch, 1), device="meta")
    spec = shd.batch_specs(cfg, {"tokens": tokens}, mesh)["tokens"]
    return local_shape(tokens.shape, spec, mesh)[0]


def logits_like(cfg: ModelConfig, B: int) -> torch.Tensor:
    """The (B, 1, padded vocab) logits a prefill or decode step returns."""
    from repro_torch.models import model as M
    return torch.empty((B, 1, M.padded_vocab(cfg)), dtype=getattr(
        torch, cfg.dtype), device="meta")


def cell_bytes(cfg: ModelConfig, shape: InputShape, mesh) -> dict[str, Any]:
    """Argument and output bytes per device of one cell, from the spec
    trees: params; AdamW's ``m`` / ``v`` in the recipe's moment dtype and
    its int32 step (train); the batch, or the decode state and the tokens.
    Outputs: the updated params and optimizer state (train; the metrics' few
    f32 scalars left out), or the logits (laid out as the batch) and the
    decode state."""
    inputs = S.input_specs(cfg, shape)
    p = inputs["params"]
    p_bytes = spec_bytes(p, shd.param_specs(cfg, p, mesh), mesh)
    args = {"params": p_bytes}
    if shape.kind == "train":
        moment = getattr(torch, opt_config_for(cfg).moment_dtype)
        m_bytes = spec_bytes(p, shd.param_specs(cfg, p, mesh), mesh, moment)
        args["opt_state"] = 2 * m_bytes + 4
        args["batch"] = spec_bytes(inputs["batch"], shd.batch_specs(
            cfg, inputs["batch"], mesh), mesh)
        outs = {"params": p_bytes, "opt_state": args["opt_state"]}
    else:
        if shape.kind == "prefill":
            args["batch"] = spec_bytes(inputs["batch"], shd.batch_specs(
                cfg, inputs["batch"], mesh), mesh)
            state = S.decode_specs_for(cfg, shape)[0]
        else:
            state = inputs["state"]
            args["state"] = spec_bytes(state, shd.decode_state_specs(
                cfg, state, mesh), mesh)
            args["tokens"] = spec_bytes(inputs["tokens"], shd.batch_specs(
                cfg, inputs["tokens"], mesh), mesh)
        logits = logits_like(cfg, shape.global_batch)
        outs = {"logits": spec_bytes(logits, shd.batch_specs(
                    cfg, logits, mesh), mesh),
                "state": spec_bytes(state, shd.decode_state_specs(
                    cfg, state, mesh), mesh)}
    return {"argument_bytes": args,
            "argument_size_in_bytes": sum(args.values()),
            "output_bytes": outs,
            "output_size_in_bytes": sum(outs.values())}


# -------------------------------------------------------------- the step
@dataclasses.dataclass
class CellStep:
    """One cell's step, ready to call: ``run()`` makes one call; ``model``
    holds the weights; ``argument_bytes`` is what the step's inputs hold on
    this device (weights, optimizer state, batch or decode state), and
    ``argument_sizes`` each input tensor's bytes in the order they were
    made; ``live_rows`` is the decode lengths' stand-in for the op counter
    (None unless a decode)."""

    run: Callable[[], Any]
    model: torch.nn.Module
    argument_bytes: int
    live_rows: int | None = None
    argument_sizes: tuple[int, ...] = ()


def cell_step(cfg: ModelConfig, shape: InputShape, B: int, *, mesh=None,
              device: str | torch.device = "meta", seed: int = 0,
              microbatches: int | None = None,
              sharded: bool = False) -> CellStep:
    """The cell's step at a batch of ``B`` on ``device`` (meta: shapes only;
    else random weights from ``seed`` and seeded inputs). The train step
    takes the recipe's microbatches (or ``microbatches``) and, on a
    ``mesh``, ``grad_specs``; the decode step runs at position S - 1 of
    every sequence (the caches full, seeded), each call from the same
    state. ``sharded`` (with a ``mesh``) runs the sharded step: ``B`` is
    the global batch, the model is ``shard_model``'s, the inputs DTensors
    placed by their spec trees, and ``argument_bytes`` counts this rank's
    shards."""
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import (make_prefill_step,
                                              make_serve_step,
                                              make_train_step)
    dev = torch.device(device)
    model = M.init_params(cfg, seed, device=dev)
    if sharded:
        model = shd.shard_model(cfg, model, mesh)
    Sq = shape.seq_len
    gen = None if dev.type == "meta" else torch.Generator(device=dev)
    if gen is not None:
        gen.manual_seed(seed)

    def tokens(rows, cols):
        if gen is None:
            return torch.empty((rows, cols), dtype=torch.int32, device=dev)
        return torch.randint(0, cfg.vocab, (rows, cols), generator=gen,
                             device=dev, dtype=torch.int32)

    def batch():
        b = {"tokens": tokens(B, Sq), "labels": tokens(B, Sq)}
        key = M._EXTRAS.get(cfg.family)
        if key is not None:
            n = cfg.n_frames if key == "frames" else cfg.n_patches
            b[key] = torch.empty((B, n, cfg.d_model), dtype=M._dtype(cfg),
                                 device=dev)
            if gen is not None:
                b[key].normal_(generator=gen)
        return b

    def place(b):
        return shd.shard_batch(cfg, b, mesh) if sharded else b

    if shape.kind == "train":
        mb, acc = microbatches_for(cfg, shape)
        mb = microbatches or mb
        oc = opt_config_for(cfg)
        model = M.make_trainable(cfg, model)
        opt = {"state": init_opt_state(oc, dict(model.named_parameters()))}
        grad_specs = None if mesh is None or sharded else \
            shd.named_param_specs(cfg, mesh)
        step = make_train_step(cfg, oc, microbatches=mb, accum_dtype=acc,
                               grad_specs=grad_specs)
        data = place(batch())

        def run():
            _, opt["state"], metrics = step(model, opt["state"], data)
            return metrics
        held, sizes = _held(model, opt["state"], data)
        return CellStep(run, model, held, argument_sizes=sizes)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, Sq)
        data = place(batch())
        held, sizes = _held(model, data)
        return CellStep(lambda: step(model, data), model, held,
                        argument_sizes=sizes)
    step = make_serve_step(cfg)
    state = M.init_decode_state(cfg, B, Sq, device=dev)
    state["pos"].fill_(Sq - 1)
    if gen is not None:
        for t in _leaves(state):
            if t.is_floating_point():
                t.normal_(generator=gen)
    tok = tokens(B, 1)
    if sharded:
        state = shd.shard_state(cfg, state, mesh)
        tok = place({"tokens": tok})["tokens"]
    held, sizes = _held(model, state, tok)
    return CellStep(lambda: step(model, state, tok), model, held, Sq, sizes)


def _held(model: torch.nn.Module, *trees) -> tuple[int, tuple[int, ...]]:
    """Bytes of the model's weights and of the tensors in ``trees`` (a
    DTensor's: this rank's shard), and each tensor's, in the order they
    were made (weights, then the trees)."""
    def nbytes(t):
        t = getattr(t, "_local_tensor", t)
        return t.numel() * t.element_size()
    sizes = tuple(nbytes(p) for p in model.parameters()) + tuple(
        nbytes(t) for t in _leaves(list(trees)) if isinstance(t, torch.Tensor))
    return sum(sizes), sizes


def _record(rec: dict, a: dict) -> None:
    """The collectives, the activation peak and the fit of the sharded step
    whose count (one device's) is ``a``."""
    rec["collectives"] = a["collective_bytes"]
    rec["collective_total"] = a["collective_total"]
    rec["collective_count"] = a["collective_count"]
    rec["activation_peak_bytes"] = a["peak_live_bytes"]
    rec["fits_h100_80gb"] = rec["argument_size_in_bytes"] \
        + a["peak_live_bytes"] <= H100_BYTES
    rec["fits_note"] = FITS_NOTE


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             collect_ops: bool = True) -> dict[str, Any]:
    """One cell's record (see the module's docstring). Starts a fake
    process group of FAKE_WORLD ranks when none is running, and destroys
    it again at the end."""
    import torch.distributed as dist

    from repro_torch.dist.hints import sharding_rules
    from repro_torch.launch import op_analysis
    from repro_torch.launch.mesh import init_fake_group, make_production_mesh
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "kind": None, "ok": False}
    t0 = time.time()
    started = not dist.is_initialized()
    try:
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        rec["kind"] = shape.kind
        rec["tp_on_activations"] = True          # every family shards
        if started:
            init_fake_group(FAKE_WORLD)
        mesh = make_production_mesh(multi_pod=(mesh_kind == "pod2"))
        rec["n_devices"] = mesh.size()
        rec["microbatches"] = microbatches_for(cfg, shape)[0]
        rec.update(cell_bytes(cfg, shape, mesh))
        B = data_rank_batch(cfg, shape, mesh)
        rec["batch_per_data_rank"] = B
        with sharding_rules(mesh):
            cell = cell_step(cfg, shape, B, mesh=mesh)
            rec["data_rank_argument_bytes"] = cell.argument_bytes
            if cell.live_rows is not None:
                rec["live_rows"] = cell.live_rows
            if collect_ops:
                a = op_analysis.analyze(cell.run, params=cell.model,
                                        live_rows=cell.live_rows,
                                        held=cell.argument_sizes)
                rec["dot_flops_per_data_rank"] = a["dot_flops"]
                rec["result_bytes_per_data_rank"] = a["result_bytes"]
                rec["n_ops"] = a["n_ops"]
                rec["data_rank_activation_peak_bytes"] = a["peak_live_bytes"]
                # one card running the data rank's whole step (profile_cell):
                # its storages, and the caching allocator's blocks and
                # segments replaying the same allocations
                rec["one_card_estimate_bytes"] = cell.argument_bytes \
                    + a["peak_live_bytes"]
                rec["one_card_allocator_estimate_bytes"] = \
                    a["allocator_peak_bytes"]
                rec["one_card_reserved_estimate_bytes"] = \
                    a["allocator_reserved_peak_bytes"]
            else:
                cell.run()
            del cell
            cell = cell_step(cfg, shape, shape.global_batch, mesh=mesh,
                             sharded=True)
            rec["device_argument_bytes"] = cell.argument_bytes
            if collect_ops:
                a = op_analysis.analyze(cell.run, params=cell.model,
                                        live_rows=cell.live_rows)
                rec["dot_flops_per_device"] = a["dot_flops"]
                rec["result_bytes_per_device"] = a["result_bytes"]
                _record(rec, a)
            else:
                cell.run()
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — recorded, cell marked failed
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    rec["seconds"] = round(time.time() - t0, 1)
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("pod1", "pod2"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already present & ok in --out")
    ap.add_argument("--no-ops", action="store_true",
                    help="run the steps without counting their ops (faster)")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done: set[tuple] = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["mesh"]))

    todo = list(cells(args.arch, args.shape, args.mesh))
    print(f"dry-run: {len(todo)} cells -> {args.out}", flush=True)
    n_ok = n_fail = 0
    with open(args.out, "a") as f:
        for arch, shape, mesh_kind in todo:
            if (arch, shape, mesh_kind) in done:
                continue
            rec = run_cell(arch, shape, mesh_kind,
                           collect_ops=not args.no_ops)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            status = "OK " if rec["ok"] else "FAIL"
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
            print(f"[{status}] {arch:22s} {shape:12s} {mesh_kind} "
                  f"({rec['seconds']}s) "
                  f"{rec.get('error', '')}", flush=True)
    print(f"done: {n_ok} ok, {n_fail} failed", flush=True)


if __name__ == "__main__":
    main()
