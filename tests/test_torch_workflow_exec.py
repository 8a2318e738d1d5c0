"""The port's workflow executor and its device path: the reference's
executor tests with torch bodies, the prefetch engine's staged device copies,
the refusal to carry on after a failed copy, and a training epoch run as a
workflow, held to the port's ``train()`` and, on the smoke model in f32, to
the reference's train step run as the same workflow through the reference's
executor.

``chip_smoke.py``'s workflow phases run the same graphs and bodies on the
card (the quickstart's from ``repro_torch.examples.quickstart``, the epoch's
from ``chip_smoke.py``; the CPU run here rehearses them). Tests marked
``gpu`` decide inside a fixture whether there is a card and skip here.
"""

import dataclasses
import importlib.util
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.configs import get_smoke as jax_smoke
from repro.data.pipeline import SyntheticCorpus as JaxCorpus
from repro.data.pipeline import epoch_workflow as r_epoch
from repro.models import init_params as jax_init_params
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch import core as T
from repro_torch._bridge import from_reference
from repro_torch.configs import get_smoke
from repro_torch.core.prefetch import PrefetchEngine
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.data.pipeline import epoch_workflow as t_epoch
from repro_torch.examples import quickstart as QS
from repro_torch.models import make_trainable
from repro_torch.train.loop import TrainConfig, train
from repro_torch.train.optimizer import OptConfig, init_opt_state

STEP_TOL = 2e-5      # f32 step parity with the reference (test_torch_train)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# -------------------------------------------- the reference's executor tests
def pipeline_graph(P, square, total):
    g = P.TaskGraph()
    g.add_data("x", size_bytes=P.size_hint(4 * 400))
    g.add_task("square", inputs=("x",), outputs=("x2",), fn=square,
               hints=P.task(io_ratio=1.0))
    g.add_task("sum", inputs=("x2",), outputs=("total",), fn=total,
               hints=P.task(io_ratio=0.01))
    return g


def torch_pipeline():
    return pipeline_graph(T, lambda x: {"x2": x * x},
                          lambda x2: {"total": float(torch.sum(x2))})


def test_executor_computes_correct_result():
    x = np.arange(400, dtype=np.float32)
    wf = T.compile_workflow(torch_pipeline())
    ex = T.WorkflowExecutor(wf, T.LocalityScheduler(wf), n_nodes=2,
                            inject_inputs={"x": torch.from_numpy(x)})
    res = ex.run()
    assert res.outputs["total"] == float(np.sum(x ** 2))
    assert res.wall_seconds > 0
    rwf = R.compile_workflow(pipeline_graph(
        R, lambda x: {"x2": x * x},
        lambda x2: {"total": float(np.sum(x2))}))
    ref = R.WorkflowExecutor(rwf, R.LocalityScheduler(rwf), n_nodes=2,
                             inject_inputs={"x": x}).run()
    assert res.outputs == ref.outputs
    assert {t: r["node"] for t, r in res.task_records.items()} == \
        {t: r["node"] for t, r in ref.task_records.items()}


def fanout_graph(P):
    g = P.TaskGraph()
    g.add_data("seed", size_bytes=P.size_hint(8))
    for i in range(6):
        g.add_task(f"work{i}", inputs=("seed",), outputs=(f"out{i}",),
                   fn=lambda seed, i=i: {f"out{i}": seed + i})
    g.add_task("gather", inputs=tuple(f"out{i}" for i in range(6)),
               outputs=("final",),
               fn=lambda **kw: {"final": sum(kw.values())})
    return g


def test_executor_parallel_fanout():
    wf = T.compile_workflow(fanout_graph(T))
    ex = T.WorkflowExecutor(wf, T.ProactiveScheduler(wf), n_nodes=3,
                            inject_inputs={"seed": torch.tensor(10)})
    res = ex.run()
    assert int(res.outputs["final"]) == sum(10 + i for i in range(6))
    assert len(res.task_records) == 7
    rwf = R.compile_workflow(fanout_graph(R))
    ref = R.WorkflowExecutor(rwf, R.ProactiveScheduler(rwf), n_nodes=3,
                             inject_inputs={"seed": 10}).run()
    assert int(res.outputs["final"]) == ref.outputs["final"]


def test_executor_feeds_back_placement_to_store():
    """Outputs land where the producer ran (the paper's feedback loop)."""
    wf = T.compile_workflow(torch_pipeline())
    ex = T.WorkflowExecutor(wf, T.LocalityScheduler(wf), n_nodes=2,
                            inject_inputs={"x": torch.ones(400)})
    res = ex.run()
    assert ex.store.stat("x2").real_loc == res.task_records["square"]["node"]


def test_executor_torch_bodies():
    g = T.TaskGraph()
    g.add_data("a", size_bytes=T.size_hint(1024))
    g.add_task("mm", inputs=("a",), outputs=("b",),
               fn=lambda a: {"b": a @ a.T})
    wf = T.compile_workflow(g)
    ex = T.WorkflowExecutor(wf, T.LocalityScheduler(wf), n_nodes=2,
                            device_of=lambda node: CPU,
                            inject_inputs={"a": torch.eye(16)})
    res = ex.run()
    assert torch.equal(res.outputs["b"], torch.eye(16))


def test_quickstart_graph_with_torch_bodies_matches_numpy():
    """The card phase's graph and bodies on the CPU: the same ``out`` as
    the quickstart's numpy bodies, every task run, the split's outputs at
    the node that ran it."""
    rng = np.random.default_rng(0)
    raw = rng.standard_normal(1 << 16).astype(np.float32)
    ex, res = QS.run_quickstart(torch.from_numpy(raw), CPU,
                                lambda node: CPU)
    half = raw.size // 2
    want = float(np.abs(np.fft.rfft(raw[:half]).real.astype(np.float32)).sum()
                 + np.abs(np.fft.rfft(raw[half:]).real.astype(np.float32))
                 .sum())
    assert res.outputs["out"] == pytest.approx(want, rel=CS.QUICKSTART_RTOL)
    assert sorted(res.task_records) == ["fft_a", "fft_b", "merge", "split"]
    node = res.task_records["split"]["node"]
    assert ex.store.stat("a").real_loc == ex.store.stat("b").real_loc == node
    graph = QS.quickstart_workflow().graph
    assert graph.data["raw"].size_bytes == QS.RAW_BYTES


# ----------------------------------------------------------- the device path
def test_prefetch_stages_to_the_device_and_counts_hits():
    """An "hbm" prefetch with a device map makes a device copy of every
    tensor; a lower tier makes none; the consumer's take is counted."""
    store = T.LocStore(2, hierarchy=T.tiered_hierarchy())
    store.put("x", {"t": torch.arange(6.0), "n": 3}, loc=0)
    pf = PrefetchEngine(store, device_of=lambda node: CPU)
    pf.submit("x", 1, tier="hbm").result(timeout=10)
    copy = pf.device_copy("x", 1)
    assert torch.equal(copy["t"], torch.arange(6.0)) and copy["n"] == 3
    assert pf.device_hits == 1 and pf.report()["device_hits"] == 1.0
    pf.submit("x", 0, tier="bb").result(timeout=10)
    assert pf.device_copy("x", 0) is None and pf.device_hits == 1
    assert pf.bytes_prefetched > 0
    pf.shutdown()


def test_failed_device_copy_fails_the_task_and_the_run():
    """No fallback: a stage whose device map raises fails the consumer's
    input fetch (or, if the consumer runs elsewhere, the run's final
    drain), and the run re-raises it instead of waiting forever or
    carrying on with the host copy.

    The schedule is forced: p1 runs until a prefetch was submitted, so
    when p0 finishes, p2 takes its node and the proactive pass pre-assigns
    ``join`` to p1's node (its larger input's) and prefetches p0's output
    there."""
    def broken(node):
        raise RuntimeError("device map failed")

    def p1(x):
        deadline = time.monotonic() + 20
        while ex.prefetch.submitted == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        return {"b": x + 2}

    g = T.TaskGraph()
    g.add_data("x", size_bytes=T.size_hint(4 * 400))
    g.add_task("p0", inputs=("x",), outputs=("a",),
               fn=lambda x: {"a": x + 1})
    g.add_task("p1", inputs=("x",), outputs=("b",), fn=p1,
               hints=T.task(io_ratio=10.0))
    g.add_task("p2", inputs=("x",), outputs=("d",),
               fn=lambda x: {"d": x + 3})
    g.add_task("join", inputs=("a", "b"), outputs=("c",),
               fn=lambda a, b: {"c": a + b})
    wf = T.compile_workflow(g)
    ex = T.WorkflowExecutor(wf, T.ProactiveScheduler(wf), n_nodes=2,
                            hierarchy=T.tiered_hierarchy(),
                            device_of=broken,
                            inject_inputs={"x": torch.ones(400)})
    done = {}

    def run():
        try:
            ex.run()
        except RuntimeError as e:
            done["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the executor hung after a failed device copy"
    assert ex.prefetch.submitted >= 1
    assert "device map failed" in str(done.get("error"))


def test_device_of_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda device map is valid")
    store = T.LocStore(1, hierarchy=T.tiered_hierarchy())
    store.put("x", torch.ones(4), loc=0)
    pf = PrefetchEngine(store, device_of=lambda node: torch.device("cuda", 0))
    fut = pf.submit("x", 0, tier="hbm")
    with pytest.raises((RuntimeError, AssertionError)):
        fut.result(timeout=30)
    with pytest.raises((RuntimeError, AssertionError)):
        pf.drain()


def test_failed_body_fails_the_run():
    g = T.TaskGraph()
    g.add_data("x", size_bytes=T.size_hint(8))
    g.add_task("bad", inputs=("x",), outputs=("y",),
               fn=lambda x: 1 / 0)
    wf = T.compile_workflow(g)
    with pytest.raises(ZeroDivisionError):
        T.WorkflowExecutor(wf, T.LocalityScheduler(wf), n_nodes=1,
                           inject_inputs={"x": 1}).run()


# ---------------------------------------------------- an epoch as a workflow
EPOCH = dict(n_steps=4, n_dp=4, batch=8, seq=32, microbatches=2)


def test_epoch_workflow_trains_as_the_loop_does():
    """The card phase's epoch at smoke size on the CPU: 4 steps of 8 x 32
    tokens in 2 microbatches, each step's batch loaded as 4 shards; the
    losses equal ``train()``'s over the same corpus, seed, OptConfig and
    microbatches bit for bit, and batches are prefetched to the steps'
    node through the device path."""
    cfg = get_smoke("granite-3-2b")
    oc = OptConfig(warmup_steps=10, total_steps=EPOCH["n_steps"])
    loop = train(cfg, TrainConfig(steps=EPOCH["n_steps"],
                                  batch=EPOCH["batch"], seq=EPOCH["seq"],
                                  microbatches=EPOCH["microbatches"],
                                  seed=0), oc, device="cpu")
    record = {}
    ex, res = CS.run_epoch_workflow(torch, cfg, oc, seed=0, device=CPU,
                                    record=record, **EPOCH)
    assert record["losses"] == loop.losses
    assert len(res.task_records) == 20
    assert res.bytes_prefetched > 0
    assert ex.prefetch.device_hits >= 1
    assert res.outputs["params4"]["opt"]["step"] == 4


def test_epoch_workflow_matches_the_references_train_step():
    """The slice as a whole: the same epoch workflow, f32 smoke model from
    the same numpy params, run through each package's executor with its
    own train step as the step bodies; the losses agree within the f32
    step tolerance."""
    jcfg = dataclasses.replace(jax_smoke("granite-3-2b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke("granite-3-2b"), dtype="float32")
    np_p = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(0)))
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    n_steps, n_dp, batch, seq = 2, 2, 4, 16

    # the port: chip_smoke's bodies, params bridged from numpy
    record = {}
    oc = OptConfig(**kw)
    g = T.compile_workflow(t_epoch(tcfg, n_steps=n_steps, n_dp=n_dp,
                                   batch=batch, seq=seq, step_flops=1e9))
    for tid, fn in CS.epoch_bodies(torch, tcfg, oc, n_steps=n_steps,
                                   n_dp=n_dp, batch=batch, seq=seq,
                                   microbatches=2, device=CPU,
                                   record=record).items():
        g.graph.tasks[tid].fn = fn
    model = make_trainable(tcfg, from_reference(tcfg, np_p, "cpu"))
    T.WorkflowExecutor(g, T.ProactiveScheduler(g), n_nodes=n_dp,
                       inject_inputs={
                           "corpus": SyntheticCorpus(tcfg.vocab, seed=0),
                           "params0": {"model": model, "opt": init_opt_state(
                               oc, dict(model.named_parameters()))}}).run()

    # the reference: the same graph and loads, its jitted train step
    joc = jopt.OptConfig(**kw)
    jstep = jax.jit(jax_make_train_step(jcfg, joc, microbatches=2))
    rows = batch // n_dp
    losses = [None] * n_steps
    rg = R.compile_workflow(r_epoch(jcfg, n_steps=n_steps, n_dp=n_dp,
                                    batch=batch, seq=seq, step_flops=1e9))

    def load(s, d):
        def body(corpus):
            b = next(corpus.batches(batch, seq, start_step=s))
            x = np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1)
            return {f"batch_{s}_{d}": x[d * rows:(d + 1) * rows]}
        return body

    def step(s):
        def body(**inputs):
            p, st = inputs[f"params{s}"]
            x = np.concatenate([inputs[f"batch_{s}_{d}"]
                                for d in range(n_dp)])
            p, st, m = jstep(p, st, {"tokens": x[:, :-1], "labels": x[:, 1:]})
            losses[s] = float(m["loss"])
            return {f"params{s + 1}": (p, st)}
        return body

    for s in range(n_steps):
        rg.graph.tasks[f"step_{s}"].fn = step(s)
        for d in range(n_dp):
            rg.graph.tasks[f"load_{s}_{d}"].fn = load(s, d)
    jp = jax.tree.map(jnp.asarray, np_p)
    R.WorkflowExecutor(rg, R.ProactiveScheduler(rg), n_nodes=n_dp,
                       inject_inputs={
                           "corpus": JaxCorpus(jcfg.vocab, seed=0),
                           "params0": (jp, jopt.init_opt_state(joc, jp))}
                       ).run()
    assert all(x is not None for x in record["losses"])
    assert record["losses"] == pytest.approx(losses, rel=STEP_TOL)


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda", 0)


STAGED = 1 << 22                 # f32 elements of the staged tensor (16 MiB)


def _read(t: torch.Tensor) -> torch.Tensor:
    """The consumer's read of a staged tensor: its sum in f64 (exact for
    ``arange(STAGED)``)."""
    return t.double().sum()


def _warm_read(dev) -> None:
    """Run :func:`_read` once and wait: a kernel's first launch (its module
    is loaded lazily) or a fresh memory segment can wait for the whole card,
    which would let a queued spin finish before the read is queued."""
    _read(torch.zeros(STAGED, device=dev))
    torch.cuda.synchronize()


def _busy(seconds: float = 1.0) -> None:
    """Queue on the current stream one kernel that spins for about
    ``seconds`` (at the H100's 1.98 GHz boost clock)."""
    torch.cuda._sleep(int(seconds * 1.98e9))


@pytest.mark.gpu
def test_staged_copy_waits_behind_a_long_kernel_on_card(cuda):
    """The staged copy lands late: the engine's side stream is busy with a
    long kernel when the stage is queued behind it, and the consumer reads
    the copy at once on its own stream. The read must see the staged
    values, which holds only if ``device_copy`` makes the consumer's stream
    wait on the copy's event. The host tensor is pinned and the read run
    once beforehand (see :func:`_warm_read`)."""
    host = torch.arange(STAGED, dtype=torch.float32).pin_memory()
    _warm_read(cuda)
    store = T.LocStore(1, hierarchy=T.tiered_hierarchy())
    store.put("x", host, loc=0)
    pf = PrefetchEngine(store, device_of=lambda node: cuda)
    side = pf.side_stream(cuda)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        # the block the copy will be given, filled with -1 first
        junk = torch.full((STAGED,), -1.0, device=cuda)
        del junk
        _busy()
    pf.submit("x", 0, tier="hbm").result(timeout=60)
    got = pf.device_copy("x", 0)
    total = _read(got)                       # on the consumer's stream
    assert not side.query(), "the copy landed before the read was queued"
    assert total.item() == STAGED * (STAGED - 1) / 2
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), host)
    assert pf.device_hits == 1
    pf.shutdown()


@pytest.mark.gpu
def test_taken_copy_outlives_the_engine_until_the_read_runs_on_card(cuda):
    """The consumer's stream is busy when it takes a staged copy and queues
    a read of it; then the engine lets go of the copy (the object is
    deleted) and a second tensor of the same size is staged on the idle
    side stream. The read must still see the first tensor's values, which
    holds only if ``device_copy`` marked the copy as used by the consumer's
    stream (``record_stream``): else the allocator hands its memory to the
    second copy, which lands before the read runs. Both host tensors are
    pinned and the read run once beforehand, as in the test above."""
    host = torch.arange(STAGED, dtype=torch.float32).pin_memory()
    other = torch.full((STAGED,), -1.0).pin_memory()
    _warm_read(cuda)
    store = T.LocStore(1, hierarchy=T.tiered_hierarchy())
    store.put("x", host, loc=0)
    pf = PrefetchEngine(store, device_of=lambda node: cuda)
    pf.submit("x", 0, tier="hbm").result(timeout=60)
    torch.cuda.synchronize()                 # the copy has landed
    _busy()
    got = pf.device_copy("x", 0)
    total = _read(got)                       # queued behind the spin
    del got
    store.delete("x")                        # the engine drops its copy
    store.put("y", other, loc=0)
    pf.submit("y", 0, tier="hbm").result(timeout=60)
    pf.side_stream(cuda).synchronize()       # the second copy has landed
    assert not torch.cuda.current_stream(cuda).query(), \
        "the read ran before the second copy was staged"
    assert total.item() == STAGED * (STAGED - 1) / 2
    assert torch.equal(pf.device_copy("y", 0).cpu(), other)
    pf.shutdown()


@pytest.mark.gpu
def test_quickstart_on_card_matches_cpu_bodies(cuda):
    raw = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1 << 20).astype(np.float32)).pin_memory()
    _, cpu = QS.run_quickstart(raw, CPU)
    ex, res = QS.run_quickstart(raw, cuda, lambda node: cuda)
    assert res.outputs["out"] == pytest.approx(cpu.outputs["out"],
                                               rel=CS.QUICKSTART_RTOL)
    assert ex.store.stat("a").real_loc == res.task_records["split"]["node"]
