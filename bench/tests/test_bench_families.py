"""The family modules (``bench/families/<family>.py``): the dense family
gives granite-3-2b the weights, FLOPs and K1/K2 work pinned from the
harness before the rules moved there; a new family is one new file; a
family with no file fails before any weight is drawn."""

import ast
import dataclasses
import functools
import hashlib
import json
import math
import re
import shutil
import types

import pytest
import torch

import harness
import weights as W
from drivers import serving
from repro_torch.configs import granite_3_2b, zamba2_7b
from repro_torch.models import model as M
from work import flops, readers

GRANITE = harness.load_json(harness.BENCH / "configs" / "granite-3-2b.json")

# (shape, (scale, shift)) of each granite-3-2b leaf, ``blocks.<l>`` as
# ``blocks.*``, as the dense rule gave them before it moved
PINNED_INIT = {
    "final_norm": ((2048,), (0.0, 0.0)),
    "embed.tok": ((49408, 2048), (0.02, 0.0)),
    "embed.head": ((2048, 49408), (0.022097086912079608, 0.0)),
    "blocks.*.ln1": ((2048,), (0.0, 0.0)),
    "blocks.*.ln2": ((2048,), (0.0, 0.0)),
    "blocks.*.attn.wq": ((2048, 2048), (0.022097086912079608, 0.0)),
    "blocks.*.attn.wk": ((2048, 512), (0.022097086912079608, 0.0)),
    "blocks.*.attn.wv": ((2048, 512), (0.022097086912079608, 0.0)),
    "blocks.*.attn.wo": ((2048, 2048), (0.002470529422006546, 0.0)),
    "blocks.*.mlp.w1": ((2048, 8192), (0.022097086912079608, 0.0)),
    "blocks.*.mlp.w2": ((8192, 2048), (0.001235264711003273, 0.0)),
    "blocks.*.mlp.w3": ((2048, 8192), (0.022097086912079608, 0.0)),
}

# SHA-256 of each dtype's flat buffer of the dense smoke model at seed 0
PINNED_SMOKE_DIGEST = {
    torch.bfloat16: (689280, "3d7ac6230547c822ffc9be1661cf877c0cf7d8c7db1f"
                             "62ed43b75b4be7b0548f"),
}


@pytest.mark.parametrize("path", sorted((harness.BENCH / "families")
                                        .glob("*.py")), ids=lambda p: p.name)
def test_family_imports_nothing_of_the_program(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_dense_leaf_init_equals_pinned():
    cfg = serving.model_config(GRANITE)
    rules = harness.family_rules(GRANITE["model"])
    meta = M.init_params(cfg, device="meta")
    seen = set()
    for name, p in meta.named_parameters():
        key = re.sub(r"blocks\.\d+\.", "blocks.*.", name)
        shape, want = PINNED_INIT[key]
        assert tuple(p.shape) == shape
        assert rules.leaf_init(name, shape, GRANITE["model"]) == want
        seen.add(key)
    assert seen == set(PINNED_INIT)


def _buffers(flat: dict) -> dict:
    """Each dtype's flat buffer, which every leaf of it views."""
    out = {}
    for t in flat.values():
        out.setdefault(t.dtype, t._base)
    return out


def test_smoke_dense_weights_equal_pinned_digest():
    _, flat = W.make_weights(granite_3_2b.smoke(), 0, "cpu")
    got = {d: (b.numel(),
               hashlib.sha256(b.view(torch.uint8).numpy().tobytes())
               .hexdigest())
           for d, b in _buffers(flat).items()}
    assert got == PINNED_SMOKE_DIGEST


def _record(model: dict) -> harness.Record:
    rec = harness.Record(work={"model": model, "max_seq": 4096,
                               "k2_lengths": [[5, 100, 4096, 5000],
                                              [1, 2, 3]]})
    rec.profile = types.SimpleNamespace(kernel_seconds=lambda k: 0.125)
    return rec


def test_dense_work_equals_pinned():
    model = GRANITE["model"]
    assert flops.serve_flops(model, [3000, 1234, 4096], 5000, 12345678) \
        == 74382606274560.0
    rec = _record(model)
    cases = readers.prefill_cases(rec, [3000, 17])
    assert cases == [((1, S, S, 32, 8, 64, True, 0, 0), 64)
                     for S in (3000, 17) for _ in range(40)]
    assert readers.k1_roofline(rec, ("k",), cases) == 1.1948288961984819
    assert readers.k2_roofline(rec, ("k",)) == 0.16297949611940296


HYBRID = '''
import math

def leaf_init(name, shape, model):
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "A_log":
        return 0.5, math.log(4.0)
    if leaf == "D":
        return 0.0, 1.0
    if len(shape) == 1:
        return 0.0, 0.0
    if name == "embed.tok":
        return 0.02, 0.0
    if len(shape) == 2:
        return 1.0 / math.sqrt(shape[0]), 0.0
    raise ValueError(f"no init rule for leaf {name} {shape}")

def serve_flops(model, prefill_lengths, decode_tokens, decode_ctx):
    return 2.0 * (sum(prefill_lengths) + decode_tokens) + decode_ctx

def attention_calls(model):
    hd = model["d_model"] // model["n_heads"]
    return [(model["n_heads"], model["n_kv_heads"], hd, hd, 0)] \\
        * (model["n_layers"] // model["attn_every"])
'''


def test_new_family_is_one_file(tmp_path, monkeypatch):
    """A family module in a directory of its own gives the port's hybrid
    smoke model its weights, FLOPs and attention calls, with no edit to a
    file of the benchmark."""
    (tmp_path / "hybrid.py").write_text(HYBRID)
    cfg = zamba2_7b.smoke()
    tree, flat = W.make_weights(cfg, 2**31 + 5, "cpu", families=tmp_path)
    meta = dict(M.init_params(cfg, device="meta").named_parameters())
    assert {n: tuple(t.shape) for n, t in flat.items()} == \
        {n: tuple(p.shape) for n, p in meta.items()}
    a_logs = [t for n, t in flat.items() if n.endswith(".A_log")]
    assert a_logs and all(t.dtype == torch.float32 for t in a_logs)
    a = torch.cat(a_logs)
    assert len(set(a.tolist())) == a.numel()     # heads decay apart
    assert abs(a.mean().item() - math.log(4.0)) < 0.5
    assert all(bool((t == 1).all()) for n, t in flat.items()
               if n.endswith(".D"))
    assert all(bool((t == 0).all()) for n, t in flat.items()
               if n.endswith("norm") or n.endswith(".ln"))
    model = M.build_model(cfg, tree)
    logits, _ = M.prefill(cfg, model,
                          {"tokens": torch.arange(12).view(1, 12) % 500}, 32)
    assert torch.isfinite(logits.float()).all()

    monkeypatch.setattr(harness, "family_rules", functools.partial(
        harness.family_rules, families=tmp_path))
    hybrid = dataclasses.asdict(cfg)
    assert flops.serve_flops(hybrid, [10, 20], 5, 7) == 77.0
    rec = _record(hybrid)
    assert readers.prefill_cases(rec, [64]) == \
        [((1, 64, 64, 4, 4, 16, True, 0, 0), 16)] * 2
    assert readers.k2_roofline(rec, ("k",)) > 0


@pytest.fixture
def no_draws(monkeypatch):
    """Fails a test that draws a weight."""
    def randn(*a, **k):
        raise AssertionError("a weight was drawn")
    monkeypatch.setattr(torch, "randn", randn)


def test_missing_family_fails_before_any_weight(tmp_path, no_draws):
    with pytest.raises(FileNotFoundError,
                       match=re.escape(str(tmp_path / "dense.py"))):
        W.make_weights(granite_3_2b.smoke(), 0, "cpu", families=tmp_path)
    with pytest.raises(FileNotFoundError, match="bench/families/nosuch.py"):
        W.make_weights(dataclasses.replace(granite_3_2b.smoke(),
                                           family="nosuch"), 0, "cpu")


def test_missing_family_fails_when_the_cell_loads(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(harness.BENCH / "mixes", bench / "mixes")
    (bench / "configs").mkdir()
    conf = json.loads(json.dumps(GRANITE))
    conf["model"]["family"] = "nosuch"
    (bench / "configs" / "granite-3-2b.json").write_text(json.dumps(conf))
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    name = spec["workloads"][0]["name"]
    with pytest.raises(FileNotFoundError,
                       match=re.escape(str(bench / "families" / "nosuch.py"))):
        harness.load_cell(name, spec, bench=bench)


def test_leaf_without_rule_fails_before_any_weight(tmp_path, no_draws):
    (tmp_path / "dense.py").write_text(
        "def leaf_init(name, shape, model):\n"
        "    raise ValueError(f'no init rule for leaf {name}')\n")
    with pytest.raises(ValueError, match="no init rule"):
        W.make_weights(granite_3_2b.smoke(), 0, "cpu", families=tmp_path)
