"""The port's attention kernels against the reference's.

On the CPU the port's ops run the plain versions (``repro_torch.kernels.ref``),
held here to the reference's oracles (``repro.kernels.ref``) and, where the
reference side is the Pallas kernel, to that kernel in interpret mode — the
same inputs, made with numpy from a seed, reach both packages as numpy
arrays. Tolerances are the reference kernel tests': 2e-5 in f32, 0.05 in bf16.

Tests marked ``gpu`` hold the hand-written CUDA kernels to the plain versions
on the card; they decide inside a fixture whether there is one and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ops import window_slice as jax_window_slice
from repro_torch._bridge import to_numpy, to_torch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention

TOL = {"float32": 2e-5, "bfloat16": 0.05}

FLASH_CASES = [
    # B, Sq, Sk, Hq, Hkv, hd, causal, window, off  (as tests/test_kernels.py)
    (2, 128, 128, 4, 2, 64, True, 0, 0),
    (1, 100, 100, 4, 4, 72, True, 0, 0),       # unaligned seq + head dim
    (2, 64, 192, 8, 2, 64, True, 0, 128),      # suffix prefill offset
    (2, 256, 256, 4, 2, 64, True, 64, 0),      # sliding window (gemma local)
    (1, 96, 160, 2, 2, 48, False, 0, 0),       # bidirectional (encoder)
    (1, 64, 64, 8, 1, 128, True, 0, 0),        # MQA
    (2, 80, 80, 6, 3, 240, True, 0, 0),        # gemma3-12b head dim
]

DECODE_CASES = [
    # B, S, Hq, Hkv, hd, window  (as tests/test_kernels.py)
    (2, 256, 4, 2, 64, 0),
    (2, 300, 8, 8, 80, 0),        # unaligned cache + head dim
    (3, 512, 4, 2, 64, 128),      # sliding window decode
    (1, 64, 2, 1, 32, 16),
    (2, 1024, 16, 2, 128, 0),     # long cache, high group count
]


def pair(rng, shape, dtype):
    """One input as (jax array, torch tensor) holding identical values."""
    j = jnp.asarray(rng.normal(size=shape), dtype)
    return j, to_torch(np.asarray(j), "cpu")


def err(t: torch.Tensor, j) -> float:
    return float(np.abs(to_numpy(t).astype(np.float32)
                        - np.asarray(j, np.float32)).max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda")


# ------------------------------------------------------------------ flash
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"flash{i}" for i in range(len(FLASH_CASES))])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_plain_matches_reference(case, dtype):
    B, Sq, Sk, Hq, Hkv, hd, causal, win, off = case
    rng = np.random.default_rng([int(x) for x in case])
    (qj, qt), (kj, kt), (vj, vt) = (pair(rng, (B, Sq, Hq, hd), dtype),
                                    pair(rng, (B, Sk, Hkv, hd), dtype),
                                    pair(rng, (B, Sk, Hkv, hd), dtype))
    kw = dict(causal=causal, window=win, q_offset=off)
    out = ops.attention_op(qt, kt, vt, **kw)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    assert err(out, jref.flash_attention_ref(qj, kj, vj, **kw)) < TOL[dtype]
    want = pallas_flash(qj, kj, vj, interpret=True, block_q=64, block_k=64,
                        **kw)
    assert err(out, want) < TOL[dtype]


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[f"dec{i}" for i in range(len(DECODE_CASES))])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_plain_matches_reference(case, dtype):
    B, S, Hq, Hkv, hd, win = case
    rng = np.random.default_rng([int(x) for x in case])
    qj, qt = pair(rng, (B, Hq, hd), dtype)
    (kj, kt), (vj, vt) = (pair(rng, (B, S, Hkv, hd), dtype),
                          pair(rng, (B, S, Hkv, hd), dtype))
    lens = rng.integers(1, S + 1, (B,)).astype(np.int32)
    lj, lt = jnp.asarray(lens), torch.from_numpy(lens)
    out = ops.decode_attention_op(qt, kt, vt, lt, window=win)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    assert err(out, jref.decode_attention_ref(qj, kj, vj, lj, window=win)) \
        < TOL[dtype]
    want = pallas_decode(qj, kj, vj, lj, window=win, interpret=True,
                         block_k=128)
    assert err(out, want) < TOL[dtype]


def test_decode_length_one_edge():
    rng = np.random.default_rng(1)
    qj, qt = pair(rng, (1, 2, 64), "float32")
    (kj, kt), (vj, vt) = (pair(rng, (1, 128, 2, 64), "float32"),
                          pair(rng, (1, 128, 2, 64), "float32"))
    out = ops.decode_attention_op(qt, kt, vt, torch.tensor([1], dtype=torch.int32))
    want = jref.decode_attention_ref(qj, kj, vj, jnp.asarray([1], jnp.int32))
    assert err(out, want) < 2e-5


@pytest.mark.parametrize("window", [0, 16])
def test_decode_lengths_past_cache_are_clamped(window):
    """An idle serving slot's position runs past the cache: the plain version
    (and the kernel) clamp lengths to S, i.e. attend like a full cache."""
    rng = np.random.default_rng(2)
    S = 64
    qj, qt = pair(rng, (2, 4, 32), "float32")
    (kj, kt), (vj, vt) = (pair(rng, (2, S, 2, 32), "float32"),
                          pair(rng, (2, S, 2, 32), "float32"))
    lens = np.asarray([S + 1, 5 * S], np.int32)
    out = ops.decode_attention_op(qt, kt, vt, torch.from_numpy(lens),
                                  window=window)
    clamped = jnp.minimum(jnp.asarray(lens), S)
    assert err(out, jref.decode_attention_ref(qj, kj, vj, clamped,
                                              window=window)) < 2e-5
    if window == 0:       # unwindowed, the reference needs no clamp at all
        assert err(out, jref.decode_attention_ref(
            qj, kj, vj, jnp.asarray(lens))) < 2e-5


@pytest.mark.parametrize("S,W,lens", [
    (1024, 100, [900, 310]), (1024, 100, [50, 1024]),
    (512, 512, [512, 33]), (256, 300, [100, 256]),
])
def test_window_slice_matches_reference(S, W, lens):
    """Same slice and same shifted lengths, exactly; and the sliced decode
    equals the full-cache windowed decode."""
    rng = np.random.default_rng(3)
    (cj, ct) = pair(rng, (2, S, 2, 64), "float32")
    lj = jnp.asarray(lens, jnp.int32)
    lt = torch.tensor(lens, dtype=torch.int32)
    ks_j, lk_j = jax_window_slice(cj, lj, W, block=128)
    ks_t, lk_t = ops.window_slice(ct, lt, W, block=128)
    np.testing.assert_array_equal(to_numpy(ks_t), np.asarray(ks_j))
    np.testing.assert_array_equal(to_numpy(lk_t), np.asarray(lk_j))
    qj, qt = pair(rng, (2, 4, 64), "float32")
    sliced = ops.decode_attention_op(qt, ks_t, ks_t, lk_t, window=W)
    full = ops.decode_attention_op(qt, ct, ct, lt, window=W)
    assert float((sliced - full).abs().max()) < 1e-5


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(1, 16, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 16, 2, 32)).astype(np.float32))
    f0, d0 = flash_attention.launches, decode_attention.launches
    torch.testing.assert_close(flash_attention(q, k, k),
                               ref.flash_attention_ref(q, k, k),
                               rtol=0, atol=0)
    lens = torch.tensor([7], dtype=torch.int32)
    torch.testing.assert_close(decode_attention(q[:, 0], k, k, lens),
                               ref.decode_attention_ref(q[:, 0], k, k, lens),
                               rtol=0, atol=0)
    assert (flash_attention.launches, decode_attention.launches) == (f0, d0)
    torch.testing.assert_close(ops.attention_op(q, k, k, impl="plain"),
                               ops.attention_op(q, k, k), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.attention_op(q, k, k, impl="xla")


def test_wrappers_refuse_other_devices():
    q = torch.empty((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q[:, 0], q, q, torch.empty((1,), device="meta"))


def test_bridge_bf16_roundtrip_is_bit_exact():
    j = jnp.asarray(np.random.default_rng(5).normal(size=(3, 7)), jnp.bfloat16)
    t = to_torch(np.asarray(j), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(t), np.asarray(j, np.float32))


# ------------------------------------------------------------------ on the card
@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"flash{i}" for i in range(len(FLASH_CASES))])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_kernel_matches_plain_on_card(cuda, case, dtype):
    B, Sq, Sk, Hq, Hkv, hd, causal, win, off = case
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dt)
               for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))
    kw = dict(causal=causal, window=win, q_offset=off)
    n = flash_attention.launches
    out = ops.attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    want = ops.attention_op(q, k, v, impl="plain", **kw)
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[f"dec{i}" for i in range(len(DECODE_CASES))])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_kernel_matches_plain_on_card(cuda, case, dtype):
    B, S, Hq, Hkv, hd, win = case
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Hq, hd), generator=g, device=cuda).to(dt)
    kc, vc = (torch.randn((B, S, Hkv, hd), generator=g, device=cuda).to(dt)
              for _ in range(2))
    lens = torch.randint(1, 2 * S, (B,), generator=g, device=cuda,
                         dtype=torch.int32)
    n = decode_attention.launches
    out = ops.decode_attention_op(q, kc, vc, lens, window=win)
    torch.cuda.synchronize()
    assert decode_attention.launches == n + 1
    want = ops.decode_attention_op(q, kc, vc, lens, window=win, impl="plain")
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]
