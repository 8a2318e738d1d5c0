"""The port's attention kernels against the reference's.

On the CPU the port's ops run the plain versions (``repro_torch.kernels.ref``),
held here to the reference's oracles (``repro.kernels.ref``) and, where the
reference side is the Pallas kernel, to that kernel in interpret mode — the
same inputs, made with numpy from a seed, reach both packages as numpy
arrays. Tolerances are the reference kernel tests': 2e-5 in f32, 0.05 in bf16.

Tests marked ``gpu`` hold the hand-written CUDA kernels to the plain versions
on the card; they decide inside a fixture whether there is one and skip here.
There bf16 is also held element by element to 4e-3 + 2^-6 * |plain| (as in
chip_smoke.py), which a skipped key tile or chunk does not meet.
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
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (CHUNK, chunk_grid,
                                                  decode_attention)
from repro_torch.kernels.flash_attention import (Q_ROWS, block_k,
                                                 flash_attention, tma_args,
                                                 tensor_map_geometry)

TOL = {"float32": 2e-5, "bfloat16": 0.05}
BF16_ATOL, BF16_RTOL = 4e-3, 2.0 ** -6

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

# the redesigned kernels' own edges (also in chip_smoke.py)
FLASH_EDGE = [
    # B, Sq, Sk, Hq, Hkv, hd, causal, window, off
    (1, 130, 130, 2, 2, 48, True, 0, 0),       # G 1, ragged 130, hd 48
    (2, 70, 200, 4, 2, 80, True, 0, 130),      # q_offset > 0, Sk > Sq, G 2
    (1, 77, 77, 8, 2, 168, True, 0, 0),        # G 4, gemma3-27b head dim
    (1, 200, 200, 4, 2, 72, True, 50, 0),      # window edge inside a tile
    (1, 150, 150, 2, 1, 240, True, 100, 0),    # hd 240, window inside a tile
    (2, 33, 97, 4, 4, 64, False, 0, 0),        # bidirectional, ragged, G 1
    (1, 64, 300, 8, 2, 64, True, 37, 236),     # offset and window, G 4
    (1, 140, 140, 4, 2, 176, True, 0, 0),      # a block's 2nd warpgroup idle
    (1, 40, 150, 4, 4, 64, False, 0, 0),       # cross attention: tail past Sk
    (1, 70, 201, 8, 1, 128, False, 0, 0),      # non-causal tail at hd 128, MQA
    (1, 96, 96, 4, 4, 192, True, 0, 0),        # MLA prefill: hd 192, 256 bucket
]

DECODE_EDGE = [
    # B, S, Hq, Hkv, hd, window, lengths
    (4, 600, 8, 2, 64, 0, [1, CHUNK, CHUNK + 1, 5000]),
    (2, 1024, 4, 2, 64, 100, [250, 650]),      # windows cross chunk edges
    (2, 2048, 4, 2, 240, 50, [100, 1900]),     # every chunk empty but one
    (3, 700, 16, 2, 128, 0, [700, 1, 513]),    # G 8
    (2, 512, 24, 2, 64, 0, [512, 130]),        # G 12: two head slices
    (3, 500, 8, 8, 64, 0, [500, 500, 500]),    # G 1 cross decode: all full
]


def pair(rng, shape, dtype):
    """One input as (jax array, torch tensor) holding identical values."""
    j = jnp.asarray(rng.normal(size=shape), dtype)
    return j, to_torch(np.asarray(j), "cpu")


def err(t: torch.Tensor, j) -> float:
    return float(np.abs(to_numpy(t).astype(np.float32)
                        - np.asarray(j, np.float32)).max())


def assert_close_on_card(out: torch.Tensor, want: torch.Tensor, dtype: str):
    """A kernel against its plain version: max error under TOL, and for bf16
    every element within BF16_ATOL + BF16_RTOL * |plain| as well."""
    diff = (out.float() - want.float()).abs()
    assert float(diff.max()) < TOL[dtype]
    if dtype == "bfloat16":
        bound = BF16_ATOL + BF16_RTOL * want.float().abs()
        assert bool((diff <= bound).all()), float((diff / bound).max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda")


# ------------------------------------------------------------------ flash
@pytest.mark.parametrize("case", FLASH_CASES + FLASH_EDGE,
                         ids=[f"flash{i}" for i in range(len(FLASH_CASES))]
                         + [f"edge{i}" for i in range(len(FLASH_EDGE))])
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


@pytest.mark.parametrize("case", DECODE_EDGE,
                         ids=[f"edge{i}" for i in range(len(DECODE_EDGE))])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_plain_matches_reference_at_the_kernel_edges(case, dtype):
    """The card's edge lengths (1, a chunk, a chunk + 1, past S; windows
    across chunk edges): the reference sees them clamped to S."""
    B, S, Hq, Hkv, hd, win, lens = case
    rng = np.random.default_rng([int(x) for x in case[:6]])
    qj, qt = pair(rng, (B, Hq, hd), dtype)
    (kj, kt), (vj, vt) = (pair(rng, (B, S, Hkv, hd), dtype),
                          pair(rng, (B, S, Hkv, hd), dtype))
    lj = jnp.minimum(jnp.asarray(lens, jnp.int32), S)
    out = ops.decode_attention_op(qt, kt, vt,
                                  torch.tensor(lens, dtype=torch.int32),
                                  window=win)
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
    """A device other than cpu, cuda and meta (the dry run's; shapes only)
    is refused before anything else is read: a stand-in that has only a
    ``device`` stands for a tensor on such a device here."""
    class OnMps:
        device = torch.device("mps")

    q = OnMps()
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q, q, q, q)
    m = torch.empty((1, 4, 2, 32), device="meta")
    assert flash_attention(m, m, m).device.type == "meta"


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
    assert_close_on_card(out, ops.attention_op(q, k, v, impl="plain", **kw),
                         dtype)


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
    assert_close_on_card(
        out, ops.decode_attention_op(q, kc, vc, lens, window=win,
                                     impl="plain"), dtype)


# ------------------------------------------------------------------ shape logic
@pytest.mark.parametrize("S,chunk,want", [
    (2048, 256, 8), (2049, 256, 9), (1, 256, 1), (256, 256, 1), (300, 128, 3),
])
def test_decode_chunk_grid_is_fixed_by_S(S, chunk, want):
    assert chunk_grid(S, chunk) == want


@pytest.mark.parametrize("shape,rows,want", [
    ((1, 1024, 32, 64), Q_ROWS,                # granite q
     ((64, 32, 1024, 1), (128, 4096, 4194304), (64, 1, 64, 1))),
    ((1, 1024, 8, 64), block_k(64),            # granite k/v
     ((64, 8, 1024, 1), (128, 1024, 1048576), (64, 1, 128, 1))),
    ((2, 1536, 8, 240), block_k(240),          # gemma3-12b k/v
     ((240, 8, 1536, 2), (480, 3840, 5898240), (64, 1, 64, 1))),
    ((3, 77, 2, 168), block_k(168),            # gemma3-27b head dim
     ((168, 2, 77, 3), (336, 672, 51744), (64, 1, 64, 1))),
    ((1, 130, 2, 48), block_k(48),             # hd below one 64-column box
     ((48, 2, 130, 1), (96, 192, 24960), (64, 1, 128, 1))),
    ((2, 200, 2, 72), Q_ROWS,                  # hd just past one box
     ((72, 2, 200, 2), (144, 288, 57600), (64, 1, 64, 1))),
    ((2, 70, 4, 80), Q_ROWS,
     ((80, 4, 70, 2), (160, 640, 44800), (64, 1, 64, 1))),
])
def test_flash_tensor_map_geometry(shape, rows, want):
    dims, strides, box = tensor_map_geometry(shape, rows)
    assert (dims, strides, box) == want
    assert all(s % 16 == 0 for s in strides)   # what TMA requires


@pytest.mark.parametrize("q_shape,kv_shape", [
    ((1, 1024, 32, 64), (1, 1024, 8, 64)),     # granite-3-2b prefill
    ((1, 1536, 16, 240), (1, 1536, 8, 240)),   # gemma3-12b prefill
    ((2, 64, 8, 64), (2, 192, 2, 64)),         # suffix prefill: Sk > Sq
])
def test_flash_launch_gets_q_then_kv_geometry(q_shape, kv_shape):
    """The 2 x 11 numbers a bf16 launch encodes its tensor maps from: q in
    boxes of one warpgroup's rows, k and v in boxes of the key tile."""
    got = tuple(tma_args(q_shape, kv_shape))
    hd = q_shape[3]
    flat = [x for geo in (tensor_map_geometry(q_shape, Q_ROWS),
                          tensor_map_geometry(kv_shape, block_k(hd)))
            for part in geo for x in part]
    assert got == tuple(flat) and len(got) == 22
    assert got[9] == 64 and got[11 + 9] == block_k(hd)
    assert got[0] == got[11] == hd and got[2] == q_shape[1] \
        and got[11 + 2] == kv_shape[1]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_config_head_dims_meet_the_bf16_kernels_load_rules(name):
    """Every config's attention reaches the bf16 kernels: hd within the
    kernels' 256, a multiple of 8 (TMA's 16-byte strides, the decode
    kernel's 16-byte loads), and a chunk grid of at least one block."""
    cfg = get_config(name)
    hd = cfg.hd
    assert 0 < hd <= 256 and hd % 8 == 0
    q, kv = (1, 4096, cfg.n_heads, hd), (1, 4096, cfg.n_kv_heads, hd)
    args = tma_args(q, kv)
    assert all(args[i] % 16 == 0 for i in (4, 5, 6, 15, 16, 17))
    assert chunk_grid(4096) == -(-4096 // CHUNK) >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_EDGE,
                         ids=[f"edge{i}" for i in range(len(FLASH_EDGE))])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_kernel_edges_on_card(cuda, case, dtype):
    B, Sq, Sk, Hq, Hkv, hd, causal, win, off = case
    g = torch.Generator(device=cuda).manual_seed(1)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dt)
               for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))
    kw = dict(causal=causal, window=win, q_offset=off)
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert_close_on_card(out, ref.flash_attention_ref(q, k, v, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_EDGE,
                         ids=[f"edge{i}" for i in range(len(DECODE_EDGE))])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_kernel_edges_on_card(cuda, case, dtype):
    B, S, Hq, Hkv, hd, win, lens = case
    g = torch.Generator(device=cuda).manual_seed(2)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Hq, hd), generator=g, device=cuda).to(dt)
    kc, vc = (torch.randn((B, S, Hkv, hd), generator=g, device=cuda).to(dt)
              for _ in range(2))
    lt = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = decode_attention(q, kc, vc, lt, window=win)
    torch.cuda.synchronize()
    assert_close_on_card(out, ref.decode_attention_ref(q, kc, vc, lt,
                                                       window=win), dtype)


@pytest.mark.gpu
def test_kernels_refuse_what_their_loads_cannot_take(cuda):
    bf = torch.bfloat16
    q = torch.randn((1, 64, 2, 36), device=cuda).to(bf)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="multiple of 8"):
        decode_attention(q[:, 0], q, q,
                         torch.ones((1,), dtype=torch.int32, device=cuda))
    flat = torch.randn(1 + 64 * 2 * 64, device=cuda).to(bf)
    odd = flat[1:].view(1, 64, 2, 64)               # 2 bytes past a boundary
    assert odd.is_contiguous() and odd.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(odd, odd, odd)
    with pytest.raises(ValueError, match="16-byte"):
        decode_attention(odd[:, 0], odd, odd,
                         torch.ones((1,), dtype=torch.int32, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 240])
def test_flash_launch_refuses_a_box_that_is_not_its_tile(cuda, hd):
    """block_k(hd) is the tile the kernel was compiled with: the launch takes
    it, and refuses a K/V box of any other height."""
    import ctypes

    from repro_torch.kernels import _build
    bf = torch.bfloat16
    q = torch.randn((1, 128, 2, hd), device=cuda).to(bf)
    k = torch.randn((1, 192, 2, hd), device=cuda).to(bf)
    lib = _build.load()

    def launch(rows):
        args = list(tma_args(tuple(q.shape), tuple(k.shape)))
        args[11 + 9] = rows
        out = torch.empty_like(q)
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), k.data_ptr(), out.data_ptr(), 1, 128,
            192, 2, 2, hd, 1, 0, 0, ctypes.c_float(hd ** -0.5), 1,
            (ctypes.c_ulonglong * 22)(*args),
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        return err, out

    err, out = launch(block_k(hd))
    assert err == 0
    assert_close_on_card(out, ref.flash_attention_ref(q, k, k), "bfloat16")
    assert launch(2 * block_k(hd))[0] != 0
    assert launch(block_k(hd) // 2)[0] != 0
