"""The benchmark's copies of the program's work and busy-time arithmetic
and of its peaks stay equal to the program's."""

import types

import pytest

from repro_torch.core.locstore import tiered_hierarchy
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import profile_cell as PC
from work import busy, peaks, roofline


@pytest.mark.parametrize("case", [
    (1, 1024, 1024, 32, 8, 64, True, 0, 0),
    (4, 4096, 4096, 32, 8, 64, True, 0, 0),
    (2, 300, 1500, 16, 16, 64, False, 0, 0),
    (1, 512, 2048, 16, 8, 240, True, 1024, 1536),
])
def test_flash_work_equals_program(case):
    assert roofline.flash_work(case, 2) == OA.flash_work(case, 2)
    assert roofline.flash_work(case, 4, dv=128) == \
        OA.flash_work(case, 4, dv=128)


@pytest.mark.parametrize("case,lengths", [
    ((8, 2048, 32, 8, 64, 0), [5, 100, 2048, 4000, 1, 17, 900, 2047]),
    ((2, 4096, 16, 8, 240, 1024), [3000, 20]),
])
def test_decode_work_equals_program(case, lengths):
    assert roofline.decode_work(case, lengths, 2) == \
        OA.decode_work(case, lengths, 2)


def test_peaks_equal_program():
    assert peaks.PEAK_BF16_FLOPS == PC.PEAK_BF16_FLOPS
    assert peaks.PEAK_HBM_BYTES_PER_S == tiered_hierarchy().bw("hbm")
    assert peaks.least_seconds(989e12, 0.0) == 1.0


@pytest.mark.parametrize("iv", [
    [], [(0.0, 1.0)], [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)],
    [(3.0, 4.0), (0.0, 1.0), (0.5, 0.6), (0.9, 3.5)],
])
def test_busy_ms_equals_program(iv):
    assert busy.busy_ms(iv) == PC.busy_ms(iv)


class _Ev:
    """A Kineto event as range_busy_ms reads it."""

    def __init__(self, name, a, b, dev, tid=1, corr=0, link=0):
        from torch.autograd import DeviceType
        self._n, self._a, self._b = name, a, b
        self._d = DeviceType.CUDA if dev else DeviceType.CPU
        self._t, self._c, self._l = tid, corr, link

    def name(self): return self._n
    def start_ns(self): return self._a
    def end_ns(self): return self._b
    def device_type(self): return self._d
    def start_thread_id(self): return self._t
    def correlation_id(self): return self._c
    def linked_correlation_id(self): return self._l


def test_range_busy_ms_equals_program():
    ev = [_Ev("adamw_update", 0, 100, False, corr=1),
          _Ev("aten::mul", 10, 20, False, corr=2),
          _Ev("aten::add", 30, 40, False, corr=3),
          _Ev("aten::mm", 200, 210, False, corr=4),
          _Ev("k_mul", 1000, 3000, True, link=2),
          _Ev("k_add", 2500, 5000, True, link=3),
          _Ev("k_mm", 6000, 9000, True, link=4),
          _Ev("adamw_update", 900, 5200, True, link=1)]
    for name in ("adamw_update", "aten::mm"):
        assert busy.range_busy_ms(ev, name) == PC.range_busy_ms(ev, name)
    assert busy.range_busy_ms(ev, "adamw_update") == pytest.approx(4e-3)


def test_device_intervals_equals_program():
    from torch.autograd import DeviceType
    def fe(key, a, b, dev, ann=False):
        return types.SimpleNamespace(
            key=key, is_user_annotation=ann,
            device_type=DeviceType.CUDA if dev else DeviceType.CPU,
            time_range=types.SimpleNamespace(start=a, end=b))
    evs = [fe("gemm", 0, 10, True), fe("adamw_update", 0, 50, True),
           fe("aten::mm", 0, 5, False), fe("bench.step", 0, 99, True, True)]
    prof = types.SimpleNamespace(events=lambda: evs)
    assert busy.device_intervals(prof) == PC.device_intervals(prof)
