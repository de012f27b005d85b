"""The trace reader on made-up events: the union of device intervals,
kernel times, the top device operations and the idle gaps' names."""

import pytest

from harness.trace import Trace, short_name


class Event:
    def __init__(self, name, kind, start, dur):
        self._n, self._k, self._s, self._d = name, kind, start, dur

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def device_type(self):
        return "DeviceType.CUDA" if self._k != "cuda_runtime" else "CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def _trace():
    return Trace([
        Event("void k<1>(int, float*)", "kernel", 0, 10),
        Event("void k<1>(int, float*)", "kernel", 5, 10),     # overlaps
        Event("void j(int)", "kernel", 40, 10),
        Event("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 100, 5),
        Event("cudaMemcpyAsync", "cuda_runtime", 60, 30),
    ])


def test_busy_is_the_union_of_device_intervals():
    assert _trace().busy_s() == pytest.approx(30e-9)


def test_kernels_and_top_operations():
    t = _trace()
    assert [n for n, _ in t.kernels()] == ["void k<1>(int, float*)"] * 2 + [
        "void j(int)"]
    assert t.device_ops()[0] == ["void k<1>", pytest.approx(20e-9)]


def test_idle_gaps_are_named_by_the_host():
    gaps = dict((k, v) for k, v in _trace().idle_gaps())
    assert gaps == {"host before void j": pytest.approx(25e-9),
                    "host: cudaMemcpyAsync": pytest.approx(50e-9)}


def test_short_name_drops_the_parameter_list():
    assert short_name("void a::(anonymous namespace)::f<int>(float*, int)"
                      ) == "void a::(anonymous namespace)::f<int>"
