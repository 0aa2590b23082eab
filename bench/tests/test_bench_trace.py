"""The trace reduction: busy time as a union, device time by name, idle gaps by host activity."""

import pytest

from bench import trace


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


EVENTS = [
    ev("user_annotation", "bench.window", 0, 1000),
    ev("user_annotation", "bench.call", 10, 400),
    ev("user_annotation", "bench.call", 500, 400),
    ev("cpu_op", "aten::nonzero", 20, 100),
    ev("cuda_runtime", "cudaStreamSynchronize", 30, 80),
    ev("cuda_runtime", "cudaLaunchKernel", 150, 5),
    ev("cuda_runtime", "cudaDeviceSynchronize", 420, 50),  # the harness's, between calls
    ev("cpu_op", "aten::copy_", 600, 200),
    ev("cuda_runtime", "cudaMemcpy", 610, 10),
    # Device: two overlapping kernels, a copy, and a kernel past the window.
    ev("kernel", "(anonymous namespace)::simplex_cluster_kernel<float>(float*, int*)", 100, 300,
       tid=7),
    ev("kernel", "void at::native::elementwise_kernel<128, 4>()", 300, 200, tid=8),
    ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 900, 50, tid=7),
    # The harness's read-back between calls: busy, but not the program's.
    ev("cuda_runtime", "cudaMemcpyAsync", 920, 5) | {"args": {"correlation": 9}},
    ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 960, 20, tid=7)
    | {"args": {"correlation": 9}},
    ev("kernel", "void simplex_kernel<double>()", 990, 100, tid=7),
]


def test_busy_time_is_the_union_of_device_intervals():
    t = trace.reduce(EVENTS)
    assert t.window_s == pytest.approx(1000e-6)
    # [100, 500), [900, 950), [960, 980) and [990, 1000): 400 + 50 + 20 + 10 microseconds.
    assert t.busy_s == pytest.approx(480e-6)
    assert t.calls == 2


def test_device_time_by_short_name_and_the_port_kernels():
    t = trace.reduce(EVENTS)
    assert t.device_s["simplex_cluster_kernel"] == pytest.approx(300e-6)
    assert t.seconds(r"^simplex(_cluster)?_kernel$") == pytest.approx(310e-6)
    assert t.port_seconds() == pytest.approx(310e-6)
    assert trace.short_name("void at::native::elementwise_kernel<128, 4>()") == \
        "at::native::elementwise_kernel"
    assert trace.short_name("void at::native::(anonymous namespace)::f<int>(int)") == \
        "at::native::f"


def test_device_time_leaves_out_what_was_launched_between_calls():
    t = trace.reduce(EVENTS)
    assert t.device_s["Memcpy DtoH"] == pytest.approx(50e-6)


def test_idle_gaps_go_to_the_host_operation_open_in_them():
    t = trace.reduce(EVENTS)
    # Gaps: [0, 100) mid 50 in aten::nonzero > cudaStreamSynchronize;
    # [500, 900) mid 700 in aten::copy_; [950, 960) and [980, 990) in no
    # operation, after the last call.
    assert t.idle_gaps["cudaStreamSynchronize"] == pytest.approx(100e-6)
    assert t.idle_gaps["aten::copy_"] == pytest.approx(400e-6)
    assert t.idle_gaps["between calls"] == pytest.approx(20e-6)
    top = t.breakdown()
    assert top["idle_gaps"][0][0] == "aten::copy_"
    assert top["device_ops"][0][0] == "simplex_cluster_kernel"


def test_a_gap_in_a_call_with_no_operation_open_is_the_programs_python():
    t = trace.reduce([ev("user_annotation", "bench.window", 0, 100),
                      ev("user_annotation", "bench.call", 0, 100),
                      ev("kernel", "simplex_kernel", 0, 40, tid=7),
                      ev("kernel", "simplex_kernel", 60, 40, tid=7)])
    assert t.idle_gaps == {"python in a call": pytest.approx(20e-6)}


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError, match="bench.window"):
        trace.reduce(EVENTS[1:])
