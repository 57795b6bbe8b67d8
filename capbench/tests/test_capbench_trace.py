"""Reading a trace: wholeness by correlation id, busy time, idle gaps."""

import torch

from capbench import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, dev, corr, start, end, annotation=False):
        self._n, self._d, self._c = name, dev, corr
        self._s, self._e, self._a = start, end, annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def is_user_annotation(self):
        return self._a


def window_events(drop_record=False, drop_launch=False):
    ev = [Ev("cudaLaunchKernel", CPU, 1, 0, 1),
          Ev("trunc_kernel", CUDA, 1, 1, 2),
          Ev(trace.WINDOW, CPU, 0, 10, 110, annotation=True),
          Ev(trace.WINDOW, CUDA, 0, 10, 110, annotation=True),
          Ev("capbench.step", CPU, 0, 10, 60, annotation=True),
          Ev("capbench.submit", CPU, 0, 60, 110, annotation=True),
          Ev("Memcpy HtoD", CUDA, 5, 15, 20)]
    if not drop_launch:
        ev.append(Ev("cudaLaunchKernel", CPU, 2, 11, 12))
    if not drop_record:
        ev.append(Ev("k5_kernel", CUDA, 2, 20, 40))
    ev += [Ev("cudaLaunchKernel", CPU, 3, 41, 42),
           Ev("gemm_kernel", CUDA, 3, 30, 50)]
    return ev


def test_a_whole_trace_has_every_launch_and_record():
    assert trace.launch_check(window_events()) == (0, 0)


def test_a_lost_record_or_launch_is_seen():
    assert trace.launch_check(window_events(drop_record=True)) == (1, 0)
    assert trace.launch_check(window_events(drop_launch=True)) == (0, 1)


def test_busy_is_the_union_of_device_records_inside_the_window():
    s = trace.summary(window_events())
    assert s["window_s"] == 100e-9
    # [15, 20) and [20, 50): 35 ns; the span's copy on the device is no work.
    assert s["busy_s"] == 35e-9
    assert s["device_ops"][0] == ["k5_kernel", 20e-9]
    # Idle [10, 15) under capbench.step and [50, 110): its middle (80) in
    # capbench.submit.
    assert dict(s["idle_gaps"]) == {"capbench.submit": 60e-9,
                                    "capbench.step": 5e-9}
