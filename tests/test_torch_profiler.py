"""The port's trace helpers (``dlrover_tpu_torch/utils/profiler.py``):
the body range of ``device_trace`` and the launches of that body the
profiler kept no device record of, on the CPU."""

from types import SimpleNamespace

import pytest
import torch

from dlrover_tpu_torch.utils.profiler import (
    BODY_RANGE,
    device_kernels,
    device_records,
    device_trace,
    launches_without_record,
)

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def event(name, device, corr, start, end=None):
    return SimpleNamespace(name=name, device_type=device, id=corr,
                           time_range=SimpleNamespace(
                               start=start, end=start if end is None
                               else end))


def trace(lost):
    """Two launches before a body range at 10-100 that holds a kernel
    launch, a copy, a memset and a call that launches nothing (in no
    time order); the launches of ``lost`` (correlation ids) have no
    device record."""
    calls = [("cudaLaunchKernel", 1, 0), ("cudaLaunchKernel", 2, 1),
             ("cudaMemsetAsync", 5, 40), ("cudaLaunchKernel", 3, 20),
             ("cudaMemcpyAsync", 4, 30), ("cudaStreamSynchronize", 6, 50)]
    events = [event(BODY_RANGE, CPU, 0, 10, 100),
              event("aten::add", CPU, 0, 19, 21)]
    for name, corr, t in calls:
        events.append(event(name, CPU, corr, t))
        if corr not in lost and name != "cudaStreamSynchronize":
            events.append(event(f"kernel{corr}", CUDA, corr, t + 5))
    return events


@pytest.mark.parametrize("lost, want", [
    ((), []),
    ((1, 2), []),
    ((1, 3), [0]),
    ((3, 4, 5), [0, 1, 2]),
    ((5,), [2]),
])
def test_launches_without_record_counts_the_body(lost, want):
    assert launches_without_record(trace(set(lost))) == (3, want)


def test_device_records_by_correlation_id():
    assert device_records(trace({2, 4})) == {
        1: "kernel1", 3: "kernel3", 5: "kernel5"}


def test_device_trace_marks_its_body(monkeypatch):
    """On the CPU the body runs inside ``BODY_RANGE``; ``device_kernels``
    keeps the device entries with time and drops user ranges."""
    with device_trace() as prof:
        torch.ones(8).add_(1)
    names = [e.name for e in prof.events()]
    assert BODY_RANGE in names and "aten::add_" in names
    body = [e for e in prof.events() if e.name == BODY_RANGE][0]
    add = [e for e in prof.events() if e.name == "aten::add_"][0]
    assert body.time_range.start <= add.time_range.start <= body.time_range.end
    entry = lambda key, t=1.0, user=False: SimpleNamespace(  # noqa: E731
        key=key, device_type=CUDA, self_device_time_total=t,
        is_user_annotation=user)
    fake = [entry("gemm"), entry("idle", t=0.0),
            entry(BODY_RANGE, user=True)]
    monkeypatch.setattr(prof, "key_averages", lambda: fake)
    assert [e.key for e in device_kernels(prof)] == ["gemm"]
