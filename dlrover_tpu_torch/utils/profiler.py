"""Step statistics and MFU for the port — the part of
``dlrover_tpu/utils/profiler.py`` the trainer uses: the device's peak
FLOP/s, ``StepStats`` and ``PhaseBreakdown``; ``CopyClock``, which
times host-device copies ("offload" remat and the offloaded optimizer);
and ``device_trace``, a torch.profiler trace of the host and the card,
with the count of its launches the profiler kept no device record of.
Module cost analysis comes with the observability slice.
"""

import contextlib
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch

# Peak dense bf16 tensor-core FLOP/s by device-name substring (NVIDIA's
# data sheets, SXM parts, no sparsity).
_PEAK_FLOPS = (
    ("h100", 989e12),
    ("h200", 989e12),
)


def device_peak_flops(device: Optional[torch.device] = None) -> float:
    """Published bf16 dense peak of a CUDA device; 0.0 when unknown or
    not a card (MFU is then not reported)."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(device).lower()
    for key, peak in _PEAK_FLOPS:
        if key in name:
            return peak
    return 0.0


def mfu(tokens_per_s: float, flops_per_token: float, peak: float) -> float:
    """Model FLOP utilization; 0.0 when the peak is unknown."""
    return tokens_per_s * flops_per_token / peak if peak else 0.0


class StepStats:
    """Bounded step-time accumulator: the ``window`` newest samples;
    ``count`` is the total number of observations."""

    def __init__(self, window: int = 1024):
        self.times: deque = deque(maxlen=window)
        self._total = 0
        self._window_sum = 0.0

    def add(self, dt: float):
        if len(self.times) == self.times.maxlen:
            self._window_sum -= self.times[0]
        self.times.append(dt)
        self._window_sum += dt
        self._total += 1

    @property
    def count(self) -> int:
        return self._total

    @property
    def mean(self) -> float:
        return self._window_sum / len(self.times) if self.times else 0.0

    def percentile(self, p: float) -> float:
        if not self.times:
            return 0.0
        xs = sorted(self.times)
        idx = min(len(xs) - 1, int(p / 100 * len(xs)))
        return xs[idx]


class PhaseBreakdown:
    """Per-step wall time split into input / compute / collective /
    readback from host segments the loop measures anyway (no extra
    syncs). The collective share is the lag-1 fence's excess over its
    rolling minimum; compute is dispatch plus that floor."""

    KEYS = ("input_s", "compute_s", "collective_s", "readback_s")

    def __init__(self, window: int = 256, fence_window: int = 16):
        self._fences: deque = deque(maxlen=fence_window)
        self.stats: Dict[str, StepStats] = {
            k: StepStats(window) for k in self.KEYS
        }
        self.last: Dict[str, float] = {}

    def split(self, input_s: float, dispatch_s: float, fence_s: float,
              readback_s: float = 0.0) -> Dict[str, float]:
        self._fences.append(fence_s)
        base = min(self._fences)
        collective = max(0.0, fence_s - base)
        phases = {
            "input_s": input_s,
            "compute_s": dispatch_s + (fence_s - collective),
            "collective_s": collective,
            "readback_s": readback_s,
        }
        for k, v in phases.items():
            self.stats[k].add(v)
        self.last = phases
        return phases


class CopyClock:
    """Bytes and device ms of copies, by way ("out" to the host, "in" to
    the device), timed with a CUDA event pair each batch of copies (none
    on the CPU: bytes only). Pairs that have ended fold into the totals
    as new ones come, so a long run keeps only those in flight."""

    WAYS = ("out", "in")

    def __init__(self):
        self._reset()

    def _reset(self):
        self._bytes = dict.fromkeys(self.WAYS, 0)
        self._ms = dict.fromkeys(self.WAYS, 0.0)
        self._pending: deque = deque()

    def events(self, device: torch.device):
        """A (start, end) event pair for a batch on ``device``'s card, or
        (None, None) on the CPU."""
        if device.type != "cuda":
            return None, None
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def add(self, way: str, nbytes: int, start=None, end=None):
        self._bytes[way] += nbytes
        if start is not None:
            self._pending.append((way, start, end))
        self._fold(block=False)

    def _fold(self, block: bool):
        while self._pending and (block or self._pending[0][2].query()):
            way, start, end = self._pending.popleft()
            end.synchronize()
            self._ms[way] += start.elapsed_time(end)

    def take(self) -> Dict[str, float]:
        """``{"out_bytes", "out_ms", "in_bytes", "in_ms"}``: the bytes
        copied each way and the copies' device ms (0 on the CPU) since the
        last call (waits for the copies in flight), then starts again."""
        self._fold(block=True)
        out = {}
        for way in self.WAYS:
            out[f"{way}_bytes"] = self._bytes[way]
            out[f"{way}_ms"] = self._ms[way]
        self._reset()
        return out


# torch.profiler (Kineto over CUPTI) on an H100 can keep no device record
# of the first launches of a trace: none in a process's first traces, then
# more as traces follow, with returns to none; a pad of launches at the
# trace's start, or in a warm-up cycle of the profiler's schedule, does
# not stop it (``utils/trace_probe.py``). A count of device records can
# therefore fall short, where the host's side of the trace, the calls
# that launch, is whole.

# The traced work: a host range around the body of ``device_trace``.
BODY_RANGE = "device_trace.body"
# Host calls that put work on the card, each with one device record.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


@contextlib.contextmanager
def device_trace():
    """``torch.profiler.profile`` of the host and the card, yielded; the
    body runs inside the host range ``BODY_RANGE``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(BODY_RANGE):
            yield prof


def device_kernels(prof):
    """The device entries of ``prof.key_averages()`` with device time,
    without the user ranges' own."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def device_records(events) -> Dict[int, str]:
    """The device records of a trace's events (``prof.events()``): kernel
    or copy name by correlation id, the id of the host call that put it on
    the card."""
    cuda = torch.autograd.DeviceType.CUDA
    return {e.id: e.name for e in events if e.device_type == cuda}


def launches_without_record(events) -> Tuple[int, List[int]]:
    """``(calls, lost)``: how many calls of ``LAUNCH_CALLS`` the body of
    ``device_trace`` made, and the places, in time order, of those whose
    device record the profiler did not keep."""
    cpu = torch.autograd.DeviceType.CPU
    kept = device_records(events)
    body = [e.time_range for e in events
            if e.name == BODY_RANGE and e.device_type == cpu]
    calls = sorted((e for e in events if e.device_type == cpu
                    and e.name in LAUNCH_CALLS
                    and any(r.start <= e.time_range.start <= r.end
                            for r in body)),
                   key=lambda e: e.time_range.start)
    return len(calls), [i for i, e in enumerate(calls) if e.id not in kept]
