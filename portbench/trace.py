"""The device trace of whole calls, and what the per-layer readers take from it.

``profile_calls`` runs a number of whole calls under ``torch.profiler``
(CPU and CUDA activities) with a sampler of the host's Python stack beside
it, and returns a :class:`Trace`: the device's kernel, copy and fill
intervals, the host's kernel launches, the calls' own intervals, and which
function of the program the host was in at each sample. The busy time is
the union of the device intervals inside the traced window; an idle gap is
named by the function most of its host samples were in.

``DeviceClock`` takes the device's busy time alone over a measured window
(the profiler's CUDA activity, no host operators, no sampler).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import sys
import threading
import time

import torch

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
CALL = "portbench.call"
PACKAGE = "lammps_analysis_tpu_torch"
#: seconds between two samples of the host's stack
SAMPLE_PERIOD = 2e-4


@dataclasses.dataclass
class Trace:
    n_calls: int
    window: tuple  # (start, end) us, first call's start to last call's end
    device: list  # (start, end, name) us of kernels, copies and fills, sorted
    launches: int  # kernel launches the host made in the window
    host: list = dataclasses.field(default_factory=list)  # (us, function) samples

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list:
        """The union of the device intervals, clipped to the window."""
        lo, hi = self.window
        out = []
        for start, end, _ in self.device:
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            if out and start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([start, end])
        return out

    def busy_us(self) -> float:
        return sum(end - start for start, end in self.busy_intervals())

    def kernel_us(self, *parts: str) -> float:
        """Device time of the kernels whose names hold one of ``parts``."""
        lo, hi = self.window
        return sum(
            min(end, hi) - max(start, lo)
            for start, end, name in self.device
            if any(p in name for p in parts) and min(end, hi) > max(start, lo)
        )

    def device_ops(self, top: int = 10) -> list:
        """``[[name, seconds]]``: device time by kernel, largest first."""
        total = collections.Counter()
        for start, end, name in self.device:
            total[short_name(name)] += (end - start) / 1e6
        return [[name, s] for name, s in total.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """``[[host function, seconds]]``: the device's idle time inside the
        window, by what the host was doing, largest first."""
        busy = self.busy_intervals()
        edges = [self.window[0]] + [t for iv in busy for t in iv] + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        times = [t for t, _ in self.host]
        total = collections.Counter()
        for start, end in gaps:
            lo, hi = bisect.bisect_left(times, start), bisect.bisect_right(times, end)
            names = collections.Counter(name for _, name in self.host[lo:hi])
            name = names.most_common(1)[0][0] if names else "(between two samples)"
            total[name] += (end - start) / 1e6
        return [[name, s] for name, s in total.most_common(top)]


def short_name(name: str) -> str:
    """A kernel's name without namespaces, template arguments or parameters."""
    short = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    short = short.split()[-1].split("::")[-1] if short.split() else ""
    return short[-60:] or name[:60]


def describe(frame) -> str:
    """The innermost function of the program on a stack, else the innermost."""
    innermost = frame
    while frame is not None:
        path = frame.f_code.co_filename
        if PACKAGE in path:
            module = path.split(PACKAGE, 1)[1].strip("/").removesuffix(".py").replace("/", ".")
            return f"{module}.{frame.f_code.co_name}"
        frame = frame.f_back
    if innermost is None:
        return "(no frame)"
    return f"{innermost.f_code.co_filename.rsplit('/', 1)[-1]}:{innermost.f_code.co_name}"


class HostSampler:
    """Samples which function the main thread is in, every ``SAMPLE_PERIOD``."""

    def __init__(self):
        self.thread_id = threading.main_thread().ident
        self.samples: list = []  # (perf_counter_ns, function)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            frame = sys._current_frames().get(self.thread_id)
            self.samples.append((time.perf_counter_ns(), describe(frame)))
            time.sleep(SAMPLE_PERIOD)

    def __enter__(self):
        self._interval = sys.getswitchinterval()
        sys.setswitchinterval(SAMPLE_PERIOD / 2)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        sys.setswitchinterval(self._interval)


def device_intervals(events) -> list:
    """``(start, end, name)`` us of the device's kernels, copies and fills
    among the profiler's events, sorted."""
    from torch.autograd import DeviceType

    return sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in events
        if e.device_type == DeviceType.CUDA and not e.name.startswith("portbench.")
    )


def busy_us(device: list) -> float:
    """The union of ``device`` intervals, whole; 0 where there are none."""
    if not device:
        return 0.0
    window = (device[0][0], max(end for _, end, _ in device))
    return Trace(n_calls=0, window=window, device=device, launches=0).busy_us()


class DeviceClock:
    """The device's busy time over a stretch of host work: ``torch.profiler``
    with the CUDA activity alone (kernels, copies and fills as the card
    timed them; no host operators recorded), the union of its intervals."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)

    def busy_us(self) -> float:
        return busy_us(device_intervals(self._prof.events()))


def profile_calls(call, n_calls: int, attempts: int = 3) -> Trace:
    """``n_calls`` whole calls under the profiler. A window in which the
    profiler saw no device event is profiled again, up to ``attempts`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(attempts):
        torch.cuda.synchronize()
        marks = []
        with HostSampler() as sampler:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n_calls):
                    with record_function(CALL):
                        marks.append(time.perf_counter_ns())
                        call()
                        torch.cuda.synchronize()
        events = prof.events()
        calls = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.name == CALL and e.device_type == DeviceType.CPU)
        window = (calls[0][0], calls[-1][1])
        device = device_intervals(events)
        launches = sum(1 for e in events if e.name in LAUNCHES
                       and window[0] <= e.time_range.start <= window[1])
        # the profiler's clock against perf_counter, from the calls' starts
        offset = sum(c[0] - m / 1e3 for c, m in zip(calls, marks)) / len(calls)
        host = [(t / 1e3 + offset, name) for t, name in sampler.samples]
        trace = Trace(n_calls=n_calls, window=window, device=device, launches=launches, host=host)
        if trace.busy_us() > 0:
            return trace
    return trace
