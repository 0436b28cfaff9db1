"""The device trace of a traced run: torch.profiler (Kineto, CUPTI) around
the window, reduced to what the per-layer readers need.

The profiler records the host operations of every thread (the server's
query threads start inside the window) and every device activity of the
process. Its results are read without building the profiler's Python
event tree, which for a window of a few hundred statements takes longer
than the window.
"""

from __future__ import annotations

import bisect
import dataclasses
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from portbench import stats


@dataclasses.dataclass
class DeviceTrace:
    start_ns: int
    end_ns: int
    device: List[Tuple[str, int, int]]  # (name, start_ns, end_ns) of kernels, copies, sets
    h2d_bytes: Optional[int]  # None where a copy's size could not be read
    h2d_count: int
    host: List[Tuple[str, int, int]]  # host operations (name, start_ns, end_ns)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        return stats.union((a, b) for _, a, b in self.device)

    def busy_s(self) -> float:
        return stats.covered(self.busy(), self.start_ns, self.end_ns) / 1e9

    def busy_of(self, names) -> float:
        """Seconds of the window covered by the device operations whose
        name contains one of `names` as a whole word."""
        if not names:
            return 0.0
        pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
        return stats.covered(((a, b) for n, a, b in self.device if pat.search(n)),
                             self.start_ns, self.end_ns) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the innermost host operation running at its
        middle."""
        by_name: Dict[str, int] = defaultdict(int)
        for n, a, b in self.device:
            by_name[n] += b - a
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(stats.gaps(self.busy(), self.start_ns, self.end_ns),
                      key=lambda g: g[0] - g[1])[:top]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [s for _, s, _ in host]
        named = []
        for a, b in gaps:
            mid = (a + b) // 2
            name = "no host operation recorded"
            # the innermost operation running at mid is the latest to start
            # of those that have not ended
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - 20_000), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            named.append([name, (b - a) / 1e9])
        return {"device_ops": [[n, t / 1e9] for n, t in ops], "idle_gaps": named}


class Profiler:
    """Start and stop Kineto around the window; `stop()` gives a DeviceTrace."""

    def __init__(self):
        self._low_level = True
        self._prof = None
        self._t0 = None

    def start(self) -> None:
        import time

        import torch
        from torch.autograd import ProfilerActivity

        acts = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        # every thread's host operations, and the copies' byte counts in
        # the events' metadata, where this torch has the options
        for opts in ({"profile_all_threads": True, "expose_kineto_event_metadata": True},
                     {"profile_all_threads": True}):
            try:
                from torch._C._profiler import _ExperimentalConfig
                from torch.autograd import (ProfilerConfig, ProfilerState, _enable_profiler,
                                            _prepare_profiler)

                cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                     _ExperimentalConfig(**opts))
                _prepare_profiler(cfg, acts)
                _enable_profiler(cfg, acts)
                break
            except (ImportError, TypeError, RuntimeError):
                continue
        else:
            # an older torch: the public profiler, which records the host
            # operations of the calling thread only
            self._low_level = False
            self._prof = torch.profiler.profile(activities=list(acts))
            self._prof.__enter__()
        self._t0 = time.time_ns()

    def stop(self) -> DeviceTrace:
        import time

        t1 = time.time_ns()
        if self._low_level:
            from torch.autograd import _disable_profiler

            result = _disable_profiler()
        else:
            self._prof.__exit__(None, None, None)
            result = self._prof.profiler.kineto_results
        return _reduce(result, self._t0, t1)


def _reduce(result, t0_ns: int, t1_ns: int) -> DeviceTrace:
    device, host, h2d, n_h2d = [], [], 0, 0
    for e in result.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            device.append((name, start, end))
            if "HtoD" in name:
                n = _bytes(e)
                h2d = None if h2d is None or n is None else h2d + n
                n_h2d += 1
        else:
            host.append((name, start, end))
    # the profiler's clock is the host's wall clock in ns; bound the window
    # by the first and last event where the clocks disagree
    lo = min([t0_ns] + [a for _, a, _ in device])
    hi = max([t1_ns] + [b for _, _, b in device])
    return DeviceTrace(lo, hi, device, h2d, n_h2d, host)


def _bytes(e) -> Optional[int]:
    """A copy's bytes from the event's metadata; None where it has none."""
    try:
        import json

        meta = json.loads("{" + e.metadata_json() + "}")
        return int(meta["bytes"])
    except (AttributeError, TypeError, ValueError, KeyError):
        return None


def port_kernel_names(package_dir: str) -> List[str]:
    """The names of the port's own kernels: every __global__ function in
    its csrc/*.cu."""
    names = []
    csrc = os.path.join(package_dir, "csrc")
    lb = r"(?:__launch_bounds__\([^)]*\)\s+)?"
    pat = re.compile(r"__global__\s+" + lb + r"void\s+" + lb + r"(\w+)\s*\(")
    for fn in sorted(os.listdir(csrc)) if os.path.isdir(csrc) else ():
        if fn.endswith(".cu"):
            with open(os.path.join(csrc, fn)) as f:
                names += pat.findall(f.read())
    return sorted(set(names))

