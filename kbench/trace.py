"""Reading the traced run's profiler trace (`torch.profiler`, exported
as a Chrome trace): the device's operations (kernels, copies, memsets)
inside the window, the benchmark's host ranges (`spans`), and each
device operation's launch on the host, joined by the CUDA correlation
id, so that device time can be summed by the host range that launched
it."""

import bisect
import json
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
WINDOW = "kbench.window"
NAME_CHARS = 160        # of a kernel's name in the breakdown


class Trace:
    """ops: [(name, start_us, end_us, launch_us or None)] of the device,
    clipped to the window; ranges: {name: sorted [(start_us, end_us)]}
    of the `kbench.*` host ranges; t0, t1: the window."""

    def __init__(self, events):
        launches, dev = {}, []
        self.ranges = defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            ts, dur = float(e["ts"]), float(e.get("dur", 0))
            if cat in DEVICE_CATS:
                dev.append((e["name"], ts, ts + dur,
                            e.get("args", {}).get("correlation")))
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = ts
            elif cat == "user_annotation" and e["name"].startswith("kbench."):
                self.ranges[e["name"]].append((ts, ts + dur))
        for r in self.ranges.values():
            r.sort()
        (self.t0, self.t1), = self.ranges[WINDOW]
        self.ops = sorted(
            (name, max(s, self.t0), min(t, self.t1), launches.get(corr))
            for name, s, t, corr in dev if t > self.t0 and s < self.t1)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self):
        """The union of the device's operations, as sorted intervals."""
        out = []
        for _name, s, t, _l in sorted(self.ops, key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    @property
    def busy_s(self):
        return sum(t - s for s, t in self.busy_intervals()) / 1e6

    def _range_at(self, name, t):
        """The range called `name` that holds host time t, or None."""
        r = self.ranges.get(name, ())
        i = bisect.bisect_right(r, (t, float("inf"))) - 1
        return r[i] if i >= 0 and r[i][0] <= t <= r[i][1] else None

    def device_s_in(self, name):
        """Seconds of device operations launched inside host ranges
        `kbench.<name>`; None where no operation was."""
        found = [t - s for _n, s, t, launch in self.ops
                 if launch is not None
                 and self._range_at(f"kbench.{name}", launch)]
        return sum(found) / 1e6 if found else None

    def host_label(self, t):
        """The innermost benchmark range the host was in at time t."""
        best, start = "outside any span", None
        for name in self.ranges:
            r = self._range_at(name, t) if name != WINDOW else None
            if r is not None and (start is None or r[0] > start):
                best, start = name, r[0]
        return best

    def breakdown(self, top=10):
        """The device operations that took the most time, by name, and
        the device's idle time in the window by what the host was doing
        (the innermost benchmark span at each gap's middle), each
        [name, seconds], longest first."""
        by_op = defaultdict(float)
        for name, s, t, _l in self.ops:
            by_op[name[:NAME_CHARS]] += (t - s) / 1e6
        idle = defaultdict(float)
        prev = self.t0
        for s, t in self.busy_intervals() + [[self.t1, self.t1]]:
            if s > prev:
                idle[self.host_label((prev + s) / 2)] += (s - prev) / 1e6
            prev = max(prev, t)
        return {"device_ops": _top(by_op, top), "idle_gaps": _top(idle, top)}


def _top(d, n):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
