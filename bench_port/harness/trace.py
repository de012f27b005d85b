"""Reading one traced episode from torch.profiler (CUPTI): the device
intervals, their union (busy time), kernel times by name and the idle gaps
named by what the host was doing in them.

The union of device intervals replaces profile_port.py:117-150, which
divided the kernel time of 10 traced steps by the host-clock time of 20
other steps; here busy time and window are taken over the same traced
episode. Only CUDA activity is recorded (kernels, copies, sets, and the
host's CUDA runtime calls where the torch release keeps them), which
keeps the tracer's own cost on the host small; the events are read from
the profiler's result in memory and no trace file is written."""

from __future__ import annotations


def _span(e):
    """(start, end) in ns, from whichever the torch release offers."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return 1000 * e.start_us(), 1000 * (e.start_us() + e.duration_us())


def short_name(name: str) -> str:
    """A kernel's name without its trailing parameter list, at most 120
    characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:120].strip()


class Trace:
    """The device and host-runtime events of one profiled region."""

    def __init__(self, events):
        self.device = []      # (start_ns, end_ns, name)
        self.runtime = []     # (start_ns, end_ns, name)
        for e in events:
            s, t = _span(e)
            if "cuda" in str(e.device_type()).lower():
                self.device.append((s, t, e.name()))
            elif e.name().startswith("cuda"):
                self.runtime.append((s, t, e.name()))
        self.device.sort()
        self.runtime.sort()

    @classmethod
    def from_profiler(cls, prof):
        return cls(prof.profiler.kineto_results.events())

    def kernels(self):
        """[(name, seconds)] of every kernel."""
        return [(n, (t - s) * 1e-9) for s, t, n in self.device
                if not n.startswith(("Memcpy", "Memset"))]

    def merged(self):
        """The union of the device intervals, as sorted disjoint spans."""
        out = []
        for s, t, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.merged()) * 1e-9

    def device_ops(self, top=10):
        """The device operations that took most time, summed by name."""
        tot: dict = {}
        for s, t, n in self.device:
            k = short_name(n)
            tot[k] = tot.get(k, 0.0) + (t - s) * 1e-9
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top=10):
        """Idle device time between busy spans, summed by what the host
        was doing: the host runtime call that overlaps the gap most where
        the trace holds one, else the host's own work before the device
        operation that ends the gap ("host before <op>")."""
        spans = self.merged()
        nxt = {}
        for s, _, n in self.device:
            nxt.setdefault(s, n)
        tot: dict = {}
        rt = self.runtime
        j = 0
        for (_, a), (b, _) in zip(spans, spans[1:]):
            while j < len(rt) and rt[j][1] <= a:
                j += 1
            best, name = 0, "host before " + short_name(nxt.get(b, ""))[:80]
            i = j
            while i < len(rt) and rt[i][0] < b:
                ov = min(b, rt[i][1]) - max(a, rt[i][0])
                if ov > best:
                    best, name = ov, "host: " + rt[i][2]
                i += 1
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-9
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda x: -x[1])[:top]
