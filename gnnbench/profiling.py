"""Reading torch.profiler: device records by kernel name, the device's
merged busy time, the idle gaps with the host operation open in each, and
the device time under a ``record_function`` span.

A copy of ``chip_smoke.py``'s ``device_ops`` and ``complete_profile``,
reworked to keep every record's interval: torch.profiler has returned
sessions with device records missing late in a process, so a slice whose
records are incomplete is taken again, up to three times, and reads "not
measured" after the third.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch


@dataclass
class Slice:
    """One profiled call: its wall seconds, every device record as (name,
    start us, end us), every host record as (name, start us, end us), and
    the device us under each host op or span (``key_averages``)."""

    wall_s: float
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    under: Dict[str, Tuple[int, float]] = field(default_factory=dict)

    def kernel_us(self, needle: str) -> Tuple[int, float]:
        """(records, device us) of the device records whose name holds
        ``needle``."""
        hits = [e - s for n, s, e in self.device if needle in n]
        return len(hits), float(sum(hits))

    def busy_us(self) -> float:
        """The union of the device records' intervals."""
        busy, end = 0.0, float("-inf")
        for _, s, e in sorted(self.device, key=lambda r: r[1]):
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def by_name(self) -> List[Tuple[str, float]]:
        """Device seconds by record name, most first."""
        tot: Dict[str, float] = {}
        for n, s, e in self.device:
            tot[n] = tot.get(n, 0.0) + (e - s)
        return sorted(((n, us / 1e6) for n, us in tot.items()), key=lambda r: -r[1])

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The longest gaps between the device's busy intervals, each named
        by the innermost host record open at its middle, or else "after"
        the host record that ended last before it."""
        ivs = sorted(self.device, key=lambda r: r[1])
        gaps, end = [], None
        for _, s, e in ivs:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = 0.5 * (a + b)
            open_ = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            if open_:
                out.append((min(open_)[1], (b - a) / 1e6))
                continue
            # the host ran code outside any torch op: name what it last ended
            done = [(e, n) for n, s, e in self.host if e <= mid]
            out.append((f"after {max(done)[1]}" if done else "(no host record)", (b - a) / 1e6))
        return out


def _interval(ev) -> Optional[Tuple[float, float]]:
    """A kineto record's (start, end) in us, across torch versions."""
    for start, dur, scale in (("start_ns", "duration_ns", 1e-3), ("start_us", "duration_us", 1.0)):
        if hasattr(ev, start):
            s = getattr(ev, start)() * scale
            return s, s + getattr(ev, dur)() * scale
    return None


def profile_call(fn: Callable[[], object]) -> Slice:
    """torch.profiler over one call of ``fn``, which ends in a device
    synchronise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        iv = _interval(ev)
        if iv is None:
            continue
        (dev if ev.device_type() != DeviceType.CPU else host).append((ev.name(), *iv))
    # a record_function span shows on the device's timeline too, from its
    # first kernel to its last: it is no device work
    spans = {n for n, _, _ in host}
    dev = [r for r in dev if r[0] not in spans]
    under = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CPU"):
            under[e.key] = (e.count, float(getattr(e, "device_time_total", 0.0)))
    return Slice(wall_s=wall, device=dev, host=host, under=under)


def complete_slice(fn: Callable[[], object], complete: Callable[[Slice], bool],
                   tries: int = 3) -> Optional[Slice]:
    """``profile_call(fn)``, taken again while ``complete`` finds records
    missing, up to ``tries`` times; None after the last."""
    for _ in range(tries):
        sl = profile_call(fn)
        if complete(sl):
            return sl
    return None
