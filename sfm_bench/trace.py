"""What a traced window read from the profiler: device time by kernel, the
device's busy seconds, and the idle gaps between device work named by
what the host was doing then (the harness's span and the innermost host
operation the profiler saw)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

GAP_NAMES = 2000  # the longest gaps whose host operation is looked up


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def launches(self, pattern=None) -> int:
        return sum(n for k, (n, _) in self.kernels.items()
                   if pattern is None or pattern.search(k))

    def seconds(self, pattern=None) -> float:
        return sum(s for k, (_, s) in self.kernels.items()
                   if pattern is None or pattern.search(k))


def _events(prof, annotations):
    """(device events, host events), each (name, start_us, end_us).  The
    harness's own annotations, which the profiler also lays on the
    device's timeline, are no device work and are left out there."""
    from torch.autograd import DeviceType

    dev, host = [], []
    # The raw events of the finished profile: far quicker than events().
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns() * 1e-3
        ev = (name, s, s + e.duration_ns() * 1e-3)
        if e.device_type() != DeviceType.CUDA:
            host.append(ev)
        elif not (e.is_user_annotation() or name in annotations):
            dev.append(ev)
    return dev, host


def summarise(prof, window: str, spans, top: int = 10) -> Summary:
    """Read a finished `torch.profiler.profile` whose window the host
    event named `window` covers; the host events named in `spans` are the
    harness's spans."""
    dev, host = _events(prof, set(spans) | {window})
    t0_us, t1_us = next((s, e) for n, s, e in host if n == window)
    window_s = (t1_us - t0_us) * 1e-6
    if not dev:
        return Summary(window_s=window_s, busy_s=0.0)
    kernels: Dict[str, List[float]] = {}
    for name, s, e in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-6
    iv = np.array([[max(s, t0_us), min(e, t1_us)] for _, s, e in dev])
    iv = iv[iv[:, 1] > iv[:, 0]]
    iv = iv[np.argsort(iv[:, 0])]
    # Union of the device intervals, and the gaps between them.
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    merged = np.array(merged) if merged else np.zeros((0, 2))
    busy = float(np.sum(merged[:, 1] - merged[:, 0])) * 1e-6
    edges = np.concatenate([[t0_us], merged.reshape(-1), [t1_us]])
    gaps = edges.reshape(-1, 2)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:GAP_NAMES]
    sp = [(n, s, e) for n, s, e in host if n in spans]
    host = [h for h in host if h[0] != window and h[0] not in spans]
    hs = np.array([h[1] for h in host]) if host else np.zeros(0)
    he = np.array([h[2] for h in host]) if host else np.zeros(0)
    named: Dict[str, float] = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        span = next((n for n, a, b in sp if a <= mid <= b), "harness")
        inside = np.flatnonzero((hs <= mid) & (he >= mid))
        op = (host[inside[np.argmin(he[inside] - hs[inside])]][0]
              if len(inside) else "python")
        key = f"{span}/{op}"
        named[key] = named.get(key, 0.0) + (e - s) * 1e-6
    ops = sorted(((k, v[1]) for k, v in kernels.items()), key=lambda x: -x[1])
    return Summary(
        window_s=window_s, busy_s=busy,
        kernels={k: (v[0], v[1]) for k, v in kernels.items()},
        device_ops=ops[:top],
        idle_gaps=sorted(named.items(), key=lambda x: -x[1])[:top])
