"""The device trace of a traced run, and its reduction.

``DeviceTrace`` runs ``torch.profiler`` with CUDA activity only (no CPU
operator events: at ~10⁶ launches a solve they would double the events and
slow every launch) over the traced window and keeps no chrome trace: the
kernel intervals are read from the profiler's in-memory results.  Device
times are put on the host's ``perf_counter_ns`` clock by a marker kernel
(``torch.cuda._sleep``, symbol ``spin_kernel``) launched at a known host
time just before the window and just after it, or, where a marker's record
is missing, by the system clock the profiler stamps its records with.

The reductions are plain functions of interval lists, so the CPU tests hold
their arithmetic.
"""

from __future__ import annotations

import time

import numpy as np

MARK = "spin_kernel"


def union_seconds(starts, ends, lo, hi) -> float:
    """Length of the union of ``[starts, ends)`` clipped to ``[lo, hi)``, in
    the intervals' unit."""
    s = np.clip(np.asarray(starts, dtype=np.float64), lo, hi)
    e = np.clip(np.asarray(ends, dtype=np.float64), lo, hi)
    if s.size == 0:
        return 0.0
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    # An interval starts a new run where it begins after every earlier end.
    new = np.concatenate([[True], s[1:] > reach[:-1]])
    run_id = np.cumsum(new) - 1
    run_start = s[new]
    run_end = np.zeros(run_start.size)
    np.maximum.at(run_end, run_id, e)
    return float((run_end - run_start).sum())


def idle_gaps(starts, ends, lo, hi):
    """The gaps ``(start, end)`` inside ``[lo, hi)`` that no interval covers."""
    s = np.clip(np.asarray(starts, dtype=np.float64), lo, hi)
    e = np.clip(np.asarray(ends, dtype=np.float64), lo, hi)
    if s.size == 0:
        return [(float(lo), float(hi))] if hi > lo else []
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    # Before interval i the card is covered up to reach[i]: lo, then the
    # running maximum of the earlier ends.
    reach = np.concatenate([[lo], np.maximum(np.maximum.accumulate(e), lo)])
    gap = s > reach[:-1]
    gaps = list(zip(reach[:-1][gap].tolist(), s[gap].tolist()))
    if hi > reach[-1]:
        gaps.append((float(reach[-1]), float(hi)))
    return gaps


def label_gaps(gaps, spans, default="loop"):
    """Idle seconds by what the host was doing: the name of the span that
    holds the gap's midpoint, else ``default``.  ``spans`` are ``(name,
    start, end)`` on the gaps' clock; returns ``{label: total}``."""
    if not gaps:
        return {}
    g = np.asarray(gaps, dtype=np.float64)
    mid, length = g.mean(axis=1), g[:, 1] - g[:, 0]
    labels = sorted({n for n, _, _ in spans} | {default})
    code = np.full(len(g), labels.index(default))
    if spans:
        order = sorted(range(len(spans)), key=lambda i: spans[i][1])
        st = np.asarray([spans[i][1] for i in order], dtype=np.float64)
        en = np.asarray([spans[i][2] for i in order], dtype=np.float64)
        lab = np.asarray([labels.index(spans[i][0]) for i in order])
        i = np.searchsorted(st, mid, side="right") - 1
        inside = (i >= 0) & (en[np.maximum(i, 0)] >= mid)
        code = np.where(inside, lab[np.maximum(i, 0)], code)
    totals = np.zeros(len(labels))
    np.add.at(totals, code, length)
    return {labels[k]: float(v) for k, v in enumerate(totals) if v > 0}


def top(totals: dict, n: int = 10):
    """The ``n`` largest ``[name, value]`` pairs of ``totals``."""
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


class DeviceTrace:
    """``torch.profiler`` over a window, with the host-clock calibration."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.marks = []   # perf_counter_ns of each marker's launch
        self.clock = []   # time_ns − perf_counter_ns at each marker

    def _mark(self):
        self.torch.cuda.synchronize()
        self.marks.append(time.perf_counter_ns())
        self.clock.append(time.time_ns() - self.marks[-1])
        self.torch.cuda._sleep(1000)
        self.torch.cuda.synchronize()

    def __enter__(self):
        self.prof.__enter__()
        self._mark()
        return self

    def __exit__(self, *exc):
        self._mark()
        self.prof.__exit__(*exc)
        return False

    def kernels(self):
        """Device intervals ``(names, starts_ns, ends_ns)`` on the host's
        ``perf_counter_ns`` clock, markers left out."""
        DeviceType = self.torch.autograd.DeviceType
        names, starts, ends = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            names.append(e.name())
            starts.append(e.start_ns())
            ends.append(e.end_ns())
        starts = np.asarray(starts, dtype=np.float64)
        ends = np.asarray(ends, dtype=np.float64)
        mark = [i for i, n in enumerate(names) if MARK in n]
        clock = -float(np.mean(self.clock))
        if len(mark) == len(self.marks):
            # Host time of each marker's launch minus the marker's device start.
            offset = float(np.mean([h - starts[i] for h, i in zip(self.marks, mark)]))
        else:   # a marker's record is missing: the system clock, which the profiler uses
            offset = clock
        keep = np.ones(len(names), dtype=bool)
        keep[mark] = False
        names = [n for n, k in zip(names, keep) if k]
        self.summary = (f"device trace: {len(names)} records, {len(mark)} of "
                        f"{len(self.marks)} markers, marker offset − clock offset "
                        f"{(offset - clock) / 1e3:.1f} us, records from "
                        f"{(starts[keep].min() + offset - self.marks[0]) / 1e9 if keep.any() else 0:.3f} s "
                        f"to {(ends[keep].max() + offset - self.marks[-1]) / 1e9 if keep.any() else 0:.3f} s "
                        f"about the first and last marker")
        return names, starts[keep] + offset, ends[keep] + offset
