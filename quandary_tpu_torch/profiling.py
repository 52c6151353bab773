"""Profiling utilities, the observability layer (the reference's surface is
MPI_Wtime + getrusage + timing.dat, main.cpp:453-487): the counterpart of
quandary_tpu/profiling.py on torch.profiler.

* `timer()` context: wall time and peak RSS, optionally appended to
  timing.dat in the reference's format;
* `trace(dir)` context: a torch.profiler trace (CPU operators, and on a
  CUDA device its kernels, launches and copies) around any block, written
  as a Chrome trace (chrome://tracing, Perfetto); `trace_summary` reads one
  back: launches and device time by kernel and the device's busy and idle
  share of a window;
* `sweep_timer`: synchronous throughput (each repetition ends in a value
  fetch, after torch.cuda.synchronize() on the card).
"""

from __future__ import annotations

import contextlib
import json
import os
import resource
import time
from typing import Callable, Optional

import torch

TRACE_FILE = "trace.json"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def timer(label: str = "", timing_file: Optional[str] = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    msg = f"{label + ': ' if label else ''}{dt:.3f} s, peak RSS {rss_mb:.1f} MB"
    print(msg)
    if timing_file:
        with open(timing_file, "a") as f:
            f.write("%d  %1.8e\n" % (1, dt))


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler around a block: CPU activities, and CUDA ones where a
    CUDA device exists; writes logdir/trace.json (a Chrome trace) on the
    way out and yields logdir."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def trace_summary(logdir: str, window: Optional[str] = None) -> dict:
    """What a `trace` wrote: 'kernels', {name: [launches, device ms]};
    'window_ms', the span of the user annotation named `window`
    (torch.profiler.record_function) or else of all the trace's events;
    'busy_ms', the union of the device's kernel, copy and set intervals
    inside it; 'busy_share' and 'idle_share' of the window."""
    with open(os.path.join(logdir, TRACE_FILE)) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    spans = [e for e in events if window is not None
             and e.get("name") == window and e.get("cat") == "user_annotation"]
    pick = spans or events
    t0 = min(float(e["ts"]) for e in pick)
    t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in pick)
    kernels, busy = {}, []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += (b - a) * 1e-3
        a, b = max(a, t0), min(b, t1)
        if b > a:
            busy.append((a, b))
    busy_us, end = 0.0, t0
    for a, b in sorted(busy):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    window_us = max(t1 - t0, 1e-9)
    return dict(kernels=kernels, window_ms=window_us * 1e-3,
                busy_ms=busy_us * 1e-3, busy_share=busy_us / window_us,
                idle_share=1.0 - busy_us / window_us)


def sweep_timer(fn: Callable, make_args: Callable, reps: int = 10) -> float:
    """Synchronous reps/s of fn(*make_args(i)), forcing a value fetch."""
    _force(fn(*make_args(0)))
    t0 = time.perf_counter()
    for i in range(reps):
        _force(fn(*make_args(i)))
    return reps / (time.perf_counter() - t0)


def _first_tensor(out):
    """The first tensor of a result (nested tuples, lists, dicts)."""
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else \
        out if isinstance(out, (list, tuple)) else ()
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def _force(out):
    leaf = _first_tensor(out)
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    leaf.reshape(-1)[0].item()
