"""Device timing shared by the port's drivers and `chip_smoke.py`.

Times come from CUDA events or the profiler's device activity, never from
the host clock alone (torch returns before the device finishes).  Three
readings:

  - `time_cold`: median device time of single calls with the L2 cache
    flushed before each (a 256 MB write, five times the H100's 50 MB L2),
    as a caller finds the inputs after other work; the L2 is then full of
    dirty lines, which a call that evicts them writes back.  With `clean`
    the flush reads the 256 MB instead and leaves nothing to write back;
  - `time_warm`: mean time of back-to-back calls, host launch cost
    included, inputs possibly in L2;
  - `device_busy_share`: the device kernels' own time per call beside the
    wall time, from torch.profiler (where the host cannot keep the card
    busy, the two differ).

`turns` compares a kernel with its plain version in one process, in the
order plain, kernel, kernel, plain, so drift shows up in the pairs.  Every
printed time carries `card_line()`, the card's name and power limit.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

L2_FLUSH_BYTES = 256 << 20
# the H100 SXM's device-memory rate (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bound_ms(nbytes: int) -> float:
    """The least time the card could take to move `nbytes` once: a
    kernel's bound where bytes, not operations, limit it."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def flush_buffer(device) -> torch.Tensor:
    """The scratch tensor `time_cold` writes to flush the L2 cache."""
    return torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=device)


def time_cold(fn, iters: int, flush: torch.Tensor,
              clean: bool = False) -> float:
    """Median ms of `fn` with the L2 cache flushed before each call: by
    writing `flush` (the L2 is left dirty) or, with `clean`, by reading
    it."""
    times = []
    for _ in range(iters):
        if clean:
            flush.sum()
        else:
            flush.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_warm(fn, iters: int) -> float:
    """Mean ms of `fn` over back-to-back calls (inputs may sit in L2)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernel_times(fn, iters: int) -> tuple[dict, float]:
    """({device kernel name: ms per call}, wall ms per call) over `iters`
    calls of `fn`, from torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {e.key: e.self_device_time_total / 1e3 / iters
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    return kernels, wall_ms / iters


def device_busy_share(fn, iters: int) -> tuple[float, float, str]:
    """(device kernel ms, wall ms, top kernels) per call over `iters` calls
    of `fn`, from torch.profiler's CUDA activity: the device time excludes
    the gaps in which the card waits for the host."""
    kernels, wall_ms = device_kernel_times(fn, iters)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    names = "; ".join(f"{name[:60]} {ms:.4f} ms" for name, ms in top)
    return sum(kernels.values()), wall_ms, names


def turns(kernel, plain, flush: torch.Tensor,
          card: str) -> tuple[float, float]:
    """plain, kernel, kernel, plain: print each reading; -> (kernel ms,
    plain ms), the better cold time of each pair (L2 flushed)."""
    timings = {}
    for name, fn in (("plain", plain), ("kernel", kernel),
                     ("kernel2", kernel), ("plain2", plain)):
        timings[name] = (time_cold(fn, 30, flush), time_warm(fn, 50))
    for name, (cold, warm) in timings.items():
        print(f"  {name:8s} cold (L2 flushed, device time) {cold:.4f} ms"
              f"   back to back (host launch included) {warm:.4f} ms  "
              f"[{card}]")
    return (min(timings["kernel"][0], timings["kernel2"][0]),
            min(timings["plain"][0], timings["plain2"][0]))
