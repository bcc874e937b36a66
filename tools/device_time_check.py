#!/usr/bin/env python3
"""Why the profiler's per-call device time of a kernel read less than the
kernel takes: the profiler loses kernel records.

Run from the root of a checkout, on a CUDA card:

    python3 tools/device_time_check.py

At flash attention's D 128 route, (24, 4608, 4608, 128) f32, and the
int8 product at (16384, 6144, 1536), it prints one JSON line per round
with, for each kernel:

* ``stream_ms``: CUDA events around 50 back-to-back calls, over 50;
* for each way of reading the profiler (its CUDA activity alone or with
  the CPU's, 5 or 10 calls): the summed ``self_device_time_total`` of
  ``key_averages()`` over the calls, and the count and the summed
  durations of the kernel events (``events()``) against the launches made.

Each round first runs a profiler session of many short kernels, as the
smoke's earlier phases do, so a reading that drifts with the number of
sessions before it shows as a drift across the rounds.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("device_time_check.py: no CUDA device available")
    import repro_torch  # noqa: F401  (turns TF32 off)
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.quant_matmul import kernel as qk

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((24, 4608, 128), generator=gen, device="cuda")
               for _ in range(3))
    xq = torch.randint(-127, 128, (16384, 6144), generator=gen,
                       device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (6144, 1536), generator=gen,
                       device="cuda", dtype=torch.int8)
    xs = torch.rand((16384, 1), generator=gen, device="cuda")
    ws = torch.rand((1, 1536), generator=gen, device="cuda")
    calls = {"flash_d128": lambda: fa.flash_attention(q, k, v),
             "quant_matmul": lambda: qk.quant_matmul(xq, wq, xs, ws)}

    def stream_ms(fn, n=50):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    def profiled(fn, reps, cpu):
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
        fn()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        averages = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type.name == "CUDA") / reps / 1e3
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        return {"key_averages_ms": averages,
                "kernel_events": len(kernels),
                "events_ms": sum(e.device_time_total for e in kernels)
                / reps / 1e3}

    def busy_session():
        """Many short kernels under a CPU + CUDA profile, as a profiled
        serving phase makes."""
        x = torch.randn((512, 512), device="cuda")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for _ in range(3000):
                x = torch.tanh(x @ x) * 0.5
            torch.cuda.synchronize()

    launches_per_call = {}
    for name, fn in calls.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launches_per_call[name] = sum(
            1 for e in prof.events() if e.device_type.name == "CUDA")
    print(json.dumps({"kernels_per_call": launches_per_call}), flush=True)
    for rnd in range(5):
        row = {"round": rnd}
        for name, fn in calls.items():
            row[name] = {"stream_ms": stream_ms(fn)}
            for reps in (5, 10):
                for cpu in (False, True):
                    key = f"{'cpu+cuda' if cpu else 'cuda'}_x{reps}"
                    row[name][key] = profiled(fn, reps, cpu)
        row["card"] = card_line()
        print(json.dumps(row), flush=True)
        busy_session()


if __name__ == "__main__":
    main()
