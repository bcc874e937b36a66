"""Time the ``rglru_scan`` CUDA kernel on the card: tile variants of its
source and, optionally, an earlier source of the kernel, in turns within
one process, at RecurrentGemma-2B width.

    python3 tools/rglru_scan_bench.py [--baseline OLD.cu] [--variants 16x16,16x8]

A variant ``LxNW`` rebuilds ``csrc/rglru_scan.cu`` with ``L`` steps a thread
and ``NW`` warps a block along T.  ``--baseline`` takes a source with the
one-kernel C entry ``rglru_scan_fwd(a, x, out, b, t, d, stream)`` (the
kernel before the time-split redesign).  Each variant is first held against
the plain version (2e-5) on long-memory gates; then, at each shape, the
variants run in turns (the list, then the list reversed) and each prints one
JSON line: ``ms`` (one wrapper call, CUDA events, median of 10 after 3
warm-ups, host work included, as ``chip_smoke.time_rglru``), ``loop_ms``
(50 calls back to back over their count), ``device_ms`` (the profiler's
device time of the kernels of 10 calls, over 10) and the bound (12 bytes an
element at 3.35 TB/s); last, each variant's host time a wrapper call at
(1, 1, 32), where the card waits on the host.  Needs a CUDA device and
``nvcc``; builds under ``build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = [(1, 8192, 2560), (8, 2048, 2560)]
PEAK_BYTES_PER_S = 3.35e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def build_variant(build, source_text: str, name: str):
    """Compile ``source_text`` as ``build/bench_<name>.cu``; returns the
    Popen of its nvcc and the library path."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"bench_{name}.cu"
    src.write_text(source_text)
    lib = src.with_suffix(".so")
    proc = subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib


def bind(lib_path: Path):
    """The wrapper's C entry, with ``.workspace`` where the source has one;
    the baseline's one-kernel entry is adapted to the same call."""
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.rglru_scan_fwd
    fn.restype = ctypes.c_int
    if not hasattr(lib, "rglru_scan_workspace"):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        return fn
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    size = lib.rglru_scan_workspace
    size.argtypes = [ctypes.c_int] * 3
    size.restype = ctypes.c_longlong
    fn.workspace = functools.lru_cache(maxsize=64)(size)
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--variants", default="16x16")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.rglru_scan import kernel as rk
    from repro_torch.kernels.rglru_scan.ref import rglru_ref

    if not torch.cuda.is_available():
        print("rglru_scan_bench: needs a CUDA device", file=sys.stderr)
        return 2
    source = rk.SOURCE.read_text()
    procs = {}
    for spec in args.variants.split(","):
        steps, warps = (int(v) for v in spec.split("x"))
        text = (source.replace("constexpr int L = 16;",
                               f"constexpr int L = {steps};")
                .replace("constexpr int NW = 16;", f"constexpr int NW = {warps};"))
        if f"L = {steps};" not in text or f"NW = {warps};" not in text:
            raise SystemExit("rglru_scan_bench: the source's L and NW lines "
                             "have changed")
        procs[f"L{steps}xNW{warps}"] = build_variant(build, text, spec)
    if args.baseline is not None:
        procs["baseline"] = build_variant(build, args.baseline.read_text(),
                                          "baseline")
    fns = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        regs = [l.strip() for l in log.splitlines()
                if "registers" in l or "spill" in l]
        print(json.dumps({"variant": name, "ptxas": regs}))
        fns[name] = bind(lib)

    def scan(name, a, x):
        fn = fns[name]
        if not hasattr(fn, "workspace"):        # the baseline's entry
            out = torch.empty_like(a)
            err = fn(a.data_ptr(), x.data_ptr(), out.data_ptr(), *a.shape,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"baseline launch failed: {err}")
            return out
        rk._fwd = fn
        return rk.rglru_scan(a, x)

    def inputs(shape, long_memory, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        if long_memory:
            a = 0.99 + 0.0099 * torch.rand(shape, generator=gen, device="cuda")
        else:
            a = torch.sigmoid(torch.randn(shape, generator=gen, device="cuda"))
        return a, torch.randn(shape, generator=gen, device="cuda")

    def cuda_ms(fn, reps=10):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def loop_ms(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(fn, reps=10):
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.key_averages()
                   if "rglru_scan" in e.key) / 1e3 / reps

    card = card_line()
    for name in fns:
        for shape in SHAPES + [(2, 3001, 50)]:
            a, x = inputs(shape, True, 0)
            err = float((scan(name, a, x) - rglru_ref(a, x)).abs().max())
            if not err <= 2e-5:
                raise SystemExit(f"{name} {shape}: max|err| {err} over 2e-5")
    order = list(fns) + list(reversed(fns))
    for shape in SHAPES:
        a, x = inputs(shape, False, 1)
        b, t, d = shape
        bound_ms = 12.0 * b * t * d / PEAK_BYTES_PER_S * 1e3
        for turn, name in enumerate(order):
            run = functools.partial(scan, name, a, x)
            print(json.dumps({
                "variant": name, "turn": turn,
                "shape": "B=%d,T=%d,D=%d,float32" % shape,
                "ms": cuda_ms(run), "loop_ms": loop_ms(run),
                "device_ms": device_ms(run), "bound_ms": bound_ms,
                "card": card}), flush=True)
    # the wrapper's host time a call: at (1, 1, 32) the card waits on the host
    a, x = inputs((1, 1, 32), False, 0)
    for name in fns:
        run = functools.partial(scan, name, a, x)
        for _ in range(100):
            run()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(2000):
            run()
        host_us = (time.perf_counter() - start) / 2000 * 1e6
        torch.cuda.synchronize()
        print(json.dumps({"variant": name, "host_us_per_call": host_us,
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
