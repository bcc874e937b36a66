"""Hold and time the flash-attention forward's f32 head-dim-128 route on
the card: variants of its source, and an earlier commit's route, in turns
within one process, at Flux's joint-attention shape.

    python3 tools/flash_fwd128_bench.py [--shape 24,4608,128] [--parent DIR]

Variants of ``csrc/flash_attention.cu`` by the constants of
``flash_wgmma128_kernel`` (``W128_KS`` and ``W128_VS`` stages of the K and
V^T rings, ``W128_PVN`` output columns a P v accumulator takes, ``W128_PP``
whether the consumer warpgroups take turns at the tensor cores), named
``k<KS>v<VS>_n<PVN>`` with ``_pp`` for turns (``VARIANTS``; the first is the
source as it stands).  Each is built with ``nvcc`` under ``build/`` (all at
once), and ptxas's registers and spills of the route's two kernels
(``flash_split128_kernel``, ``flash_wgmma128_kernel``) are printed; a
variant that spills is left out (the first may not spill).  With
``--parent``, the ``flash_attention.cu`` of that checkout (say a ``git
archive`` of the parent commit, unpacked) is built too and timed as
``parent``, bound through its own ``flash_attention_fwd``.  Each is held
against ``attention_ref`` (f32, atol = rtol = 2e-5) at the shape, under
causal and window bands, on ragged and rectangular shapes and on a row with
no key, with a second call's bits compared; the pre-pass bit for bit
against ``split_planes_ref``.  The bf16 route at head dim 128 (the CUDA-core
template) is held at 3e-2.  Then all run in turns (the list, the list
reversed, the list) beside the pre-pass alone (``split``), the plain
version and ``F.scaled_dot_product_attention`` (yardsticks the port never
calls), and one JSON line gives each one's median ``ms`` of each turn (one
wrapper call, CUDA events, median of 10 after 2 warm-ups), each one's
device time by kernel (the profiler, mean of 5 calls), and the bounds
at three TF32 passes (495 / 3 TFLOP/s) and at the f32 FMA rate (67
TFLOP/s).  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

VARIANTS = {"k3v2_n128_pp": (3, 2, 128, 1), "k2v2_n64": (2, 2, 64, 0),
            "k3v2_n64_pp": (3, 2, 64, 1), "k3v2_n128": (3, 2, 128, 0),
            "k2v2_n128_pp": (2, 2, 128, 1)}
ROUTE = ("flash_split128_kernel", "flash_wgmma128_kernel")
CHECKS = [  # (BH, Sq, Sk), causal, window
    ((3, 500, 500), True, None),
    ((2, 300, 300), True, 37),
    ((1, 200, 150), True, 1),           # rows 150.. see no key
    ((3, 100, 333), False, None),       # rectangular, ragged tiles
    ((2, 333, 100), False, None),
    ((4, 512, 512), False, None),
    ((1, 400, 150), True, 1),           # blocks that see no key tile
]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def variants(text: str) -> dict:
    """name -> source text with that variant's constants."""
    pattern = r"W128_KS = \d+, W128_VS = \d+, W128_PVN = \d+, W128_PP = \d+"
    if len(re.findall(pattern, text)) != 1:
        raise RuntimeError("flash_fwd128_bench: the source no longer has the "
                           "line the variants edit")
    return {name: re.sub(pattern, f"W128_KS = {ks}, W128_VS = {vs}, "
                                  f"W128_PVN = {pvn}, W128_PP = {pp}", text)
            for name, (ks, vs, pvn, pp) in VARIANTS.items()}


def route_report(log_text: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of the
    route's kernels in ``-Xptxas -v`` output."""
    out, name, spills = [], None, (0, 0)
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spills = (nums[1], nums[2])
        elif name and "Used" in line and "registers" in line:
            for kernel in ROUTE:
                if kernel in name:
                    out.append((kernel, int(line.split("Used")[1].split()[0]),
                                *spills))
            name, spills = None, (0, 0)
    return out


def parent_library(path: Path):
    """An earlier commit's library, bound as the wrapper calls it."""
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                        + [ctypes.c_float] + [ctypes.c_int] * 3
                                        + [ctypes.c_void_p] * 2)
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_scratch_floats.argtypes = [ctypes.c_int] * 5
    lib.flash_attention_scratch_floats.restype = ctypes.c_longlong
    return lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="24,4608,128")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit, timed as 'parent'")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref,
        split_planes_ref,
    )

    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd128_bench: no CUDA device")
    print(f"[card] {card_line()}", flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, text in variants(fa.SOURCE.read_text()).items():
        sources[name] = build.BUILD_DIR / f"bench_fwd128_{name}.cu"
        sources[name].write_text(text)
    if args.parent is not None:
        parent_src = (args.parent / "src/repro_torch/kernels/flash_attention"
                      / "csrc/flash_attention.cu")
        sources["parent"] = build.BUILD_DIR / "bench_fwd128_parent.cu"
        sources["parent"].write_text(parent_src.read_text())
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build.build, sources.values())))
    for name, lib in list(libs.items()):
        if name == "parent":
            continue
        report = route_report(lib.with_suffix(".log").read_text())
        print(f"[build] {name}: (kernel, registers, spill stores, spill "
              f"loads): {report}", flush=True)
        if (sorted({r[0] for r in report}) != sorted(ROUTE)
                or any(st or ld for _, _, st, ld in report)):
            if name == next(iter(VARIANTS)):
                raise SystemExit(f"flash_fwd128_bench: {name} spills: {report}")
            print(f"[build] {name} spills: left out", flush=True)
            del libs[name], sources[name]

    bound = {}

    def use(name):
        if name not in bound:
            if name == "parent":
                bound[name] = parent_library(libs[name])
            else:
                fa.SOURCE, fa._lib = sources[name], None
                bound[name] = fa._kernel()
        fa._lib = bound[name]

    def inputs(shape, dtype, seed):
        (bh, sq, sk), d = shape, 128
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.randn((bh, n, d), generator=gen, device="cuda").to(dtype)
                for n in (sq, sk, sk)]

    def err(out, want):
        return float((out.float() - want.float()).abs().max())

    bh, s, _ = (int(x) for x in args.shape.split(","))
    main_shape = (bh, s, s)
    for name in sources:
        use(name)
        for shape, causal, window in [(main_shape, False, None)] + CHECKS:
            q, k, v = inputs(shape, torch.float32, 0)
            out = fa.flash_attention(q, k, v, causal=causal, window=window)
            again = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = attention_ref(q, k, v, causal=causal, window=window)
            ok = bool(torch.allclose(out, want, atol=2e-5, rtol=2e-5))
            print(f"[check] {name} {shape} causal={causal} window={window}: "
                  f"max|err| {err(out, want):.3e}, within 2e-5 {ok}, bits "
                  f"repeat {torch.equal(out, again)}", flush=True)
            if not ok:
                raise SystemExit(f"flash_fwd128_bench: {name} {shape} fails")
        if name != "parent":
            _, k, v = inputs(main_shape, torch.float32, 2)
            same = torch.equal(fa.split_planes(k, v),
                               split_planes_ref(k, v, tile=fa.D128_TILE))
            print(f"[check] {name} split planes {main_shape}: bit-identical "
                  f"{same}", flush=True)
            if not same:
                raise SystemExit(f"flash_fwd128_bench: {name} split planes")
    use(next(iter(VARIANTS)))
    for shape, causal, window in [(main_shape, False, None)] + CHECKS:
        q, k, v = inputs(shape, torch.bfloat16, 0)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = attention_ref(q, k, v, causal=causal, window=window)
        e = err(out, want)
        print(f"[check] bf16 {shape} causal={causal} window={window}: "
              f"max|err| {e:.3e} <= 3e-2 {e <= 3e-2}", flush=True)
        if not e <= 3e-2:
            raise SystemExit(f"flash_fwd128_bench: bf16 {shape} fails")

    def ms(fn, reps=10):
        for _ in range(2):
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

    q, k, v = inputs(main_shape, torch.float32, 1)

    def kernel(name):
        use(name)
        return ms(lambda: fa.flash_attention(q, k, v))

    names = list(sources)
    turns = {name: [] for name in names + ["split", "plain", "sdpa"]}
    for order in (names, names[::-1], names):
        for name in order:
            turns[name].append(kernel(name))
        use(next(iter(VARIANTS)))
        turns["split"].append(ms(lambda: fa.split_planes(k, v)))
        turns["plain"].append(ms(lambda: attention_ref(q, k, v)))
        turns["sdpa"].append(ms(lambda: F.scaled_dot_product_attention(q, k, v)))
    def device_ms(fn, reps=5):
        """Device milliseconds a call of each CUDA kernel ``fn`` launches."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type.name == "CUDA":
                found = re.search(r"\w+_kernel", e.key)
                name = found.group(0) if found else e.key[:40]
                out[name] = out.get(name, 0.0) + e.self_device_time_total / reps / 1e3
        return out

    devices = {}
    for name in names:
        use(name)
        devices[name] = device_ms(lambda: fa.flash_attention(q, k, v))
    flops = 4.0 * bh * s * s * 128
    print(json.dumps({
        "shape": "BH=%d,Sq=%d,Sk=%d,D=128,float32" % main_shape,
        "ms_by_turn": turns,
        "device_ms_by_kernel": devices,
        "bound_ms": 3 * flops / 495e12 * 1e3,
        "bound_f32_fma_ms": flops / 67e12 * 1e3,
        "card": card_line()}), flush=True)


if __name__ == "__main__":
    main()
