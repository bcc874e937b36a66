"""Hold and time the flash-attention forward's head-dim-128 route on the
card: tile variants of its source, in turns within one process, at Flux's
joint-attention shape.

    python3 tools/flash_fwd128_bench.py [--shape 24,4608,128]

Variants of ``csrc/flash_attention.cu``, by the tile constants of
``flash_mma128_kernel`` (``M128_BK`` keys a K/V tile, ``M128_NW`` warps of
16 query rows a block): ``bk64_nw4`` and ``bk32_nw4`` (64 query rows a
block), ``bk64_nw8`` and ``bk32_nw8`` (128).  Each is built with ``nvcc``
under ``build/`` (all at once), and ptxas's registers and spills of its
``flash_mma128_kernel`` are printed; a variant that spills fails.  Each
is held against ``attention_ref`` (f32, atol = rtol = 2e-5) at the shape,
under causal and window bands, on ragged and rectangular shapes and on a
row with no key, with a second call's bits compared.  The bf16 route at
head dim 128 (the CUDA-core template) is held at 3e-2.  Then all variants
run in turns (the list, the list reversed, the list) beside the plain
version and ``F.scaled_dot_product_attention`` (yardsticks the port never
calls), and one JSON line gives each one's median ``ms`` of each turn (one
wrapper call, CUDA events, median of 10 after 2 warm-ups) with the bounds
at three TF32 passes (495 / 3 TFLOP/s) and at the f32 FMA rate (67
TFLOP/s).  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TILES = {"bk64_nw4": (64, 4), "bk32_nw4": (32, 4), "bk64_nw8": (64, 8),
         "bk32_nw8": (32, 8)}
CHECKS = [  # (BH, Sq, Sk), causal, window
    ((3, 500, 500), True, None),
    ((2, 300, 300), True, 37),
    ((1, 200, 150), True, 1),           # rows 150.. see no key
    ((3, 100, 333), False, None),       # rectangular, ragged tiles
    ((2, 1280, 4608), False, None),     # a quarter of Flux's image queries
]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def variants(text: str) -> dict:
    """name -> source text with that variant's tile constants."""
    pattern = r"M128_BK = \d+, M128_NW = \d+"
    if len(re.findall(pattern, text)) != 1:
        raise RuntimeError("flash_fwd128_bench: the source no longer has the "
                           "line the variants edit")
    return {name: re.sub(pattern, f"M128_BK = {bk}, M128_NW = {nw}", text)
            for name, (bk, nw) in TILES.items()}


def mma128_report(log_text: str) -> list:
    """(registers, spill store bytes, spill load bytes, shared bytes) of
    each flash_mma128_kernel instantiation in ``-Xptxas -v`` output."""
    out, name, spills = [], None, (0, 0)
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spills = (nums[1], nums[2])
        elif name and "Used" in line and "registers" in line:
            if "flash_mma128_kernel" in name:
                out.append((int(line.split("Used")[1].split()[0]), *spills))
            name, spills = None, (0, 0)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="24,4608,128")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd128_bench: no CUDA device")
    print(f"[card] {card_line()}", flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, text in variants(fa.SOURCE.read_text()).items():
        sources[name] = build.BUILD_DIR / f"bench_fwd128_{name}.cu"
        sources[name].write_text(text)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build.build, sources.values())))
    for name, lib in libs.items():
        report = mma128_report(lib.with_suffix(".log").read_text())
        print(f"[build] {name}: flash_mma128_kernel registers, spill stores, "
              f"spill loads: {report}", flush=True)
        if not report or any(st or ld for _, st, ld in report):
            raise SystemExit(f"flash_fwd128_bench: {name} spills: {report}")

    def use(name):
        fa.SOURCE, fa._lib = sources[name], None
        fa._kernel()

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
            e = err(out, want)
            ok = bool(torch.allclose(out, want, atol=2e-5, rtol=2e-5))
            print(f"[check] {name} {shape} causal={causal} window={window}: "
                  f"max|err| {e:.3e}, within 2e-5 {ok}, bits repeat "
                  f"{torch.equal(out, again)}", flush=True)
            if not ok:
                raise SystemExit(f"flash_fwd128_bench: {name} {shape} fails")
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
    turns = {name: [] for name in names + ["plain", "sdpa"]}
    for order in (names, names[::-1], names):
        for name in order:
            turns[name].append(kernel(name))
        turns["plain"].append(ms(lambda: attention_ref(q, k, v)))
        turns["sdpa"].append(ms(lambda: F.scaled_dot_product_attention(q, k, v)))
    flops = 4.0 * bh * s * s * 128
    print(json.dumps({
        "shape": "BH=%d,Sq=%d,Sk=%d,D=128,float32" % main_shape,
        "ms_by_turn": turns,
        "bound_ms": 3 * flops / 495e12 * 1e3,
        "bound_f32_fma_ms": flops / 67e12 * 1e3,
        "card": card_line()}), flush=True)


if __name__ == "__main__":
    main()
