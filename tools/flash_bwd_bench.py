"""Hold and time the flash-attention backward's head-dim-64 route on the
card: variants of its source and, optionally, an earlier source of the
kernel, in turns within one process, at whisper-tiny's encoder shape.

    python3 tools/flash_bwd_bench.py [--baseline OLD.cu] [--shape 24,1500,64]

Variants of ``csrc/flash_attention_bwd.cu``:

* ``shipped``: the source as it is;
* ``chain8``: S and dP summed in mma chains of 8 k steps (``M_CHAIN_S``);
* ``onepass`` and ``nosplit``, for timing only (their results are wrong):
  one TF32 pass per product instead of three, and the three passes fed
  the unsplit operand, which time the tensor-core passes and the split
  arithmetic apart.

``--baseline`` takes a source with the same C entry ``flash_attention_bwd``
(an earlier version of the kernel).  First, at the shape, each variant
that computes the function is held against ``attention_bwd_ref`` and
against the backward in float64 of the same f32 inputs (max |difference|
over max(1, max |reference|), the gate of ``chip_smoke.FLASH_BWD_TOL``),
with a second call's bits compared.  Then all of them run in turns (the
list, the list reversed, the list) beside SDPA's backward
(``torch.autograd.grad`` of ``F.scaled_dot_product_attention``, a
yardstick the port never calls), and one JSON line gives each one's
median ``ms`` of each turn (one wrapper call, CUDA events, median of 20
after 3 warm-ups, host work included) and ``device_ms`` (the profiler's
device time of the kernels of 10 calls, over 10), with the bound of the
five products at three TF32 passes.  Needs a CUDA device and ``nvcc``;
builds under ``build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TF32_PER_S = 495e12 / 3          # three TF32 passes a product


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def variants(text: str) -> dict:
    """name -> (source text, computes the function)."""
    one = text.replace("  mma_tf32(d, al, bh);\n  mma_tf32(d, ah, bl);\n"
                       "  mma_tf32(d, ah, bh);", "  mma_tf32(d, ah, bh);")
    unsplit = text.replace(
        "  hi = __float_as_uint(x) & 0xffffe000u;\n"
        "  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;",
        "  hi = lo = __float_as_uint(x);")
    chain8, n = re.subn(r"M_CHAIN_S = \d+", "M_CHAIN_S = 8", text)
    if one == text or unsplit == text or n != 1:
        raise RuntimeError("flash_bwd_bench: the source no longer has the "
                           "lines the variants edit")
    return {"shipped": (text, True), "chain8": (chain8, True),
            "onepass": (one, False), "nosplit": (unsplit, False)}


def build_all(build, sources: dict) -> dict:
    """Compile each text as ``build/bench_bwd_<name>.cu``, all at once;
    returns name -> bound C entry."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = build.BUILD_DIR / f"bench_bwd_{name}.cu"
        src.write_text(text)
        lib = src.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        regs = [l.strip() for l in log.splitlines()
                if "registers" in l or "spill" in l]
        print(f"[build] {name}: {' | '.join(regs[-2:])}", flush=True)
        fn = ctypes.CDLL(str(lib)).flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def bwd_f64(torch, q, k, v, o, lse, do):
    """(dq, dk, dv) in float64 of the same f32 inputs and lse."""
    scale = q.shape[-1] ** -0.5
    qd, kd, vd, od, dod = (t.double() for t in (q, k, v, o, do))
    p = torch.exp(qd @ kd.transpose(-1, -2) * scale - lse.double()[..., None])
    ds = p * (dod @ vd.transpose(-1, -2)
              - (dod * od).sum(dim=-1, keepdim=True))
    return (ds @ kd * scale, ds.transpose(-1, -2) @ qd * scale,
            p.transpose(-1, -2) @ dod)


def rel(a, b) -> float:
    return (float((a.double() - b.double()).abs().max())
            / max(1.0, float(b.abs().max())))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--shape", default="24,1500,64")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_bench: no CUDA device")
    print(f"[card] {card_line()}", flush=True)
    found = variants(fa.BWD_SOURCE.read_text())
    if args.baseline:
        found["baseline"] = (args.baseline.read_text(), True)
    fns = build_all(build, {n: t for n, (t, _) in found.items()})

    bh, s, d = (int(x) for x in args.shape.split(","))
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda")
                   for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)

    def call(name):
        fa._bwd_lib = fns[name]
        return fa.flash_attention_bwd(q, k, v, o, lse, do)

    plain = attention_bwd_ref(q, k, v, o, lse, do)
    exact = bwd_f64(torch, q, k, v, o, lse, do)
    print(f"[check] plain vs float64: "
          f"{[round(rel(a, b), 9) for a, b in zip(plain, exact)]}", flush=True)
    for name, (_, computes) in found.items():
        if not computes:
            continue
        got = call(name)
        again = call(name)
        print(f"[check] {name}: vs plain "
              f"{[round(rel(a, b), 9) for a, b in zip(got, plain)]}, vs "
              f"float64 {[round(rel(a, b), 9) for a, b in zip(got, exact)]}, "
              f"bits repeat "
              f"{all(torch.equal(a, b) for a, b in zip(got, again))}",
              flush=True)
    del plain, exact

    def ms(fn, reps=20):
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

    def device_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type.name == "CUDA") / reps / 1e3

    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs)
    sdpa = lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                       retain_graph=True)
    names = list(fns)
    turns = {name: [] for name in names + ["sdpa"]}
    for order in (names, names[::-1], names):
        for name in order:
            turns[name].append(ms(lambda: call(name)))
        turns["sdpa"].append(ms(sdpa))
    print(json.dumps({
        "shape": [bh, s, s, d], "card": card_line(), "ms": turns,
        "device_ms": {name: device_ms(lambda: call(name)) for name in names},
        "bound_ms": 10.0 * bh * s * s * d / TF32_PER_S * 1e3}), flush=True)


if __name__ == "__main__":
    main()
