#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

1. Card: name and power limit, versions, and the build of the CUDA kernel
   from the checkout's sources (``nvcc`` into ``build/``).
2. Each kernel against its plain PyTorch version on the card: the JAX
   package's kernel grid (f32 atol 2e-5, bf16 3e-2) and the full-width path
   shapes at f32 (atol 2e-5: both sides compute in f32 FMA and differ only
   in the order of their sums; TF32 is off).
3. The toy ``sd3:basic`` request served once on ``device="cuda"`` and once on
   ``device="cpu"`` with the same weights and latents: the images agree
   within 1e-4 relative (L2 norm), the bound the CPU tests hold the port to
   against the JAX package.
4. The main path: ``ServingSystem(n_executors=1,
   backend=LocalBackend(device="cuda"))`` serving 2 ``sd3:basic`` requests at full SD3 MMDiT width (random weights
   from fixed seeds, 4 denoising steps).  The kernel launch counts are set to
   0 just before it and read just after: the flash-attention kernel must have
   run 24 times per step of every backbone batch plus twice per text-encoder
   batch.  Images must be (1, 1024, 1024, 3), finite, within [-1, 1].
5. The kernel at the exact shapes the main path gave it, held against the
   plain version and timed (CUDA events, median after warm-up) beside the
   plain version, ``torch.nn.functional.scaled_dot_product_attention`` (a
   yardstick the port never calls) and the bound.  The ``kernels`` line
   leads with the largest shape the main path launched; the others, and
   the single-request backbone shape, follow under ``other_shapes``.
6. Where the time goes: the same two requests served again on the warm
   system under ``torch.profiler``; device time by kernel, the attention
   kernel's share of it, and the card's idle share of the wall time.

The line before the last is the card's name and power limit as nvidia-smi
prints them; the last line is the JSON result.  Without a CUDA device, or
without the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and the
# f32 rate outside the tensor cores, which bounds an f32 FMA kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

GRID = [  # (BH, Sq, Sk, D), causal, window — tests/test_kernels.py's grid
    ((2, 128, 128, 64), False, None),
    ((2, 256, 256, 32), True, None),
    ((1, 200, 200, 16), True, 64),
    ((1, 64, 256, 64), False, None),
    ((2, 100, 300, 8), False, 128),
]
STEPS = 4
REQUESTS = [{"seed": 42, "prompt": "a watercolor fox in a snowy forest"},
            {"seed": 7, "prompt": "a lighthouse on a cliff at dusk, oil paint"}]


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
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


def attention_bound_ms(bh, sq, sk, d, dtype_name) -> tuple:
    """Least time for one attention call: each of q, k, v read once and o
    written once, against 4*BH*Sq*Sk*D operations at the peak for the
    inputs' type.  Returns (ms, "bytes" | "operations")."""
    elem = 4 if dtype_name == "float32" else 2
    nbytes = elem * bh * d * (2 * sq + 2 * sk)
    flops = 4.0 * bh * sq * sk * d
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_inputs(torch, shape, dtype, seed=0):
    bh, sq, sk, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((bh, n, d), generator=gen, device="cuda").to(dtype)
            for n in (sq, sk, sk)]


def check_attention(torch, fa, shape, causal, window, dtype, atol) -> float:
    q, k, v = attention_inputs(torch, shape, dtype)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = fa.attention_ref(q, k, v, causal=causal, window=window)
    err = float((out.float() - want.float()).abs().max())
    if not err <= atol:
        raise AssertionError(f"flash_attention {shape} causal={causal} "
                             f"window={window} {dtype}: max |err| {err} > {atol}")
    return err


def time_attention(torch, fa, shape, dtype, reps=10) -> dict:
    import torch.nn.functional as F

    q, k, v = attention_inputs(torch, shape, dtype, seed=1)
    dname = str(dtype).replace("torch.", "")
    bound, bound_by = attention_bound_ms(*shape, dname)
    out = {
        "shape": "BH=%d,Sq=%d,Sk=%d,D=%d,%s" % (*shape, dname),
        "ms": cuda_ms(torch, lambda: fa.flash_attention(q, k, v), reps),
        "plain_ms": cuda_ms(torch, lambda: fa.attention_ref(q, k, v), reps),
        "library_ms": cuda_ms(
            torch, lambda: F.scaled_dot_product_attention(q, k, v), reps),
        "bound_ms": bound,
        "bound_by": bound_by,
    }
    return out


def profile_path(torch, system, card) -> dict:
    """Serve the main path's requests again (weights loaded) under the
    profiler; device time by kernel and the idle share of the window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reqs = [system.submit("sd3:basic", inputs=dict(inp), steps=STEPS)
                for inp in REQUESTS]
        system.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if any(r.status != "done" for r in reqs):
        raise AssertionError("profiled requests did not finish")
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if e.device_type.name == "CUDA" and dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    flash_ms = sum(r[0] for r in rows if "flash_fwd_kernel" in r[2])
    out = {"window": f"2 requests x {STEPS} steps, weights loaded",
           "wall_ms": wall_ms,
           "device_busy_ms": busy_ms if rows else "not measured",
           "idle_share": 1 - busy_ms / wall_ms if rows else "not measured",
           "flash_attention_share_of_busy": flash_ms / busy_ms if rows else
           "not measured",
           "top_kernels": [{"ms": ms, "count": n, "name": name[:90]}
                           for ms, n, name in rows[:8]]}
    log(f"[profile] {json.dumps(out)}  [{card}]")
    return out


def image_of(system, req):
    return system.coordinator.engine.value_of(
        req.ref_key(req.graph.outputs["image"]))


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit("chip_smoke.py: src/repro_torch not found beside the script; "
                 "run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device available")
    import repro_torch  # noqa: F401  (turns TF32 off)
    from repro_torch.core import LocalBackend, ServingSystem
    from repro_torch.diffusion import REAL, SD3, ModelSet, make_basic_workflow
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa

    t_start = time.perf_counter()

    # ---------------------------------------------------------- 1. card
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = build.build(fa.SOURCE)
    build_s = time.perf_counter() - t0
    log(f"[build] {fa.SOURCE.name} in {build_s:.1f} s")
    lines = lib.with_suffix(".log").read_text().splitlines()
    for line in dict.fromkeys(l.strip() for l in lines
                              if "registers" in l or "spill" in l):
        log(f"[build] {line}")

    # ------------------------------------------ 2. kernel vs plain version
    for shape, causal, window in GRID:
        for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
            err = check_attention(torch, fa, shape, causal, window, dtype, atol)
            log(f"[kernel] grid {shape} causal={causal} window={window} "
                f"{dtype}: max|err| {err:.2e} <= {atol}")
    path_err = 0.0
    for shape in ((48, 4429, 4429, 64), (4, 333, 333, 1024)):
        err = check_attention(torch, fa, shape, False, None, torch.float32, 2e-5)
        path_err = max(path_err, err)
        log(f"[kernel] path {shape} float32: max|err| {err:.2e} <= 2e-05")

    # -------------------------------------------- 3. toy path, card vs CPU
    cpu_ms = ModelSet(SD3)
    gpu_ms = ModelSet(SD3)
    for name in ("text_enc", "backbone", "vae_dec"):
        getattr(gpu_ms, name).weights = getattr(cpu_ms, name).load("cpu")["params"]
    images = {}
    for dev, ms in (("cuda", gpu_ms), ("cpu", cpu_ms)):
        system = ServingSystem(n_executors=1, backend=LocalBackend(device=dev))
        system.register(make_basic_workflow("sd3", ms=ms))
        req = system.submit("sd3:basic", inputs=dict(REQUESTS[0]), steps=STEPS)
        system.run()
        if req.status != "done":
            raise AssertionError(f"toy request on {dev}: {req.status}")
        images[dev] = image_of(system, req)
    if images["cuda"].device.type != "cuda":
        raise AssertionError("toy request on cuda produced a CPU image")
    a, b = images["cuda"].double().cpu(), images["cpu"].double()
    toy_rel = float((a - b).norm() / b.norm())
    if not toy_rel < 1e-4:
        raise AssertionError(f"toy image card vs CPU: rel err {toy_rel}")
    log(f"[toy] sd3:basic card vs CPU image rel err {toy_rel:.2e} < 1e-4")

    # ------------------------------------------- 4. full-width main path
    family = dataclasses.replace(SD3, toy=REAL["sd3"])
    ms = ModelSet(family)
    # one card is one executor: the coordinator's timeline then matches
    # what the card did, and the two requests share its batches
    system = ServingSystem(n_executors=1, backend=LocalBackend(device="cuda"))
    system.register(make_basic_workflow("sd3", ms=ms))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    reqs = [system.submit("sd3:basic", inputs=dict(inp), arrival=0.0,
                          steps=STEPS) for inp in REQUESTS]
    system.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cfg = family.toy
    expected, path_shapes = 0, set()
    for d in system.coordinator.dispatch_log:
        n = len(d.nodes)
        if d.model_id.startswith("segment:"):
            expected += d.segment_steps * cfg.n_layers
            path_shapes.add((2 * n * cfg.n_heads, cfg.tokens, cfg.tokens,
                             cfg.head_dim))
        elif d.model_id.startswith("backbone:"):
            expected += cfg.n_layers
            path_shapes.add((2 * n * cfg.n_heads, cfg.tokens, cfg.tokens,
                             cfg.head_dim))
        elif d.model_id.startswith("text_encoder:"):
            expected += 2                      # two layers
            path_shapes.add((4 * n, cfg.text_tokens, cfg.text_tokens,
                             cfg.text_dim // 4))
    for req in reqs:
        if req.status != "done":
            raise AssertionError(f"full-width request {req.rid}: {req.status}")
        img = image_of(system, req)
        if (tuple(img.shape) != (1, 1024, 1024, 3) or img.device.type != "cuda"
                or not bool(torch.isfinite(img).all())
                or float(img.abs().max()) > 1.0):
            raise AssertionError(f"full-width image {tuple(img.shape)} "
                                 f"{img.device} out of spec")
        log(f"[path] request {req.rid} done: latency {req.latency:.3f} s on "
            f"the coordinator's measured timeline; image {tuple(img.shape)} "
            f"range [{float(img.min()):.3f}, {float(img.max()):.3f}]  [{card}]")
    if launches < expected or expected == 0:
        raise AssertionError(f"flash_attention launched {launches} times on "
                             f"the main path, expected >= {expected}")
    log(f"[path] 2 full-width sd3:basic requests, {STEPS} steps, wall "
        f"{wall_s:.2f} s (weights drawn on the card included), peak memory "
        f"{peak_gib:.2f} GiB, flash_attention launches {launches} "
        f"(expected {expected})  [{card}]")

    # --------------------------- 5. the main path's own shapes, timed
    timings, errs = [], [path_err]
    shapes = sorted(path_shapes | {(48, 4429, 4429, 64), (4, 333, 333, 1024)},
                    key=lambda s: -s[0] * s[1] * s[2] * s[3])
    for shape in shapes:
        errs.append(check_attention(torch, fa, shape, False, None,
                                    torch.float32, 2e-5))
        timings.append(time_attention(torch, fa, shape, torch.float32))
        log(f"[time] {json.dumps(timings[-1])}  [{card}]")
    # ------------------------------------------- 6. where the time goes
    profile_path(torch, system, card)

    # the headline is the largest shape the main path really launched
    served = max(path_shapes, key=lambda s: s[0] * s[1] * s[2] * s[3])
    main = timings[shapes.index(served)]
    entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:109",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": main["shape"],
        "other_shapes": [t for t in timings if t is not main],
    }
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": [entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
