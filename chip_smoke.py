#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

1. Card: name and power limit, versions, and the build of every CUDA
   kernel from the checkout's sources (one ``nvcc`` per source, all six
   started together, into ``build/``), with ptxas's registers and spills;
   every instantiation of flash attention's forward and of the int8
   route's two kernels is listed by name; the int8 kernels and flash
   attention's head-dim-128 kernels (``D128_KERNELS``: the split-plane
   pre-pass and the wgmma tiles) must spill nothing.
2. Each kernel against its plain PyTorch version on the card.  Flash
   attention: the JAX package's kernel grid (f32 atol 2e-5, bf16 3e-2),
   causal and window bands at head dims 64, 128 (f32 and bf16) and 1024
   (wholly masked tiles and chunks, rows with no key, rectangular shapes
   at 128), 17000 keys at head dim 1024 (a merge of 266 chunks), and the
   full-width path shapes at f32, (48 | 96 | 144, 4429, 64), (4 | 8, 333,
   1024), phase 4t's basic (24, 4608, 128), (76, 4429, 64) and (4, 512,
   1024), and (4, 512, 128) (atol 2e-5: the
   kernel's 3xTF32 products keep about 20 bits, the plain version's f32
   FMAs 24; TF32 is off in the plain version); every f32 head-dim-128
   shape gives the same bits on a second call, and that route's pre-pass
   is bit-identical to ``split_planes_ref`` (a ragged Sk and Flux's).  The split-KV route's two
   kernels on their own: the partials against ``attention_partial_ref``
   and the merge against ``merge_partials_ref`` (f32 2e-5).  The LoRA
   kernels: the JAX package's grids (``tests/test_kernels.py``, f32
   atol = rtol = 1e-4, bf16 1.5e-1; ``tests/test_multilora.py``, f32 1e-4,
   with idx = -1 rows and G*r up to 160) and the three full-width path
   shapes in the path's types at atol 2e-5 * sqrt(K/64) (the kernel's
   split-TF32 products keep about 20 bits of each f32 operand and sum in
   another order, and the rounding grows with the depth K).  A row
   with idx = -1 must give the same bits as when the whole batch has
   idx = -1.  ``quant_matmul`` bit for bit (its int32 sum is exact): the
   JAX package's grid (``tests/test_quant.py``), all-127 operands at
   K = 16384 (split along K and not), each route of ``kernel.plan`` (M 1,
   4, 64, 333, 1332, ragged M, N and K, byte loads, split-K), and every
   full-width path shape.  ``quantize_rows`` bit for bit against
   ``quantize_rows_ref`` at every (M, K) the path quantizes and at ragged
   and long rows, with an all-zero row and rows of exact .5 quotients.
   ``rglru_scan`` within 2e-5
   (``tests/test_kernels.py``'s tolerance) on the JAX package's grid, at
   RecurrentGemma-2B width (D 2560; B 1, T 8192 and B 8, T 2048) and at
   odd shapes (B 2, T 3001, D 50; B 3, T 1, D 7), each with sigmoid
   gates and again with long-memory gates (a uniform in [0.99, 0.9999], a
   carry that crosses the kernel's 256-step tiles), the long-memory runs
   of kernel and plain version also within ``RGLRU_F64_TOL`` of a float64
   literal recurrence on the card, and the kernel's bits the same on a
   second call.
3. Toy size, card against CPU on the same weights and latents: one
   ``sd3:basic`` request, and the three-tenant mix (two LoRA tenants and
   one basic request, 3 steps) on the multilora scheduler.  Images agree
   within 1e-4 relative (L2 norm), the bound the CPU tests hold the port to
   against the JAX package; on the card the grouped images agree with each
   tenant's folded solo run within 2e-4 max-abs (``PARITY_TOL`` of the JAX
   package's test).  The basic request again under ``REPRO_QUANT`` int8 and
   fp8, card against CPU: fp8 within 1e-4, int8 within 2.5e-2 (the CPU
   tests' bounds: int8 rounding flips move the image by about 2e-2), each
   away from the fp32 image.
4. The basic path: ``ServingSystem(n_executors=1,
   backend=LocalBackend(device="cuda"))`` serving 2 ``sd3:basic`` requests
   at full SD3 MMDiT width (random weights from fixed seeds, 4 denoising
   steps).  The kernel launch counts are set to 0 just before it and read
   just after: flash attention must have run 24 times per step of every
   backbone batch plus twice per text-encoder batch.  Images must be
   (1, 1024, 1024, 3), finite, within [-1, 1].  The same two requests are
   then served again through the plain attention route
   (``set_flash_attention(False)``, restored afterwards): each image served
   through the kernel lies within ``KERNEL_VS_PLAIN_REL`` of it.
5. Flash attention at the exact shapes the basic path gave it, held against
   the plain version and timed (CUDA events, median of 10 after 2 warm-ups,
   and the card's own time over 20 calls queued behind a sleep kernel:
   ``queued_ms``) beside the plain
   version, ``scaled_dot_product_attention`` (a yardstick the port never
   calls) and two bounds: ``bound_ms`` at the 3xTF32 rate
   the kernel runs (495 / 3 TFLOP/s) and, on the ``[time]`` lines only,
   ``bound_f32_fma_ms`` at the f32 rate outside the tensor cores
   (67 TFLOP/s).
6. Where the time goes on the basic path: its two requests served again on
   the warm system under ``torch.profiler``; device time by kernel, the
   attention kernels' share (``FLASH_KERNELS``: every CUDA kernel the flash
   wrapper launches), and the card's idle share of the wall time.  The
   profiler can lose kernel records, so the flash-attention kernels'
   records are held against the wrapper's launches in the window
   (``flash_records``): where any is missing, every device time of that
   profile prints "not measured".  So for every profiled phase.
4t. Table 2's SD3.5-Large (S2) and Flux (S3) workflows at published width,
   once phase 4's system is freed (``table2_phase``): sd3.5-large at
   ``REAL["sd3.5-large"]`` (d 2432, 38 layers, 38 heads of 64, CFG rows, a
   19-layer ControlNet) and flux-schnell at ``REAL["flux-dev"]`` (d 3072,
   57 layers, 24 heads of 128, 4096 + 512 tokens, no CFG rows, a 28-layer
   ControlNet), ``STEPS`` steps a request (flux-schnell's published
   count), ``REQUESTS[0]`` and, for a ControlNet workflow, the reference
   image of ``REF_SEEDS[0]``.  For each family the weights are drawn once
   on the card through the models' own loads (``draw_model_set``; both
   ControlNets with a nonzero ``cond_embed``) and every workflow's fused
   segment shares them, on one ``ServingSystem(n_executors=1,
   backend=LocalBackend(device="cuda"))``: sd3.5-large basic, cn1 and cn2
   in f32, flux-schnell basic and cn1 (f32 flux-schnell:cn2 is not served:
   its bf16 weights alone are 72.5 GiB; the script prints that reckoning
   beside cn1's measured peak and the cost model's ControlNet bytes).  For
   each request the counts are set to 0 just before and read just after:
   flash attention exactly a launch per layer and step of the backbone and
   of each ControlNet, plus 2 for the text encoder (``expected_flash``:
   sd3.5-large 154, 230, 306; flux-schnell 230, 342, and 454 for int8
   cn2), and no other kernel; the image (1, 1024, 1024, 3), finite, in
   [-1, 1], and within ``KERNEL_VS_PLAIN_REL`` of the same request through
   the plain attention route, which launches no kernel at all; printed:
   wall with the weights on the card,
   peak memory.  Then the mixed LoRA batch (``table2_lora``: tenant A,
   tenant B and a basic request in one multilora segment, the grouped
   kernel exactly 4 times a layer a step, 608 and 912; each image against
   its solo run, a tenant's folded within ``TENANT_FOLD_REL``, the basic
   one within 1e-4, and tenant A without its adapter above the gate; one
   direct grouped text-encoder call against the folded encoder).  Then
   under ``REPRO_QUANT=int8`` (``set_quant_mode``, restored afterwards)
   with the weights drawn and quantized at load (no bf16 tree kept): each
   family's basic, cn1 and cn2, ``quant_matmul`` and ``quantize_rows``
   exactly as ``quant_path`` reckons, each image within
   ``INT8_VS_FP32_REL`` of its f32 image, and flux-schnell:cn2, which has
   none, bit-identical to the same request with the plain versions in the
   kernels' places, which launch neither kernel.  Each system is freed
   before the next.
5t. Each kernel at the shapes phase 4t gave it: flash attention where
   phase 5 did not time it (f32 atol 2e-5), the grouped LoRA kernel at the
   mixed batches' image-stream and text-encoder shapes (the path gate,
   2e-5 * sqrt(K/64)), ``quant_matmul`` and ``quantize_rows`` bit for bit
   and timed where they are not the SD3 path's (phase 5q times those);
   timed as in phases 5, 5b and 5q.  One set (``checked_flash``) keeps the
   flash shapes phases 5 and 5x have held and timed; each takes only the
   shapes it adds.
6t. Where the time goes on each family's cn1 request: served again on its
   warm system under the profiler (inside 4t); flash attention, the f32
   GEMMs and the convolutions by device time and share of busy time, and
   the idle share.
7t. Table 2's S2, S5, S3 and S4 replayed through the serving launcher
   at published width (inside 4t): the first 8 requests of each
   setting's ``generate_trace`` through ``repro_torch.launch.serve.serve()``
   with ``REPRO_DONATE`` and ``REPRO_OVERLAP`` off, on one executor, one
   ``ModelSet`` a family (``table2_trace``): S2 on sd3.5-large's f32
   weights, S5 on those and sd3's at ``REAL["sd3"]`` (two families on one
   executor), S3 on flux-schnell's int8 weights, then S4 on flux-dev's,
   drawn and quantized at load from its own model ids.  Checked and
   printed as phase 7l, and: the 8 requests all done or rejected; every
   segment ``trace_missing`` asks for dispatched (a family's, and a Flux
   family's +C.N.2; where admission rejected every request of one, the
   setting is replayed with ``--no-admission`` and says so); under int8
   ``quant_matmul`` and ``quantize_rows`` exactly as ``quant_path``
   reckons; the reckonings take each dispatch's family from its model id
   (``dispatch_family``); the peak beside ``TRACE_PEAK_GIB``'s
   prediction.  S6 (flux-schnell and flux-dev) is not served: the script
   prints why one card cannot hold it, from S3's and S4's int8 weights,
   S3's working memory and the card's memory (``s6_reckoning``).
4b. The LoRA path: sd3:lora:tenantA, sd3:lora:tenantB and sd3:basic served
   together at full width, 4 steps, on one card with the multilora
   scheduler and the passes of the JAX package's multi-tenant test
   (``InlineTrivialPass``, ``SegmentFusionPass``, ``JitCompilePass``).
   ``AsyncLoRAPass`` is left out: its fold-in point depends on measured
   seconds, so the batch would not be deterministic with it.  Counts are
   set to 0 just before and read just after: the grouped kernel must have
   run 96 times per step (24 layers x q/k/v/o) of every multilora segment
   dispatch, flash attention as in phase 4.  The tenants' images differ;
   the basic request that rode the mixed batch agrees with the same
   request served alone within 1e-4 relative.  Tenant A agrees with its
   folded solo run within ``TENANT_FOLD_REL`` relative, a bound looser than
   the toy one because at full width the fold rounds W + dW to bf16; two
   controls, tenant A's inputs served alone without an adapter and with
   tenant B's, must both lie above that bound, so a dropped or swapped
   adapter fails the gate.
4c. One direct ``TextEncoder.execute_batch_multilora`` call at full width
   (three prompts, two text adapters on the last layer's ``wo``) against
   each adapter folded in and run alone: 1e-4 relative.
5b. Each LoRA kernel timed at its path shapes (as phase 5) beside its
   plain version, the composite of cuBLAS calls that computes the same
   function (no single PyTorch call does; the port never calls it) and two
   bounds: ``bound_ms`` at the rate of the kernel's TF32 passes (495
   TFLOP/s over 2 passes for f32 x and bf16 W, over 3 for all f32), and,
   on the ``[time]`` lines only, ``bound_f32_fma_ms`` at the f32 rate
   outside the tensor cores.  A served row count other than phase 2's is first held
   against the plain version there, as in phase 2.
6b. Where the time goes on the LoRA path: the mixed batch again under the
   profiler; the LoRA kernels' share of device time (the x @ A pre-pass
   and the GEMM, ``LORA_KERNELS``) and the idle share.
5c. Flash attention at each shape the LoRA path gave it that phase 5 did
   not cover (the three-request batch), held against the plain version
   (f32 atol 2e-5) and timed as in phase 5, both bounds included.
4q. The basic path under ``set_quant_mode("int8")`` (restored afterwards, so
   later phases run "off"): phase 4's two requests on fresh weights from
   the same seeds, quantized on load.  Counts set to 0 just before and read
   just after: ``quant_matmul`` exactly 1344 launches per 4-step segment
   dispatch (24 layers x 2 streams x 7 projections x 4 steps) plus 12 per
   text batch, ``quantize_rows`` exactly as often, flash attention as in
   phase 4.  Images as in phase 4, and each within ``INT8_VS_FP32_REL`` of
   phase 4's fp32 image.  The same requests served again with the script
   putting both plain versions in the kernels' places: bit-identical (the
   relative error, 0, is printed).
5q. ``quant_matmul`` at every shape the int8 path gave it (checked bit for
   bit first where phase 2 did not), timed as in phase 5 (one wrapper call,
   host work included) and the card's own time over 20 queued calls
   (``queued_ms``) beside its plain version, the bound,
   ``torch._int_mm`` with the same epilogue (a yardstick the port never
   calls; null where its shape rules refuse) and the float32 product of
   the "off" route; ``quantize_rows`` at every (M, K) the path gave it,
   timed the same two ways, beside its plain version and its bytes bound
   (no PyTorch call computes it).  ``rglru_scan`` timed at
   RecurrentGemma-2B width beside its plain version and its bound (no
   PyTorch call computes the recurrence).
6q. Where the time goes on the int8 path: the two requests again under the
   profiler; both kernels' device time and shares of busy time
   (``QUANT_KERNELS`` and ``quantize_rows_kernel``).

4n. The ControlNet path: Table 2's S1 (``table2_setting("s1")``: sd3:basic,
   sd3:cn1 and sd3:cn2 on one ``ModelSet``) at full width on one card, one
   sd3:cn1 and one sd3:cn2 request seeded as phase 4's two, each with its
   own (1, 1024, 1024, 3) reference image in [-1, 1] from a fixed seed, 4
   steps.  The ControlNets get a nonzero ``cond_embed`` through ``weights``
   (the JAX package's is all zeros, with which the reference image could
   not move the image; test weights only).  Counts set to 0 just before and
   read just after: flash attention exactly 24 launches per backbone batch
   step, 12 per ControlNet batch step and 2 per text batch; no other
   kernel.  Each request's steps ran fused with its ControlNets
   (``segment:backbone:sd3+controlnet1:sd3[+controlnet2:sd3]``).  Images as
   in phase 4, the port's ``check_invariants`` finds nothing, and the same
   requests through the plain attention route give images within
   ``KERNEL_VS_PLAIN_REL``.  Two controls must move the sd3:cn1 image by
   more than ``CONTROL_FACTOR`` times that error: another reference image
   (the conditioning is live) and the basic workflow with the same seed and
   prompt (the residuals are live).
5n. Flash attention at each shape the ControlNet path gave it that phases 5
   and 5c did not cover (the branch's rows: (24, 4429, 4429, 64)), held
   against the plain version (f32 atol 2e-5) and timed as in phase 5.
4nq. The sd3:cn1 request under ``set_quant_mode("int8")`` (restored
   afterwards) on a fresh system from the same weights: ``quant_matmul``
   and ``quantize_rows`` exactly 2 streams x 7 x (24 backbone + 12
   ControlNet layers) per step plus 12 per text batch, flash attention as
   in phase 4n; the image bit-identical to the same request served with
   both plain versions in the kernels' places.  Every (M, K, N) and (M, K)
   that phase 4q did not give is checked bit for bit and timed as in 5q.
6n. Where the time goes on the ControlNet path: its two fp32 requests again
   under the profiler; flash attention, cuDNN's convolutions and cuBLAS's
   f32 GEMMs by device time and share of busy time, and the idle share.

7l. A trace through the serving launcher (``repro_torch.launch.serve``):
   Table 2's S1 at full width, every model's weights drawn once
   (``s1_model_set``; the ControlNets those of phase 4n), served by
   ``serve()`` with ``SERVE_ARGS`` and the card (``--setting s1 --plane local
   --executors 1 --rate 1.0 --duration 120 --cv 2.0 --slo-scale 2.0
   --device cuda``: the first 8 requests of ``generate_trace``, 3 steps,
   admission on), twice: ``REPRO_DONATE`` and ``REPRO_OVERLAP`` off, then
   both on (fresh systems: the flags are read at build and at load).
   Counts set to 0 just before each run and read just after: flash
   attention exactly ``expected_flash`` of the run's dispatches, no other
   kernel.  Each run: the 8 requests done or rejected, an S1 segment
   dispatched; ``check_invariants`` clean; every image (1, 1024,
   1024, 3), finite, in [-1, 1]; across the runs the same requests finish
   and each image is bit-identical.  Printed per run: wall and the
   coordinator's makespan, requests done and rejected, SLO attainment,
   mean, p50 and p99 latency, dispatches, overlap dispatches and hidden
   seconds, peak memory, each model's predicted (``GPU_H800`` profile) and
   measured seconds a dispatch, the dispatch timeline; and why no decode
   overlapped, when none did.

5l. Flash attention at each shape the trace gave it that phases 5, 5c and
   5n did not cover (a text-encoder batch of three prompts), held against
   the plain version (f32 atol 2e-5) and timed as in phase 5.

7p. The process plane (``ProcBackend(device="cuda")``: each executor a
   worker process spawned with its own CUDA context on the card, behind the
   CRC-framed transport), at full width, every worker drawing its weights
   from the model ids.  The parent's kernel counts are set to 0 just before
   each proc run and must still be 0 just after: the workers launch the
   kernels, and the proof that they ran them is each proc image
   bit-identical to an in-process kernel-route image whose batches were
   the same (the phase prints whether they were; otherwise within
   ``KERNEL_VS_PLAIN_REL``), and the worker pids among nvidia-smi's compute
   processes where that list can be matched to this process's pids.
   (a) Phase 4's two requests on ``PROC_EXECUTORS`` executors with
   ``Scheduler(use_declared_max_batch=True, segment_chunk=PROC_CHUNK)``, in
   process and then on the proc plane: ``check_invariants`` clean, every
   reply applied, none fenced, staging hits.  (b) The first request alone
   on a fresh proc system with ``FaultPlane(kill_every_execs=2,
   max_kills=1)``: the worker dies right after its second segment RPC is
   sent, is respawned and the request replays; the image against (a)'s.
   (c) Phase 4b's three requests through one worker, twice: adapter
   factors shipped 2 and hit 0, then shipped 2 and hit at least 2; a
   multilora dispatch; images bit-identical to phase 4b's (the same
   batches required).  (d) ``REPRO_QUANT=int8`` set before the system is
   built (the workers inherit it) and the parent's quant mode int8 (its
   prices): phase 4q's two requests through one worker, bit-identical to
   phase 4q's images (the same batches required); the environment and the
   mode are restored.  Printed per run: wall and the coordinator's
   makespan, the RPC split (worker, transport and parent serialization
   seconds as shares of the measured dispatch seconds), bytes out and
   back, staging ships and hits, each worker's spawn seconds, the respawn
   wall and a cold worker's first RPC of each model against its warm ones,
   the device memory the workers hold (the card's use from
   ``cudaMemGetInfo`` with them alive, less before, less the parent's own
   growth) and ``nvidia-smi --query-compute-apps=pid,used_memory``.

7s. The sharded plane (``ShardedBackend`` over a ``MeshManager`` of
   ``SHARD_SLOTS`` slots, each ``torch.device("cuda", 0)``, told apart by
   identity) at full width, on one weight draw (``s1_model_set``): one
   sd3:basic and one sd3:cn1 request (phase 4n's first reference image),
   4 steps, each served through ``ServingSystem(n_executors=4)`` with
   ``Scheduler(fixed_parallelism=k, use_declared_max_batch=True,
   mesh=...)`` at k = 2 (the CFG pair's rows on two slots) and k = 4 (the
   image tokens on four slots, a K/V all-gather a layer), and once on a
   single-device ``LocalBackend``.  Counts set to 0 just before each run
   and read just after: flash attention exactly the calls
   ``sharded_flash`` reckons from the dispatches, shape by shape (the
   ops module's ``flash_attention`` is wrapped to record each call's
   shape), no other kernel.  Each sharded run: every segment dispatch at
   k, each with a ``shard_log`` entry of k distinct slots;
   ``check_invariants`` clean; the image (1, 1024, 1024, 3), finite, in
   [-1, 1] and within ``KERNEL_VS_PLAIN_REL`` of its single-device image.
   Printed per run: wall, makespan, the segment's shard modes, peak
   memory and the difference from the single-device image.  Then the
   sd3:basic request again on the warm single-device and k = 4 systems
   under the profiler (``profile_path``): flash attention, the f32 GEMMs
   and the copy kernels (``SHARD_PROFILE``) by device time and share of
   busy time, and the idle share.  The k slots of one card run their
   shards one after another: these are correctness runs, not parallel
   speed.
5s. Flash attention at each shape the sharded runs gave it that phases 5,
   5c, 5n and 5l did not cover, led by the sequence-sharded (48, 1357,
   4429, 64), held against the plain version (f32 atol 2e-5) and timed as
   in phase 5, both bounds included.
8. The LLM families' serving path (``repro_torch.models``:
   ``make_prefill_step``, ``make_serve_step``) at the published widths,
   f32 weights drawn on the card from seeds, once the earlier systems are
   freed.  The launch counts are set to 0 just before each counted run
   and read just after.  "rel" is max |difference| / max |reference|.
   8h. recurrentgemma-2b, all 26 layers: a prefill of (1, 8192) tokens
   launches ``rglru_scan`` exactly 18 times (8 super-blocks x 2 + 2
   remainder blocks) at (1, 8192, 2560) and nothing else; last logits
   finite and within ``LLM_REL`` of the same prefill with the script
   putting the plain scan in the kernel's place; 64 decode steps from
   ``init_decode_cache(2, 64)`` each within ``LLM_REL`` of the forward's
   logits at that position; printed: the prefill's wall (CUDA events,
   median of 3 after 1 warm-up), one decode step at batch 8 against an
   8192-deep cache (median of 20), peak memory, and one prefill under the
   profiler (``rglru_scan``, GEMMs, the attention's device time through
   a range around every ``gqa_attention`` call, and idle).
   8w. whisper-tiny, 4 + 4 layers: a prefill of (4, 448) tokens over
   (4, 1500, 384) frames launches flash attention exactly 4 times (the
   encoder) at (24, 1500, 64) and nothing else; last logits within
   ``LLM_REL`` of the same prefill under ``set_flash_attention(False)``;
   4 decode steps from the encoder's output, finite.  Flash attention at
   (24, 1500, 1500, 64) is then held against its plain version (f32 atol
   2e-5) and timed as in phase 5.
   8d. llama3-8b, all 32 layers: a prefill of (1, 4096) tokens, finite;
   32 decode steps against a 16384-deep cache (the blockwise decode) and
   against an 8192-slot ring cache, each within ``LLM_REL`` of the
   forward; printed: the prefill's wall, one decode step at batch 1
   against a 32768-deep cache and peak memory.
   8s. llama3-8b's 32 layers still on the card: the flash-decode over a
   sequence-sharded KV cache (``decode_shards`` a ``Submesh`` of 4 slots
   of the card, ``shard_decode_cache``), 32 steps at batch 1 against a
   16384-deep cache, each step's logits against the unsharded route's
   (same parameters, cache and tokens) within ``LLM_REL``, no kernel
   launched: from an empty cache (the logits and the whole cache the same
   bits), then across the first two slots' boundary from a cache of
   seeded normal K/V (layer 0's K/V the same bits, the deeper layers'
   written K/V within ``LLM_REL``: their inputs carry the merged
   softmax's rounding; every other slot untouched); printed: one step on
   each route (CUDA events, median of 20) and peak memory.
   8z. The other seven configs at full width and cut depth (2 layers;
   xlstm-1.3b 8, one 7:1 super-block; grok-1-314b 1; MoE at capacity
   factor 8.0): a prefill of (2, 1024) tokens (internvl2-2b with its 256
   patch embeddings), finite; 16 decode steps within ``LLM_REL`` of the
   forward.

9. The training path (``repro_torch.train.train``: the data pipeline,
   ``make_train_step``, AdamW, checkpoints) at the published widths, f32,
   once phase 8's models are freed; the launch counts are set to 0 just
   before each step and read just after it.  Each run: the first step's
   loss and every leaf's gradient through the kernels against the same
   step through the plain route (``TRAIN_REL``, max |difference| over max
   |reference| per leaf; no leaf all zero where the plain route's is
   not), and whether a second computation gives the same bits; 3 AdamW
   steps of ``train()`` with a checkpoint after step 2, each step's
   launches equal to the reckoned counts, the losses finite; a fresh
   ``train()`` restores the checkpoint and takes step 3 with parameters
   bit-identical to the uninterrupted run's; printed: the step walls
   (median; the data draw and host work included, the checkpoint's save
   timed apart), tok/s, peak memory, and one step under the profiler
   (GEMMs, flash or RG-LRU forward and backward kernels, the optimizer's
   and the attention's device spans through ranges, idle).
   9w. whisper-tiny as published (4 + 4 layers, d 384, 6 heads of 64,
   1500 frames) at (4, 448): flash attention 4 forward and 4 backward
   launches a step (the encoder, not rematerialised); the plain route is
   ``set_flash_attention(False)``.  The backward kernel alone at (24,
   1500, 1500, 64) against ``attention_bwd_ref`` (``FLASH_BWD_TOL``), the
   same bits twice, and timed as in phase 5 beside its plain version and
   SDPA's backward; the ``[time]`` line adds its share of the bound and
   its time over SDPA's backward.
   9h. recurrentgemma-2b at full width over 5 layers (one rematerialised
   (rglru, rglru, attn) super-block and the 2-block remainder) at (1,
   4096), the JAX package's train_4k length: ``rglru_scan`` 6 forward (2,
   2 recomputed in the backward, 2) and 4 backward launches a step; the
   plain route puts ``rglru_ref`` and ``rglru_bwd_ref`` in the kernels'
   places.  The backward kernel alone at (1, 4096, 2560) on the first
   backward call's inputs (the model's gates) and on long-memory gates:
   against ``rglru_bwd_ref`` (``RGLRU_BWD_REL``) and both against the
   float64 reverse recurrence (``RGLRU_BWD_F64_REL``), the same bits
   twice, and timed.

10. The dry-run CLIs (``python -m repro_torch.launch.dryrun --arch
   whisper-tiny --shape decode_32k``, ``--arch llama3-8b --shape train_4k
   --multi-pod both``, ``--arch granite-moe-1b-a400m --shape train_4k``,
   ``--arch xlstm-1.3b --shape train_4k``, ``python -m
   repro_torch.launch.dryrun_diffusion --family sd3``): meta-device
   traces on fake-process-group meshes of 256
   and 512 ranks, each in a process of its own with the card hidden from
   it, started with the script and run on the host's cores beside the
   card's phases (at a lower priority); read after phase 9: each must
   exit 0 with its ``OK`` lines; printed: the lines and each process's
   wall.

The phases run in the order 1, 2, 3, 4, 5, 6, 4t (with 6t and 7t), 5t,
4q, 5q,
6q, 4b, 4c, 5b, 6b, 5c, 4n, 5n, 4nq, 6n, 7l, 5l, 7p, 7s, 5s, 8h, 8w, 8d,
8s, 8z, 9w, 9h, 10
(whose processes start before phase 1).  Before the last two lines, one
JSON ``kernels`` line
lists every kernel, ``quantize_rows`` (which replaces plain code, not a
Pallas kernel) among them: its ``launches`` are the count from its own
path's run (the single-adapter LoRA kernel has no serving path: 0;
``rglru_scan``'s are phase 8h's prefill; ``launches_by_path`` gives each
path's count where a kernel has several, the sharded plane's under
``sharded``, phase 4t's under each request's label (``sd3.5-large:cn1``,
``flux-schnell:cn2 int8``, ``flux-schnell mixed LoRA``, ...) and 7t's
traces under ``s2 trace``, ``s5 trace``, ``s3 trace int8`` and ``s4 trace
int8``, whisper-tiny's prefill and train run among flash
attention's; the backward kernels' are phase 9's 3-step runs), and each
leads with the largest shape its path launched (``rglru_scan`` with its
served shape), the others under ``other_shapes``.  The line before the last
is the card's name and power limit as nvidia-smi prints them; the last line
is the JSON result.  Without a CUDA device, or without the repository beside
it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, the f32
# rate outside the tensor cores (which bounds an f32 FMA kernel) and the
# tensor cores' rates.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12,
              "tf32": 495e12}
# the f32 D = 128 route's two kernels: the split-plane pre-pass and the
# wgmma tiles
D128_KERNELS = ("flash_split128_kernel", "flash_wgmma128_kernel")
# every CUDA kernel the flash-attention wrapper launches, by route: the
# CUDA-core template, the D = 64 tensor-core tiles, the D = 128 route, the
# D = 1024 split-KV grid and its merge
FLASH_KERNELS = ("flash_fwd_kernel", "flash_mma64_kernel", *D128_KERNELS,
                 "flash_splitkv_kernel", "flash_merge_kernel")
# of those, the one each call of the wrapper launches once, whatever its route
FLASH_MAIN_KERNELS = ("flash_fwd_kernel", "flash_mma64_kernel",
                      "flash_wgmma128_kernel", "flash_splitkv_kernel")
# every CUDA kernel the LoRA wrappers launch: the x @ A pre-pass and the GEMM
LORA_KERNELS = ("lora_xa_kernel", "lora_matmul_kernel")
# every CUDA kernel the quant_matmul wrapper launches: the GEMM and, for a
# product split along K, the kernel that adds the int32 partial sums
QUANT_KERNELS = ("quant_matmul_kernel", "quant_splitk_epilogue_kernel")
# substrings of the library kernels a profile sums by kind: cuDNN's
# convolutions (some named "..._implicit_gemm", so they are matched first)
# and cuBLAS's f32 GEMMs
CONV_KERNELS = ("conv", "fprop", "winograd", "cudnn")
GEMM_KERNELS = ("gemm",)
# the full-width fp32 image served through the kernel against the same
# request served through the plain attention route, relative
KERNEL_VS_PLAIN_REL = 1e-3

# head dim 128 (Flux's heads) under causal and window bands, on ragged and
# rectangular shapes and rows with no key; f32 and bf16
D128_BANDS = (((3, 500, 500, 128), True, None), ((2, 300, 300, 128), True, 37),
              ((1, 200, 150, 128), True, 1), ((3, 100, 333, 128), False, None),
              ((2, 333, 100, 128), False, None),
              # query blocks past Sk + window see no key tile at all
              ((1, 400, 150, 128), True, 1))
# phase 4t: Table 2's SD3.5-Large (S2) and Flux (S3) workflows at published
# width, each request at STEPS steps (flux-schnell's published count): the
# family, the REAL config it takes (flux-schnell shares flux-dev's
# backbone), its Table 2 setting, the workflows served in f32 and those
# served under int8, and the settings phase 7t replays through the
# launcher on the f32 weights and on the int8 weights.
# flux-schnell:cn2 is not served in f32: its bf16 weights and working
# memory exceed one card (phase 4t prints the reckoning)
TABLE2_RUNS = (("sd3.5-large", "sd3.5-large", "s2", ("basic", "cn1", "cn2"),
                ("basic", "cn1", "cn2"), ("s2", "s5"), ()),
               ("flux-schnell", "flux-dev", "s3", ("basic", "cn1"),
                ("basic", "cn1", "cn2"), (), ("s3",)))
# phase 7t after those runs: S4 under int8 on weights of its own; S6 (both
# Flux families) is reckoned from S3's and S4's readings, not served
TABLE2_INT8_TRACES = ("s4",)
# the REAL config a family takes where its name is not one
REAL_NAME = {"flux-schnell": "flux-dev"}
# each replay's peak device memory in GiB, predicted before its first run
# on the card from earlier readings (PERF.md section 6); printed beside the
# measured peak, no gate
TRACE_PEAK_GIB = {"s1": 15.18, "s2": 43.77, "s3": 51.0, "s4": 51.0,
                  "s5": 53.0}
# the basic requests' joint attention (Flux without CFG rows, SD3.5-Large
# with) and Flux's text encoder (4 heads of 1024 over 512 tokens)
FAMILY_SHAPES = ((24, 4608, 4608, 128), (76, 4429, 4429, 64),
                 (4, 512, 512, 1024))
GRID = [  # (BH, Sq, Sk, D), causal, window — tests/test_kernels.py's grid
    ((2, 128, 128, 64), False, None),
    ((2, 256, 256, 32), True, None),
    ((1, 200, 200, 16), True, 64),
    ((1, 64, 256, 64), False, None),
    ((2, 100, 300, 8), False, 128),
]
# (M, K, N, r): tests/test_kernels.py's LoRA grid, then the edge shapes of
# tests/test_multilora.py; (G, r) of its grouped grid at M=11, K=48, N=56,
# plus G*r = 160, the largest its property sweep draws
LORA_GRID = [(128, 128, 128, 8), (200, 96, 160, 16), (64, 256, 512, 4),
             (300, 300, 300, 32)]
LORA_EDGE = [(1, 8, 8, 1), (5, 24, 40, 3), (33, 128, 96, 8),
             (128, 100, 200, 64)]
LORA_GROUPED = [(1, 4), (3, 8), (4, 1), (5, 32)]
STEPS = 4
REQUESTS = [{"seed": 42, "prompt": "a watercolor fox in a snowy forest"},
            {"seed": 7, "prompt": "a lighthouse on a cliff at dusk, oil paint"}]
MIXED = [("sd3:lora:tenantA", {"seed": 42, "prompt": "a watercolor fox in a snowy forest"}),
         ("sd3:lora:tenantB", {"seed": 7, "prompt": "a lighthouse on a cliff at dusk, oil paint"}),
         ("sd3:basic", {"seed": 11, "prompt": "a red tram crossing a bridge in the rain"})]
TOY_MIXED = [("sd3:lora:tenantA", 3), ("sd3:lora:tenantB", 3), ("sd3:basic", 3)]
# the ControlNet path: one request of each ControlNet workflow, seeded as
# REQUESTS, each with its own reference image (seeded by REF_SEEDS)
CN_NAMES = ("sd3:cn1", "sd3:cn2")
REF_SEEDS = (101, 202)
# a control must move the image by more than this many times the larger
# kernel-vs-plain error of the ControlNet requests
CONTROL_FACTOR = 10
TARGETS = 4                    # q, k, v, o of the image stream
# tenant A in the mixed batch against its folded solo run, relative: above
# the fold's bf16 rounding (3.8e-3 on an H100), below what a dropped or
# swapped adapter gives (phase 4b reads both controls)
TENANT_FOLD_REL = 1e-2
LIBRARY = "cuBLAS composite: x @ W.float() + ((x @ A_cat.float()) * mask) @ B_cat.float()"
# (M, K, N): tests/test_quant.py's int8 grid
QUANT_GRID = [(1, 8, 8), (5, 24, 40), (33, 128, 96), (128, 100, 200)]
# each route of the CUDA product (kernel.plan): M 1, 4 and 64 on the 16-row
# tiles (split along K), 333 (split along K at K 16384) and 1332 on the
# 64-row tiles, ragged M on the 128-row tiles, then byte loads (K or N not a
# multiple of 16), split or not
QUANT_ROUTES = [(1, 1536, 9216), (4, 1536, 9216), (64, 4096, 1536),
                (333, 4096, 4096), (333, 16384, 4096), (1332, 1536, 1536),
                (2000, 1536, 6144), (37, 200, 130), (3, 1000, 72),
                (700, 999, 4100)]
# (M, K) for the row quantization beyond the path's shapes: ragged K (K % 4
# != 0 takes element loads), 32 to 1024 threads a row, and rows longer than
# the registers hold (read twice)
ROWS_EDGE = [(1, 17), (37, 1000), (9, 1001), (5, 3001), (3, 20000),
             (2, 40000), (2, 40001)]
QUANT_LIBRARY = "torch._int_mm(xq, wq).float() * xs * ws"
# the int8 image against the fp32 one, relative: int8 moves the served
# image by a few 1e-2 (the JAX package: 2.8e-2 to 3.5e-2 at the toy size);
# a wrong scale or a swapped operand gives order 1
INT8_VS_FP32_REL = 0.25
# toy image, card against CPU, per mode (the CPU tests' served bounds:
# int8 rounding flips move the int8 image by about 2e-2)
TOY_QUANT_REL = {"int8": 2.5e-2, "fp8": 1e-4}
# phases 7l and 7t: the serving launcher's arguments but the setting and
# the device (its defaults, on one executor: every executor of one
# LocalBackend shares the one card)
SERVE_ARGS = ["--plane", "local", "--executors", "1",
              "--rate", "1.0", "--duration", "120", "--cv", "2.0",
              "--slo-scale", "2.0"]
# phase 7p: the process plane's executors for the basic and kill runs, each
# a worker process with its own CUDA context and copy of the weights on the
# one card; the segment chunk that splits a request's steps across RPCs
PROC_EXECUTORS = 2
PROC_CHUNK = 2
# phase 7s: the sharded plane's slots (each a torch.device of the one card,
# told apart by identity) and the parallelism degrees it serves at: k = 2
# splits a CFG pair's rows, k = 4 shards the image tokens
SHARD_SLOTS = 4
SHARD_KS = (2, 4)
# what phase 7s's profiles sum by kind: the copy kernels are the
# submesh's gathers and concatenations (torch.cat, contiguous copies)
SHARD_PROFILE = {"flash_attention": FLASH_KERNELS, "f32_gemms": GEMM_KERNELS,
                 "copies": ("CatArray", "copy", "Memcpy")}
# (B, T, D): tests/test_kernels.py's RG-LRU grid, then RecurrentGemma-2B's
# width (D 2560) at two batch and sequence splits
RGLRU_GRID = [(2, 128, 128), (1, 200, 96), (3, 64, 256), (2, 300, 50)]
RGLRU_WIDE = [(1, 8192, 2560), (8, 2048, 2560)]
RGLRU_ODD = [(2, 3001, 50), (3, 1, 7)]
# against the float64 literal recurrence, absolute and relative: float32
# roundings add up over the long-memory gates' memory length (7.7e-6 at
# (1, 8192, 2560) on the H100)
RGLRU_F64_TOL = 5e-5


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------ dry runs

# phase 10: the dry-run CLIs (meta-device traces on a fake-process-group
# mesh; no card needed) and the lines each must print
DRYRUNS = [
    (["repro_torch.launch.dryrun", "--arch", "whisper-tiny", "--shape",
      "decode_32k"], ["OK   whisper-tiny x decode_32k x 16x16"]),
    (["repro_torch.launch.dryrun", "--arch", "llama3-8b", "--shape",
      "train_4k", "--multi-pod", "both"],
     ["OK   llama3-8b x train_4k x 16x16",
      "OK   llama3-8b x train_4k x 2x16x16"]),
    (["repro_torch.launch.dryrun_diffusion", "--family", "sd3"],
     ["OK   diffusion:sd3"]),
    # the MoE and xLSTM train steps (routing and log-sigmoid on local
    # shards), the longest traces of the set
    (["repro_torch.launch.dryrun", "--arch", "granite-moe-1b-a400m",
      "--shape", "train_4k"], ["OK   granite-moe-1b-a400m x train_4k x 16x16"]),
    (["repro_torch.launch.dryrun", "--arch", "xlstm-1.3b", "--shape",
      "train_4k"], ["OK   xlstm-1.3b x train_4k x 16x16"]),
]


def start_dryruns() -> list:
    """Start phase 10's CLIs, each in its own process: they need the host's
    cores only (the card is hidden from them), so they run beside the
    card's phases, at a lower priority."""
    import atexit
    import tempfile
    import threading

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    started = []
    for args, want in DRYRUNS:
        # files, not pipes: a full pipe would stall the process until read
        logs = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
        proc = subprocess.Popen(
            [sys.executable, "-m", *args], cwd=str(ROOT), env=env,
            stdout=logs[0], stderr=logs[1], text=True,
            preexec_fn=lambda: os.nice(10))
        # each process's own wall: a thread notes when it ends
        times = [time.perf_counter(), None]
        threading.Thread(target=lambda p=proc, t=times: (
            p.wait(), t.__setitem__(1, time.perf_counter())),
            daemon=True).start()
        started.append((args, want, proc, logs, times))

    def stop():                  # a failed phase leaves none running
        for _, _, proc, _, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop)
    return started


def finish_dryruns(started, card) -> list:
    """Phase 10: each CLI must exit 0 with its ``OK`` lines; prints each
    one's wall and its lines."""
    out = []
    for args, want, proc, logs, times in started:
        proc.wait(timeout=1200)
        time.sleep(0.1)                 # let the thread note the end
        wall = (times[1] or time.perf_counter()) - times[0]
        stdout, stderr = (f.seek(0) or f.read() for f in logs)
        lines = [ln for ln in stdout.splitlines()
                 if ln.startswith(("OK", "FAIL", "SKIP"))]
        for ln in lines:
            log(f"[dryrun] {ln}")
        missing = [w for w in want if not any(ln.startswith(w)
                                               for ln in lines)]
        if proc.returncode != 0 or missing:
            raise AssertionError(f"10: python -m {' '.join(args)} exited "
                                 f"{proc.returncode}, missing {missing}: "
                                 f"{stderr[-2000:]}")
        log(f"[dryrun] python -m {' '.join(args)}: exit 0, wall {wall:.1f} s "
            f"(started with the script, beside the card's phases, on the "
            f"host's cores)  [{card}]")
        out.append({"cmd": " ".join(args), "wall_s": wall, "lines": lines})
    return out


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


def queued_ms(torch, fn, calls: int = 20) -> float:
    """The card's own milliseconds a call of ``fn``: after 2 warm-ups, the
    ``calls`` calls are queued behind a sleep kernel and timed by CUDA
    events around them all, so none waits on the wrapper's host work (a
    single call's event time holds it: ``cuda_ms``).  The sleep grows
    until the host has queued every call before it ends; a wrapper that
    waits on the card would never get there, and raises.

    The profiler's per-call device time is not read: it loses kernel
    records (on the H100, 2 or 3 of 10 or 20 launches in a session of its
    own, and 12, then all 20, of 20 inside this script's run;
    ``tools/device_time_check.py``), so a sum over the calls
    under-counts."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    cycles = 10**7                       # about 5 ms at the H100's clock
    while cycles <= 10**10:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        ahead = not start.query()        # the card still sleeps
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / calls
        cycles *= 8
    raise AssertionError("queued_ms: the host did not queue the calls "
                         "ahead of the card")


def bound(nbytes: float, flops: float, dtype_name: str) -> tuple:
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_bound_ms(bh, sq, sk, d, dtype_name) -> tuple:
    """Least time for one attention call: each of q, k, v read once and o
    written once, against 4*BH*Sq*Sk*D operations at the peak for the
    inputs' type; for f32, at the rate of three TF32 passes (the kernel's
    f32-accurate products).  Returns (ms, bound_by, ms at the f32 FMA
    rate)."""
    elem = 4 if dtype_name == "float32" else 2
    nbytes, flops = elem * bh * d * (2 * sq + 2 * sk), 4.0 * bh * sq * sk * d
    if dtype_name != "float32":
        return (*bound(nbytes, flops, dtype_name), None)
    return (*bound(nbytes, 3 * flops, "tf32"),
            bound(nbytes, flops, "float32")[0])


def attention_inputs(torch, shape, dtype, seed=0):
    bh, sq, sk, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((bh, n, d), generator=gen, device="cuda").to(dtype)
            for n in (sq, sk, sk)]


def check_attention(torch, fa, shape, causal, window, dtype, atol,
                    same_bits=False) -> float:
    """max |error| of the kernel against the plain version (raises above
    ``atol``); with ``same_bits``, a second call must give the same bits."""
    q, k, v = attention_inputs(torch, shape, dtype)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = fa.attention_ref(q, k, v, causal=causal, window=window)
    err = float((out.float() - want.float()).abs().max())
    if not err <= atol:
        raise AssertionError(f"flash_attention {shape} causal={causal} "
                             f"window={window} {dtype}: max |err| {err} > {atol}")
    if same_bits and not torch.equal(
            out, fa.flash_attention(q, k, v, causal=causal, window=window)):
        raise AssertionError(f"flash_attention {shape} causal={causal} "
                             f"window={window} {dtype}: a second call gave "
                             f"other bits")
    return err


def check_split_planes(torch, fa, fref, shape) -> None:
    """The f32 D = 128 route's pre-pass on its own, bit for bit against
    ``split_planes_ref`` (its hi and lo parts are exact bit operations)."""
    _, k, v = attention_inputs(torch, shape, torch.float32, seed=3)
    got = fa.split_planes(k, v)
    torch.cuda.synchronize()
    if not torch.equal(got, fref.split_planes_ref(k, v, tile=fa.D128_TILE)):
        raise AssertionError(f"split planes {shape}: not bit-identical to "
                             f"the plain version")


def time_attention(torch, fa, shape, dtype, reps=10) -> dict:
    import torch.nn.functional as F

    q, k, v = attention_inputs(torch, shape, dtype, seed=1)
    dname = str(dtype).replace("torch.", "")
    bound_ms, bound_by, _ = attention_bound_ms(*shape, dname)
    out = {
        "shape": "BH=%d,Sq=%d,Sk=%d,D=%d,%s" % (*shape, dname),
        "ms": cuda_ms(torch, lambda: fa.flash_attention(q, k, v), reps),
        "queued_ms": queued_ms(torch, lambda: fa.flash_attention(q, k, v)),
        "plain_ms": cuda_ms(torch, lambda: fa.attention_ref(q, k, v), reps),
        "library_ms": cuda_ms(
            torch, lambda: F.scaled_dot_product_attention(q, k, v), reps),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    if shape[3] == 128 and dtype == torch.float32:
        # the D = 128 route's pre-pass alone (part of ``ms``)
        out["split_ms"] = cuda_ms(torch, lambda: fa.split_planes(k, v), reps)
    return out


def log_attention_time(timing, shape, card) -> None:
    """A ``[time]`` line of :func:`time_attention`'s numbers with the f32
    FMA bound beside them (f32 shapes; the ``kernels`` line leaves it out)."""
    f32_fma_ms = attention_bound_ms(*shape, "float32")[2]
    log(f"[time] {json.dumps({**timing, 'bound_f32_fma_ms': f32_fma_ms})}"
        f"  [{card}]")


def check_split_kv(torch, fa, fref, shape, causal, window, atol=2e-5) -> float:
    """The split-KV route's kernels on their own: the partials against
    ``attention_partial_ref``, and the merge of the plain partials against
    ``merge_partials_ref`` (atol = rtol: the partial sums are unnormalised,
    up to 64 times an element of v).  Returns the largest |error|."""
    q, k, v = attention_inputs(torch, shape, torch.float32, seed=2)
    o, m, l = fa.split_kv_partials(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    wo, wm, wl = fref.attention_partial_ref(
        q, k, v, chunk=fa.SPLIT_KV_CHUNK, causal=causal, window=window)
    if not torch.equal(l > 0, wl > 0) or not torch.equal(m[wl == 0], wm[wl == 0]):
        raise AssertionError(f"split-KV partials {shape}: chunks with no key "
                             f"of a row differ from the plain version's")
    what = f"split-KV {shape} causal={causal} window={window}"
    err = max(close_or_raise(f"{what} o", o, wo, atol, atol),
              close_or_raise(f"{what} m", m, wm, atol, atol),
              close_or_raise(f"{what} l", l, wl, atol, atol))
    merged = fa.split_kv_merge(wo, wm, wl)
    torch.cuda.synchronize()
    return max(err, close_or_raise(f"{what} merge", merged,
                                   fref.merge_partials_ref(wo, wm, wl),
                                   atol, atol))


# ------------------------------------------------------------------ LoRA

def lora_inputs(torch, m, k, n, cols, types, seed=0):
    """x [m, k], W [k, n] / sqrt(k), A_cat [k, cols] / sqrt(k), B_cat
    [cols, n], drawn in f32 on the card and cast to (x, W, factors)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape, dtype, div=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") / div).to(dtype)

    return (draw((m, k), types[0]), draw((k, n), types[1], math.sqrt(k)),
            draw((k, cols), types[2], math.sqrt(k)), draw((cols, n), types[2]))


def path_idx(torch, groups, rows_per_group):
    """The path's row order: each request's rows in turn (adapter 0, 1,
    none), cond rows then the CFG-null rows."""
    idx = [g for g in groups for _ in range(rows_per_group)]
    return torch.tensor(idx, dtype=torch.int32, device="cuda")


def cycle_idx(torch, m, g):
    return torch.tensor([(i % (g + 1)) - 1 for i in range(m)],
                        dtype=torch.int32, device="cuda")


def close_or_raise(what, out, want, atol, rtol) -> float:
    diff = (out.float() - want.float()).abs()
    err = float(diff.max())
    if not bool((diff <= atol + rtol * want.float().abs()).all()):
        raise AssertionError(f"{what}: max |err| {err} over atol {atol}, "
                             f"rtol {rtol}")
    return err


def check_lora_single(torch, lk, lref, shape, types, scale, atol, rtol):
    m, k, n, r = shape
    x, w, a, b = lora_inputs(torch, m, k, n, r, types)
    out = lk.lora_matmul(x, w, a, b, scale=scale)
    torch.cuda.synchronize()
    return close_or_raise(f"lora_matmul {shape} {types}", out,
                          lref.lora_matmul_ref(x, w, a, b, scale=scale),
                          atol, rtol)


def check_lora_grouped(torch, lk, lref, shape, types, idx, atol, rtol):
    m, k, n, g, r = shape
    x, w, a, b = lora_inputs(torch, m, k, n, g * r, types)
    scales = torch.tensor([0.5 + 0.25 * i for i in range(g)], device="cuda")
    out = lk.lora_matmul_grouped(x, w, a, b, idx, scales)
    torch.cuda.synchronize()
    return close_or_raise(
        f"lora_matmul_grouped {shape} {types}", out,
        lref.lora_matmul_masked_ref(x, w, a, b, idx, scales), atol, rtol)


def lora_bound_ms(lk, m, k, n, g, r, rows_with_adapter, types,
                  grouped) -> tuple:
    """Each input read once and the output written once, against the
    operations this run's rows need: x @ W for every row, and x @ A,
    (x A) @ B over r rank columns for each row that carries an adapter.
    With an f32 operand, at the rate of the TF32 passes the kernel runs
    per product (``lk.tf32_passes``: 2 for f32 x and bf16 W, 3 for all
    f32), as its f32-accurate products run; all-bf16 at the bf16 rate.
    Returns (ms, bound_by, ms at the f32 FMA rate or None)."""
    size = {"torch.float32": 4, "torch.bfloat16": 2}
    xb, wb, fb = (size[str(t)] for t in types)
    nbytes = (m * k * xb + k * n * wb + (k + n) * g * r * fb + m * n * xb
              + (m * 4 + g * 4 if grouped else 0))
    flops = 2.0 * m * k * n + 2.0 * rows_with_adapter * r * (k + n)
    if "torch.float32" not in (str(types[0]), str(types[1])):
        return (*bound(nbytes, flops, "bfloat16"), None)
    passes = lk.tf32_passes(types[0], types[1])
    return (*bound(nbytes, passes * flops, "tf32"),
            bound(nbytes, flops, "float32")[0])


def time_lora(torch, lk, lref, spec, reps=10) -> tuple:
    """One LoRA kernel at one path shape: the kernel, its plain version and
    the cuBLAS composite that computes the same function, beside the
    bound; and the bound at the f32 FMA rate, for the ``[time]`` lines
    only.  ``spec``: (grouped, M, K, N, G, r, types, idx groups)."""
    grouped, m, k, n, g, r, types, groups = spec
    x, w, a, b = lora_inputs(torch, m, k, n, g * r, types, seed=1)
    tname = "/".join(str(t).replace("torch.", "") for t in types)
    if grouped:
        idx = path_idx(torch, groups, m // len(groups))
        scales = torch.tensor([0.5 + 0.25 * i for i in range(g)], device="cuda")
        sel = torch.zeros((m, g), device="cuda")
        has = idx >= 0
        sel[has, idx[has].long()] = scales[idx[has].long()]
        mask = sel.repeat_interleave(r, dim=1)
        rows = int(has.sum())
        kern = lambda: lk.lora_matmul_grouped(x, w, a, b, idx, scales)
        plain = lambda: lref.lora_matmul_masked_ref(x, w, a, b, idx, scales)
        lib = lambda: (x @ w.float()).add_(((x @ a.float()) * mask) @ b.float())
        label = "M=%d,K=%d,N=%d,G=%d,r=%d,%s" % (m, k, n, g, r, tname)
    else:
        rows = m
        kern = lambda: lk.lora_matmul(x, w, a, b, scale=0.7)
        plain = lambda: lref.lora_matmul_ref(x, w, a, b, scale=0.7)
        lib = lambda: (x @ w.float()).add_(((x @ a.float()) @ b.float()), alpha=0.7)
        label = "M=%d,K=%d,N=%d,r=%d,%s" % (m, k, n, r, tname)
    bound_ms, bound_by, fma_ms = lora_bound_ms(lk, m, k, n, g, r, rows, types,
                                               grouped)
    return {"shape": label,
            "ms": cuda_ms(torch, kern, reps),
            "queued_ms": queued_ms(torch, kern),
            "plain_ms": cuda_ms(torch, plain, reps),
            "library_ms": cuda_ms(torch, lib, reps),
            "library": LIBRARY if grouped else
            "cuBLAS composite: x @ W.float() + s * (x @ A.float()) @ B.float()",
            "bound_ms": bound_ms, "bound_by": bound_by}, fma_ms


def log_lora_time(timing, fma_ms, card) -> None:
    """A ``[time]`` line of :func:`time_lora`'s numbers with the f32 FMA
    bound beside them (the ``kernels`` line leaves it out)."""
    log(f"[time] {json.dumps({**timing, 'bound_f32_fma_ms': fma_ms})}"
        f"  [{card}]")


# ------------------------------------------------------- int8 quant matmul

def quant_inputs(torch, m, k, n, seed=0, fill=None):
    """Random int8 operands and float32 scales on the card (all ``fill``
    and unit scales when ``fill`` is given)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if fill is not None:
        return (torch.full((m, k), fill, dtype=torch.int8, device="cuda"),
                torch.full((k, n), fill, dtype=torch.int8, device="cuda"),
                torch.ones((m, 1), device="cuda"),
                torch.ones((1, n), device="cuda"))
    return (torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8),
            torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8),
            torch.rand((m, 1), generator=gen, device="cuda") / 50,
            torch.rand((1, n), generator=gen, device="cuda") / 50)


def check_quant(torch, qk, qref, shape, fill=None) -> float:
    """The kernel against its plain version: the same bits, or raise."""
    args = quant_inputs(torch, *shape, fill=fill)
    out = qk.quant_matmul(*args)
    torch.cuda.synchronize()
    want = qref.quant_matmul_ref(*args)
    if not torch.equal(out, want):
        err = float((out - want).abs().max())
        raise AssertionError(f"quant_matmul {shape}: not bit-identical to its "
                             f"plain version (max |err| {err})")
    return float((out - want).abs().max())


def quant_route(torch, qk, shape) -> str:
    """The route and split the kernel takes at ``shape`` on this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    route, splits = qk.plan(*shape, sms)
    return f"route {route}, {splits} split{'s' if splits > 1 else ''}"


def rows_inputs(torch, m, k, seed=0):
    """Normal draws on the card, with an all-zero row (scale 1) and rows
    whose maximum is 127 * 2**e, so the scale is exactly 2**e and every
    quotient lands on a .5 (round half to even decides it)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device="cuda") * 3
    x[0] = 0.0
    for row, e in ((1, 0), (2, -3), (3, 4)):
        if row < m:
            x[row] = (torch.randint(-127, 127, (k,), generator=gen,
                                    device="cuda").float() + 0.5) * 2.0 ** e
            x[row, k // 2] = 127.0 * 2.0 ** e
    return x


def check_rows(torch, qk, qref, shape) -> None:
    """The row quantization against its plain version: the same bits, or
    raise."""
    x = rows_inputs(torch, *shape)
    xq, xs = qk.quantize_rows(x)
    torch.cuda.synchronize()
    want_q, want_s = qref.quantize_rows_ref(x)
    if not (torch.equal(xq, want_q) and torch.equal(xs, want_s)):
        raise AssertionError(
            f"quantize_rows {shape}: not bit-identical to its plain version "
            f"({int((xq != want_q).sum())} values, "
            f"{int((xs != want_s).sum())} scales differ)")


def time_rows(torch, qk, qref, shape, reps=10) -> dict:
    """The row quantization at one path shape beside its plain version and
    its bound: x read once (4 bytes an element), xq written once (1 byte)
    and the scales (4 bytes a row), against 3 float32 operations an element
    (maximum, division, rounding).  No PyTorch call computes it."""
    m, k = shape
    x = rows_inputs(torch, m, k, seed=1)
    bound_ms, bound_by = bound(5.0 * m * k + 4.0 * m, 3.0 * m * k, "float32")
    return {"shape": "M=%d,K=%d,float32" % shape,
            "ms": cuda_ms(torch, lambda: qk.quantize_rows(x), reps),
            "queued_ms": queued_ms(torch, lambda: qk.quantize_rows(x)),
            "plain_ms": cuda_ms(torch, lambda: qref.quantize_rows_ref(x), reps),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def ptxas_report(log_text) -> list:
    """(function, registers, spill store bytes, spill load bytes) for each
    entry function in ``nvcc -Xptxas -v`` output."""
    out, name, spills = [], None, (0, 0)
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spills = (nums[1], nums[2])
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split()[0])
            out.append((name, regs, *spills))
            name, spills = None, (0, 0)
    return out


def quant_bound_ms(m, k, n) -> tuple:
    """xq, wq and the two scale vectors read once, the float32 output
    written once, against 2*M*K*N int8 operations."""
    return bound(m * k + k * n + 4 * (m + n) + 4 * m * n, 2.0 * m * k * n,
                 "int8")


def time_quant(torch, qk, qref, shape, reps=10) -> dict:
    """The kernel at one path shape beside its plain version, the bound,
    ``torch._int_mm`` with the same epilogue (None where its shape rules
    refuse), and the float32 product the "off" route runs there (f32 x
    against a bf16 weight, as ``qdense`` computes it)."""
    m, k, n = shape
    xq, wq, xs, ws = quant_inputs(torch, m, k, n, seed=1)
    x = torch.randn((m, k), device="cuda")
    w = torch.randn((k, n), device="cuda").to(torch.bfloat16)
    bound_ms, bound_by = quant_bound_ms(m, k, n)
    try:
        torch._int_mm(xq, wq)
        library_ms = cuda_ms(
            torch, lambda: torch._int_mm(xq, wq).float() * xs * ws, reps)
    except RuntimeError as e:
        log(f"[time] torch._int_mm refuses M={m}, K={k}, N={n}: "
            f"{str(e).splitlines()[0][:120]}")
        library_ms = None
    return {"shape": "M=%d,K=%d,N=%d,int8" % shape,
            "ms": cuda_ms(torch, lambda: qk.quant_matmul(xq, wq, xs, ws), reps),
            "queued_ms": queued_ms(torch, lambda: qk.quant_matmul(xq, wq, xs, ws)),
            "plain_ms": cuda_ms(
                torch, lambda: qref.quant_matmul_ref(xq, wq, xs, ws), reps),
            "library_ms": library_ms, "library": QUANT_LIBRARY,
            "off_route_f32_ms": cuda_ms(torch, lambda: x @ w.float(), reps),
            "bound_ms": bound_ms, "bound_by": bound_by}


def quant_path(dispatch_log, *families) -> tuple:
    """int8 products the served dispatches must have made, and their (M, K,
    N): 7 per stream and layer of each backbone and ControlNet forward (ada
    on the rows, q/k/v/o, w1 and w2 on every token row of the stream; the
    backbone on the CFG-doubled rows where the family uses CFG, a
    ControlNet on the latent rows, and its zero_proj and embeddings
    unquantized), 6 per layer of each text-encoder batch (2 layers); each
    dispatch at the width of the family its model id names."""
    expected, shapes = 0, set()

    def forward(cfg, rows):
        d, ff = cfg.d_model, cfg.d_ff
        shapes.add((rows, d, 6 * d))
        for m in (rows * cfg.image_tokens, rows * cfg.text_tokens):
            shapes.update({(m, d, d), (m, d, ff), (m, ff, d)})

    for disp in dispatch_log:
        family = dispatch_family(disp.model_id, families)
        cfg, n = family.toy, len(disp.nodes)
        if disp.model_id.startswith(("segment:", "backbone:")):
            fwd = (disp.segment_steps if disp.model_id.startswith("segment:")
                   else 1)
            cns = n_controlnets(disp.model_id)
            expected += fwd * (cfg.n_layers + cns * cn_layers(cfg)) * 2 * 7
            forward(cfg, (2 if family.uses_cfg else 1) * n)  # one-pass CFG
            if cns:
                forward(cfg, n)
        elif disp.model_id.startswith("controlnet"):
            expected += cn_layers(cfg) * 2 * 7
            forward(cfg, n)
        elif disp.model_id.startswith("text_encoder:"):
            expected += 2 * 6
            m, td = n * cfg.text_tokens, cfg.text_dim
            shapes |= {(m, td, td), (m, td, 4 * td), (m, 4 * td, td)}
    return expected, shapes


# ------------------------------------------------------------ RG-LRU scan

def rglru_inputs(torch, b, t, d, seed=0, long_memory=False):
    """Gates ``a`` as sigmoids of normal draws, or (``long_memory``) uniform
    in [0.99, 0.9999], RecurrentGemma's published range, where a carry
    lives for hundreds of steps; inputs ``x`` normal."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if long_memory:
        a = 0.99 + 0.0099 * torch.rand((b, t, d), generator=gen, device="cuda")
    else:
        a = torch.sigmoid(torch.randn((b, t, d), generator=gen, device="cuda"))
    return a, torch.randn((b, t, d), generator=gen, device="cuda")


def rglru_literal_f64(torch, a, x):
    """The recurrence step by step in float64 on the card."""
    a, x = a.double(), x.double()
    g = torch.sqrt(torch.clamp(1 - a * a, min=0.0)) * x
    out, h = torch.empty_like(a), torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        h = a[:, t] * h + g[:, t]
        out[:, t] = h
    return out


def check_rglru(torch, rk, rref, shape, long_memory=False, atol=2e-5):
    """max |kernel - plain| within ``atol``; for long-memory gates also the
    kernel's and the plain version's max |err| against the float64
    recurrence (within ``RGLRU_F64_TOL``), else None; the kernel's bits
    the same on a second call."""
    a, x = rglru_inputs(torch, *shape, long_memory=long_memory)
    out = rk.rglru_scan(a, x)
    torch.cuda.synchronize()
    what = f"rglru_scan {shape}{' long memory' if long_memory else ''}"
    plain = rref.rglru_ref(a, x)
    err = close_or_raise(what, out, plain, atol, atol)
    if not torch.equal(rk.rglru_scan(a, x), out):
        raise AssertionError(f"{what}: a second call gave other bits")
    if not long_memory:
        return err, None
    want = rglru_literal_f64(torch, a, x)
    return err, [close_or_raise(f"{what} {name} vs float64", got.double(),
                                want, RGLRU_F64_TOL, RGLRU_F64_TOL)
                 for name, got in (("kernel", out), ("plain", plain))]


def time_rglru(torch, rk, rref, shape, reps=10) -> dict:
    """Bound: a and x read once and h written once, 12 bytes an element."""
    a, x = rglru_inputs(torch, *shape, seed=1)
    b, t, d = shape
    bound_ms, bound_by = bound(12.0 * b * t * d, 6.0 * b * t * d, "float32")
    return {"shape": "B=%d,T=%d,D=%d,float32" % shape,
            "ms": cuda_ms(torch, lambda: rk.rglru_scan(a, x), reps),
            "queued_ms": queued_ms(torch, lambda: rk.rglru_scan(a, x)),
            "plain_ms": cuda_ms(torch, lambda: rref.rglru_ref(a, x), reps),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


# -------------------------------------------------------------- serving

def profile_path(torch, system, subs, card, label, kernels) -> dict:
    """Serve ``subs`` again on the warm system under the profiler; device
    time by kernel, the named kernels' time and shares and the idle share
    of the window.  ``kernels`` maps a name to the substrings of the CUDA
    kernel names it sums; a kernel counts for the first name it matches.
    The profiler can lose kernel records, so the flash-attention records
    are held against the wrapper's launches in the window: where any is
    missing, every device time of the profile is "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import kernel as fa

    torch.cuda.synchronize()
    launched = fa.flash_attention.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reqs = [system.submit(name, inputs=dict(inp), arrival=0.0, steps=STEPS)
                for name, inp in subs]
        system.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = fa.flash_attention.launches - launched
    if any(r.status != "done" for r in reqs):
        raise AssertionError(f"profiled {label} requests did not finish")
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if e.device_type.name == "CUDA" and dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    recorded = sum(r[1] for r in rows
                   if any(key in r[2] for key in FLASH_MAIN_KERNELS))
    if recorded != launched:
        log(f"[profile] {label}: {recorded} flash-attention kernel records "
            f"of {launched} launches; the profile's device times are not "
            f"measured  [{card}]")
        rows = []
    busy_ms = sum(r[0] for r in rows)
    out = {"window": f"{label}: {len(subs)} requests x {STEPS} steps, "
                     f"weights loaded",
           "wall_ms": wall_ms,
           "device_busy_ms": busy_ms if rows else "not measured",
           "idle_share": 1 - busy_ms / wall_ms if rows else "not measured",
           "flash_records": f"{recorded} of {launched} launches"}
    # each kernel counts once: for the first (name, substring) it matches
    owner = {r[2]: next(((name, key) for name, keys in kernels.items()
                         for key in keys if key in r[2]), None) for r in rows}
    for name, keys in kernels.items():
        by_key = {key: sum(r[0] for r in rows if owner[r[2]] == (name, key))
                  for key in keys}
        ms = sum(by_key.values())
        out[f"{name}_ms"] = ms if rows else "not measured"
        out[f"{name}_share_of_busy"] = ms / busy_ms if rows else "not measured"
        if len(keys) > 1 and rows:
            out[f"{name}_ms_by_kernel"] = by_key
    out["top_kernels"] = [{"ms": ms, "count": n, "name": name[:90]}
                          for ms, n, name in rows[:8]]
    log(f"[profile] {json.dumps(out)}  [{card}]")
    return out


def image_of(system, req):
    return system.coordinator.engine.value_of(
        req.ref_key(req.graph.outputs["image"]))


def rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def controlnet_weights(family, variants=(1, 2), device="cuda") -> dict:
    """The ControlNets' trees, drawn on ``device`` from their model ids'
    seeds through their own loads (so in the active quant mode's form),
    each with a nonzero ``cond_embed`` (normal x 1/sqrt(fan-in), from a
    fixed seed).  The JAX package's ``cond_embed`` is all zeros, with which
    the reference image could not change the served image.  Test weights
    only."""
    import torch
    from repro_torch.diffusion import ControlNet

    out = {}
    for variant in variants:
        params = ControlNet(family, variant).load(device)["params"]
        ce = params["cond_embed"]
        gen = torch.Generator(device=device).manual_seed(1000 + variant)
        draw = torch.randn(tuple(ce.shape), generator=gen, device=device)
        out[variant] = {**params,
                        "cond_embed": (draw / math.sqrt(ce.shape[0])).to(ce.dtype)}
    return out


def ref_image(torch, seed, size=1024):
    """A (1, size, size, 3) float32 reference image in [-1, 1] on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand((1, size, size, 3), generator=gen, device="cuda") * 2 - 1


def cn_system(family, cn_weights):
    """Table 2's S1 (sd3:basic, sd3:cn1, sd3:cn2 sharing one ModelSet) at
    the family's width on one card, the ControlNets on ``cn_weights``."""
    from repro_torch.diffusion import ModelSet

    ms = ModelSet(family)
    ms.cn1.weights, ms.cn2.weights = cn_weights[1], cn_weights[2]
    return family_system(ms, "s1")


def family_system(ms, setting, device="cuda"):
    """One executor on ``device`` serving Table 2's ``setting`` (the basic,
    +C.N.1 and +C.N.2 workflows of ``ms``'s family) on ``ms``."""
    from repro_torch.core import LocalBackend, ServingSystem
    from repro_torch.diffusion import table2_setting

    system = ServingSystem(n_executors=1, backend=LocalBackend(device=device))
    for wf in table2_setting(setting,
                             model_sets={ms.family.name: ms}).values():
        system.register(wf)
    return system


def lora_system(ms, device, multilora=True, backend=None):
    """The JAX package's multi-tenant serving setup (its test's
    ``_build_system``) on one executor: ``<family>:basic`` and two LoRA
    tenants of ``ms``'s family, on ``backend`` (by default
    ``LocalBackend(device)``).  Returns the system and its adapter models
    by id."""
    from repro_torch.core import (
        GraphCompiler,
        InlineTrivialPass,
        JitCompilePass,
        LocalBackend,
        Scheduler,
        SegmentFusionPass,
        ServingSystem,
        WorkflowRegistry,
    )
    from repro_torch.diffusion import make_basic_workflow, make_lora_workflow

    system = ServingSystem(n_executors=1,
                           backend=backend or LocalBackend(device=device))
    # no AsyncLoRAPass: its fold-in point depends on measured seconds, so
    # the batch would not be deterministic with it
    system.registry = WorkflowRegistry(GraphCompiler(
        [InlineTrivialPass(), SegmentFusionPass(), JitCompilePass()]))
    system.coordinator.scheduler = Scheduler(
        system.profiles, use_declared_max_batch=True, multilora=multilora)
    name = ms.family.name
    wfs = [make_basic_workflow(name, ms),
           make_lora_workflow(name, "tenantA", ms),
           make_lora_workflow(name, "tenantB", ms)]
    for wf in wfs:
        system.register(wf)
    adapters = {p.model_id: p for wf in wfs
                for node in wf.instantiate(steps=STEPS).nodes
                for p in node.op.patches}
    return system, adapters


def serve(system, subs, steps):
    reqs = [system.submit(name, inputs=dict(inp), arrival=0.0, steps=steps)
            for name, inp in subs]
    system.run()
    for (name, _), req in zip(subs, reqs):
        if req.status != "done":
            raise AssertionError(f"{name} request {req.rid}: {req.status}")
    return reqs


def check_image(torch, img, card, what):
    if (tuple(img.shape) != (1, 1024, 1024, 3) or img.device.type != "cuda"
            or not bool(torch.isfinite(img).all())
            or float(img.abs().max()) > 1.0):
        raise AssertionError(f"full-width image of {what} {tuple(img.shape)} "
                             f"{img.device} out of spec")


def cn_layers(cfg) -> int:
    """Layers of a ControlNet branch (``init_controlnet``'s default)."""
    return max(1, cfg.n_layers // 2)


def n_controlnets(model_id) -> int:
    """ControlNets fused into a segment: ``segment:<backbone>+<cn>+...``."""
    return model_id.count("+controlnet")


def dispatch_family(model_id, families):
    """The family among ``families`` that a dispatch's model id names:
    ``<kind>:<family>``, or a fused segment's
    ``segment:backbone:<family>+...``."""
    head = model_id.removeprefix("segment:").split("+")[0]
    return {f.name: f for f in families}[head.rsplit(":", 1)[-1]]


def expected_flash(dispatch_log, *families) -> tuple:
    """Flash-attention launches the dispatches must have made, and the
    shapes they gave the kernel: per step, a layer's launch for each of the
    backbone's (on the CFG-doubled rows where the family uses CFG) and each
    ControlNet's (on the latent rows); each dispatch at the width of the
    family its model id names (``dispatch_family``)."""
    expected, shapes = 0, set()
    for d in dispatch_log:
        family = dispatch_family(d.model_id, families)
        cfg, n = family.toy, len(d.nodes)
        rows = 2 if family.uses_cfg else 1     # backbone rows a request
        if d.model_id.startswith("segment:"):
            cns = n_controlnets(d.model_id)
            expected += d.segment_steps * (cfg.n_layers + cns * cn_layers(cfg))
            shapes.add((rows * n * cfg.n_heads, cfg.tokens, cfg.tokens,
                        cfg.head_dim))
            if cns:
                shapes.add((n * cfg.n_heads, cfg.tokens, cfg.tokens,
                            cfg.head_dim))
        elif d.model_id.startswith("controlnet"):
            expected += cn_layers(cfg)
            shapes.add((n * cfg.n_heads, cfg.tokens, cfg.tokens, cfg.head_dim))
        elif d.model_id.startswith("backbone:"):
            expected += cfg.n_layers
            shapes.add((rows * n * cfg.n_heads, cfg.tokens, cfg.tokens,
                        cfg.head_dim))
        elif d.model_id.startswith("text_encoder:"):
            expected += 2                      # two layers
            shapes.add((4 * n, cfg.text_tokens, cfg.text_tokens,
                        cfg.text_dim // 4))
    return expected, shapes


def s1_model_set(family, cn_weights, device="cuda"):
    """Table 2's S1 ``ModelSet`` at the family's width with every model's
    weights drawn once, on ``device`` (the text encoder, backbone and VAE
    from their model ids' seeds; the ControlNets ``cn_weights``): systems
    built on it load by reference and draw nothing."""
    ms = draw_model_set(family, 0, device)
    ms.cn1.weights, ms.cn2.weights = cn_weights[1], cn_weights[2]
    return ms


def tree_gib(tree) -> float:
    """GiB held by the tensor leaves of a parameter tree."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree)
               if hasattr(t, "element_size")) / 2**30


def draw_model_set(family, n_cns, device="cuda"):
    """A ``ModelSet`` of ``family`` whose models' weights are drawn once on
    ``device`` through the models' own loads, so in the active quant mode's
    form with no bf16 tree kept beside a quantized one, and the first
    ``n_cns`` ControlNets (``controlnet_weights``): every workflow's fused
    segment built on it loads these by reference and draws nothing."""
    from repro_torch.diffusion import ModelSet

    ms = ModelSet(family)
    for model in (ms.text_enc, ms.backbone, ms.vae_dec):
        model.weights = model.load(device)["params"]
    ms.vae_enc.weights = ms.vae_dec.weights
    for variant, params in controlnet_weights(
            family, range(1, n_cns + 1), device).items():
        getattr(ms, f"cn{variant}").weights = params
    return ms


def table2_request(torch, system, family, wf, counters, card, quant=False):
    """One ``<family>:<wf>`` request (``REQUESTS[0]``; a ControlNet workflow
    with the reference image of ``REF_SEEDS[0]``) on ``system``, the kernel
    counts set to 0 just before and read just after.  Flash attention must
    have launched exactly as ``expected_flash`` reckons (a layer's launch a
    step for the backbone and each ControlNet, 2 for the text encoder), and
    under int8 ``quant_matmul`` and ``quantize_rows`` exactly as
    ``quant_path`` reckons; no other kernel.  Returns the printed record,
    the image, the submission and the shapes flash attention and
    ``quant_matmul`` were given."""
    cfg, name = family.toy, f"{family.name}:{wf}"
    inp = dict(REQUESTS[0])
    if wf != "basic":
        inp["ref_image"] = ref_image(torch, REF_SEEDS[0], 8 * cfg.latent_size)
    sub = (name, inp)
    start = len(system.coordinator.dispatch_log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    t0 = time.perf_counter()
    req = serve(system, [sub], STEPS)[0]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts(counters)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    dispatches = system.coordinator.dispatch_log[start:]
    label = name + (" int8" if quant else "")
    img = image_of(system, req)
    check_image(torch, img, card, label)
    want, flash_shapes = expected_flash(dispatches, family)
    want = {"flash_attention": want}
    n_cns = 0 if wf == "basic" else int(wf[2:])
    layers = cfg.n_layers + n_cns * cn_layers(cfg)
    if want["flash_attention"] != layers * STEPS + 2:
        raise AssertionError(f"{label}: the dispatches reckon "
                             f"{want['flash_attention']} flash launches")
    quant_shapes = set()
    if quant:
        want["quant_matmul"], quant_shapes = quant_path(dispatches, family)
        want["quantize_rows"] = want["quant_matmul"]
    if {k: n for k, n in launches.items() if n} != want:
        raise AssertionError(
            f"{label}: launches {launches}, expected {want}; dispatches "
            f"{[(d.model_id, len(d.nodes), d.segment_steps) for d in dispatches]}")
    record = {"wall_s": wall_s, "peak_gib": peak_gib, "launches": want,
              "dispatches": [(d.model_id, len(d.nodes), d.segment_steps)
                             for d in dispatches]}
    log(f"[table2] {label} at d {cfg.d_model}, {cfg.n_layers} layers (a "
        f"ControlNet {cn_layers(cfg)}), {cfg.n_heads} heads of "
        f"{cfg.head_dim}, {STEPS} steps: done, wall {wall_s:.2f} s (weights "
        f"on the card), peak memory {peak_gib:.2f} GiB, launches {want} "
        f"(exact), flash at {sorted(flash_shapes)}; image range "
        f"[{float(img.min()):.3f}, {float(img.max()):.3f}]  [{card}]")
    return record, img, sub, flash_shapes, quant_shapes


def table2_lora(torch, ms, card, counters, device="cuda"):
    """Phase 4t's mixed LoRA batch of ``ms``'s family: tenant A, tenant B
    and a basic request (``MIXED``'s inputs) in one multilora segment on
    the JAX package's multi-tenant setup.  The grouped kernel exactly 4
    times a layer a step, flash attention as ``expected_flash`` reckons,
    nothing else; the tenants' images differ; each image against its solo
    run (the basic request within 1e-4, a tenant folded within
    ``TENANT_FOLD_REL``), and tenant A's inputs without an adapter above
    that gate; then one direct grouped text-encoder call (one launch)
    against the folded encoder.  Returns the record and the grouped
    shapes, as ``time_lora`` specs by label."""
    family, cfg = ms.family, ms.family.toy
    name = family.name
    subs = [(f"{name}:{wf.split(':', 1)[1]}", inp) for wf, inp in MIXED]
    system, adapters = lora_system(ms, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    t0 = time.perf_counter()
    reqs = serve(system, subs, STEPS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts(counters)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    dispatches = list(system.coordinator.dispatch_log)
    segs = [d for d in dispatches
            if d.multilora and d.model_id.startswith("segment:")]
    want = {"lora_matmul_grouped": TARGETS * cfg.n_layers * STEPS,
            "flash_attention": expected_flash(dispatches, family)[0]}
    if (not segs or sum(d.segment_steps for d in segs) != STEPS
            or any(len(d.nodes) != 3 for d in segs)
            or {k: n for k, n in launches.items() if n} != want):
        raise AssertionError(
            f"{name} mixed LoRA batch: launches {launches}, expected {want}; "
            f"dispatches {[(d.model_id, len(d.nodes), d.segment_steps, d.multilora) for d in dispatches]}")
    images = [image_of(system, r) for r in reqs]
    for (label, _), img in zip(subs, images):
        check_image(torch, img, card, label)
    ab = float((images[0] - images[1]).abs().max())
    if not ab > 1e-6:
        raise AssertionError(f"{name}: tenants A and B gave the same image")
    log(f"[table2-lora] {name}: 3 requests (2 LoRA tenants + basic) in one "
        f"multilora segment, {STEPS} steps: done, wall {wall_s:.2f} s "
        f"(adapters drawn on the card), peak memory {peak_gib:.2f} GiB, "
        f"launches {want} (exact)  [{card}]")
    solo = {}
    for (label, inp), img in zip(subs, images):
        other = image_of(system, serve(system, [(label, inp)], STEPS)[0])
        solo[label] = rel(img, other)
        gate = 1e-4 if label.endswith(":basic") else TENANT_FOLD_REL
        if not solo[label] < gate:
            raise AssertionError(f"{label} grouped vs solo: rel err "
                                 f"{solo[label]} >= {gate}")
        log(f"[table2-lora] {label} grouped vs its solo run"
            f"{'' if gate == 1e-4 else ' (adapter folded)'}: rel err "
            f"{solo[label]:.3e} < {gate}")
    control = rel(images[0], image_of(system, serve(
        system, [(f"{name}:basic", subs[0][1])], STEPS)[0]))
    if not control > TENANT_FOLD_REL:
        raise AssertionError(f"{name}: tenant A without its adapter: rel "
                             f"err {control} <= {TENANT_FOLD_REL}")
    log(f"[table2-lora] control, tenant A's inputs without an adapter: rel "
        f"err {control:.3e} > {TENANT_FOLD_REL}")
    # the text encoder's grouped wo, one direct call (the served batch's
    # text encoder carries no patch)
    backend = system.coordinator.backend
    enc = ms.text_enc
    enc_comps, _ = backend.ensure_loaded(enc)
    ads = [adapters[f"lora:tenantA:{name}"], adapters[f"lora:tenantB:{name}"]]
    pcs = {p.model_id: backend.adapter_pool.get(p)[0] for p in ads}
    batch = [{"prompt": inp["prompt"], "_patches": ps}
             for (_, inp), ps in zip(subs, ([ads[0]], [ads[1]], []))]
    zero_counts(counters)
    got = enc.execute_batch_multilora(enc_comps, batch, pcs)
    torch.cuda.synchronize()
    text = read_counts(counters)
    if got is None or {k: n for k, n in text.items() if n} != {
            "lora_matmul_grouped": 1, "flash_attention": 2}:
        raise AssertionError(f"{name} text encoder grouped call: {text}")
    for kw, out in zip(batch, got):
        comps = enc_comps
        for p in kw["_patches"]:
            comps = enc.fold_patches(enc_comps, [p], [pcs[p.model_id]])
        e = rel(out["prompt_embeds"],
                enc.execute(comps, prompt=kw["prompt"])["prompt_embeds"])
        if not e < 1e-4:
            raise AssertionError(f"{name} text encoder grouped vs folded: {e}")
    log(f"[table2-lora] {name} text encoder: one grouped launch (and 2 "
        f"flash) at ({3 * cfg.text_tokens}, {cfg.text_dim}, "
        f"{cfg.text_dim}), each row within 1e-4 of the folded encoder")
    # the image stream's rows: each request's, then the CFG-null copies
    groups = [0, 1, -1] * (2 if family.uses_cfg else 1)
    f32, bf16 = torch.float32, torch.bfloat16
    specs = {f"{name} mixed LoRA, image stream":
             (True, len(groups) * cfg.image_tokens, cfg.d_model, cfg.d_model,
              2, 8, (f32, bf16, bf16), groups),
             f"{name} mixed LoRA, text encoder":
             (True, 3 * cfg.text_tokens, cfg.text_dim, cfg.text_dim, 2, 8,
              (f32,) * 3, [0, 1, -1])}
    record = {"wall_s": wall_s, "peak_gib": peak_gib, "launches": want,
              "text_encoder_launches": 1, "solo_rel": solo,
              "control_rel": control}
    del system, adapters, reqs, images, backend, enc_comps, pcs, got
    return record, specs, expected_flash(dispatches, family)[1]


def table2_phase(torch, card, counters, device="cuda", real=None) -> dict:
    """Phase 4t (the docstring's 4t, 6t and 7t): for each of
    ``TABLE2_RUNS``, the family at its REAL width (``real`` maps the
    configs' names, ``REAL`` by default): the f32 requests, each against
    the plain attention route, the mixed LoRA batch, the run's f32 traces
    through the launcher (``table2_trace``), then the int8 requests, each
    against its f32 image (flux-schnell:cn2, which has none, against the
    plain int8 route, bit for bit), and the run's int8 traces; each system
    freed before the next.  Then ``TABLE2_INT8_TRACES`` on weights of
    their own, and S6's reckoning (``s6_reckoning``).  Returns each
    run's record under ``runs`` and the shapes each kernel was given on
    which path (``flash``, ``quant``, ``lora``)."""
    from repro_torch.diffusion import FAMILIES, REAL
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.quant_matmul import ref as qref
    from repro_torch.nn.layers import set_flash_attention, set_quant_mode

    real = real or REAL
    out = {"runs": {}, "flash": {}, "quant": {}, "lora": {}}
    for (name, real_name, setting, f32_wfs, int8_wfs, f32_traces,
         int8_traces) in TABLE2_RUNS:
        family = dataclasses.replace(FAMILIES[name], toy=real[real_name])
        cfg = family.toy
        n_cns = max(int(wf[2:]) for wf in f32_wfs if wf != "basic")
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        ms = draw_model_set(family, n_cns, device)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[table2] {name} at REAL[{real_name!r}], f32: weights drawn in "
            f"{time.perf_counter() - t0:.2f} s, peak {peak:.2f} GiB: backbone "
            f"{tree_gib(ms.backbone.weights):.2f} GiB, "
            + ", ".join(f"cn{v} {tree_gib(getattr(ms, f'cn{v}').weights):.2f}"
                        f" GiB" for v in range(1, n_cns + 1)) + f"  [{card}]")
        weights_gib = {"backbone": tree_gib(ms.backbone.weights),
                       "controlnet": tree_gib(ms.cn1.weights)}
        system = family_system(ms, setting, device)
        images = {}
        for wf in f32_wfs:
            rec, img, sub, fshapes, _ = table2_request(
                torch, system, family, wf, counters, card)
            label = sub[0]
            for shape in fshapes:
                out["flash"].setdefault(shape, label)
            prev = set_flash_attention(False)
            try:
                before = read_counts(counters)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plain = image_of(system, serve(system, [sub], STEPS)[0])
                torch.cuda.synchronize()
                rec["plain_route_s"] = time.perf_counter() - t0
                moved = launched_since(counters, before)
                if moved:
                    raise AssertionError(f"{label}: the plain attention "
                                         f"route launched kernels {moved}")
            finally:
                set_flash_attention(prev)
            rec["kernel_vs_plain_rel"] = e = rel(img, plain)
            if not e < KERNEL_VS_PLAIN_REL:
                raise AssertionError(f"{label}: image through the kernel vs "
                                     f"the plain attention route: {e}")
            log(f"[table2] {label}: image through the kernel vs the plain "
                f"attention route rel err {e:.3e} < {KERNEL_VS_PLAIN_REL}; "
                f"the plain route served it in {rec['plain_route_s']:.2f} s")
            images[wf] = img.cpu()
            out["runs"][label] = rec
            del img, plain
            if wf == "cn1":
                # 6t. where the time goes: the request again, warm
                rec["profile"] = profile_path(
                    torch, system, [sub], card, label,
                    {"flash_attention": FLASH_KERNELS, "convs": CONV_KERNELS,
                     "f32_gemms": GEMM_KERNELS})
        if "cn2" not in f32_wfs:
            peak = out["runs"][f"{name}:cn1"]["peak_gib"]
            work = peak - weights_gib["backbone"] - weights_gib["controlnet"]
            stack = cfg.n_layers * cfg.image_tokens * cfg.d_model * 4 / 2**30
            need = (weights_gib["backbone"] + 2 * weights_gib["controlnet"]
                    + work + stack)
            total = torch.cuda.get_device_properties(0).total_memory / 2**30
            cost = ms.cn1.cost().param_bytes / 2**30
            out["runs"][f"{name}:cn2 f32 reckoning"] = {
                "weights_gib": weights_gib["backbone"]
                + 2 * weights_gib["controlnet"], "cn1_working_gib": work,
                "residual_stack_gib": stack, "need_gib": need,
                "card_gib": total, "cost_model_controlnet_gib": cost}
            log(f"[table2] {name}:cn2 in f32 is not served on one card: "
                f"backbone {weights_gib['backbone']:.2f} GiB + 2 ControlNets x "
                f"{weights_gib['controlnet']:.2f} GiB of bf16 weights, plus "
                f"cn1's measured working memory {work:.2f} GiB (its peak "
                f"{peak:.2f} less its weights) and a second residual stack "
                f"{stack:.2f} GiB: {need:.2f} GiB against the card's "
                f"{total:.2f} GiB (the cost model prices a ControlNet at "
                f"{cost:.2f} GiB)  [{card}]")
        del system
        free(torch)
        if name == "flux-schnell":     # the LoRA batch needs no ControlNet
            ms.cn1.weights = ms.cn2.weights = None
            free(torch)
        rec, specs, fshapes = table2_lora(torch, ms, card, counters, device)
        out["runs"][f"{name} mixed LoRA"] = rec
        out["lora"].update(specs)
        for shape in fshapes:
            out["flash"].setdefault(shape, f"{name} mixed LoRA")
        free(torch)
        for trace in f32_traces:
            # 7t. a setting's trace through the serving launcher
            table2_trace(torch, trace, {name: ms}, card, counters, device,
                         real, out)
        del ms
        free(torch)

        prev_mode = set_quant_mode("int8")
        try:
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            ms = draw_model_set(family, max(int(wf[2:]) for wf in int8_wfs
                                            if wf != "basic"), device)
            torch.cuda.synchronize()
            log(f"[table2] {name} int8: weights drawn and quantized at load "
                f"in {time.perf_counter() - t0:.2f} s, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB: backbone "
                f"{tree_gib(ms.backbone.weights):.2f} GiB, cn1 "
                f"{tree_gib(ms.cn1.weights):.2f} GiB  [{card}]")
            system = family_system(ms, setting, device)
            for wf in int8_wfs:
                rec, img, sub, fshapes, qshapes = table2_request(
                    torch, system, family, wf, counters, card, quant=True)
                label = sub[0] + " int8"
                for shape in fshapes:
                    out["flash"].setdefault(shape, label)
                for shape in qshapes:
                    out["quant"].setdefault(shape, label)
                if wf in images:
                    rec["int8_vs_fp32_rel"] = e = rel(img, images[wf])
                    if not e < INT8_VS_FP32_REL:
                        raise AssertionError(f"{label} vs f32: rel err {e}")
                    log(f"[table2] {label} vs the f32 image: rel err "
                        f"{e:.3e} < {INT8_VS_FP32_REL}")
                else:
                    # no f32 image: the plain versions in the kernels' places
                    real_mm, real_rows = qops.quant_matmul, qops._quantize_rows
                    qops.quant_matmul = qref.quant_matmul_ref
                    qops._quantize_rows = qref.quantize_rows_ref
                    try:
                        before = read_counts(counters)
                        plain = image_of(system, serve(system, [sub], STEPS)[0])
                        moved = {k: v for k, v in launched_since(
                            counters, before).items()
                            if k in ("quant_matmul", "quantize_rows")}
                        if moved:
                            raise AssertionError(
                                f"{label}: the plain int8 route launched "
                                f"kernels {moved}")
                    finally:
                        qops.quant_matmul, qops._quantize_rows = real_mm, real_rows
                    if not torch.equal(img, plain):
                        raise AssertionError(f"{label}: kernels vs the plain "
                                             f"int8 route not bit-identical")
                    rec["bit_identical_to_plain_int8"] = True
                    log(f"[table2] {label} (no f32 image: f32 {name}:{wf} is "
                        f"not served on one card) vs the plain int8 route: "
                        f"bit-identical")
                    del plain
                out["runs"][label] = rec
                del img
            del system
            free(torch)
            for trace in int8_traces:
                table2_trace(torch, trace, {name: ms}, card, counters, device,
                             real, out)
            del ms
        finally:
            set_quant_mode(prev_mode)
        free(torch)
    prev_mode = set_quant_mode("int8")
    try:
        for trace in TABLE2_INT8_TRACES:
            table2_trace(torch, trace, {}, card, counters, device, real, out)
    finally:
        set_quant_mode(prev_mode)
    s6_reckoning(torch, out, card)
    return out


def model_set_gib(ms) -> float:
    """GiB of a ``ModelSet``'s drawn weights (the VAE's encoder shares its
    decoder's tree)."""
    return sum(tree_gib(getattr(ms, m).weights)
               for m in ("text_enc", "backbone", "vae_dec", "cn1", "cn2")
               if getattr(ms, m).weights is not None)


def table2_trace(torch, setting, shared, card, counters, device, real, out):
    """Phase 7t for ``setting``: the first 8 requests of its trace through
    the launcher, flags off (``trace_phase``), on one ``ModelSet`` a family
    of ``TABLE2_FAMILIES[setting]``: ``shared``'s (a family name to the
    ``ModelSet`` phase 4t drew), the rest drawn here at REAL width with
    both ControlNets in the active quant mode (quantized at load under
    int8) and freed after.  Records the run under ``<setting> trace``
    (`` int8`` under int8) in ``out["runs"]`` with each family's weights,
    the memory held before the replay and its peak, and its shapes under
    ``out["flash"]`` and ``out["quant"]``."""
    from repro_torch.diffusion import FAMILIES
    from repro_torch.diffusion.workflows import TABLE2_FAMILIES
    from repro_torch.nn.layers import quant_mode

    mode = quant_mode()
    label = f"{setting} trace" + (" int8" if mode == "int8" else "")
    model_sets = {}
    for name in TABLE2_FAMILIES[setting]:
        if name in shared:
            model_sets[name] = shared[name]
            continue
        real_name = REAL_NAME.get(name, name)
        family = dataclasses.replace(FAMILIES[name], toy=real[real_name])
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model_sets[name] = draw_model_set(family, 2, device)
        torch.cuda.synchronize()
        log(f"[table2] {label}: {name} at REAL[{real_name!r}] ({mode}): "
            f"weights drawn in {time.perf_counter() - t0:.2f} s, "
            f"{model_set_gib(model_sets[name]):.2f} GiB, load peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    weights = {name: model_set_gib(ms) for name, ms in model_sets.items()}
    held = torch.cuda.memory_allocated() / 2**30
    log(f"[table2] {label}: families {list(model_sets)} on one executor, "
        f"weights {', '.join(f'{n} {g:.2f} GiB' for n, g in weights.items())}"
        f"; {held:.2f} GiB held on the card before the replay  [{card}]")
    shapes, (summary,) = trace_phase(torch, model_sets, card, counters,
                                     device, setting=setting,
                                     flag_runs=(False,))
    peak = summary["peak_memory_gib"]
    out["runs"][label] = {
        "wall_s": summary["wall_s"], "done": summary["done"],
        "rejected": summary["rejected"], "admission": summary["admission"],
        "peak_gib": peak, "predicted_peak_gib": TRACE_PEAK_GIB[setting],
        "held_gib": held, "working_gib": peak - held, "weights_gib": weights,
        "cost_model_controlnet_gib": {
            name: ms.cn1.cost().param_bytes / 2**30
            for name, ms in model_sets.items()},
        "launches": {k: n for k, n in summary["launches"].items() if n}}
    for shape in shapes["flash"]:
        out["flash"].setdefault(shape, label)
    for shape in shapes["quant"]:
        out["quant"].setdefault(shape, label)
    del model_sets
    free(torch)


def s6_reckoning(torch, out, card) -> None:
    """S6 (flux-schnell and flux-dev on one executor) is not served on one
    card: both families' int8 weights as S3's and S4's replays measured
    them, plus S3's working memory (its peak over what the card held
    before it), against the card's memory.  The executor's eviction counts
    the cost model's bytes (a ControlNet at 0.72e9 parameters), and the
    weights stay referenced by their ``ModelSet``, so an eviction would
    free nothing."""
    s3, s4 = out["runs"]["s3 trace int8"], out["runs"]["s4 trace int8"]
    w3, w4 = s3["weights_gib"]["flux-schnell"], s4["weights_gib"]["flux-dev"]
    need = w3 + w4 + s3["working_gib"]
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    cost = s3["cost_model_controlnet_gib"]["flux-schnell"]
    out["runs"]["s6 reckoning"] = {
        "weights_gib": {"flux-schnell": w3, "flux-dev": w4},
        "s3_working_gib": s3["working_gib"], "need_gib": need,
        "card_gib": total, "cost_model_controlnet_gib": cost}
    verdict = "over" if need > total else "under"
    log(f"[table2] s6 (flux-schnell + flux-dev under int8) is not served on "
        f"one card: flux-schnell {w3:.2f} GiB + flux-dev {w4:.2f} GiB of int8 "
        f"weights (S3's and S4's draws), plus S3's measured working memory "
        f"{s3['working_gib']:.2f} GiB (its peak {s3['peak_gib']:.2f} less "
        f"the {s3['held_gib']:.2f} held before it): {need:.2f} GiB, {verdict} "
        f"the card's {total:.2f} GiB; the executor's eviction counts the "
        f"cost model's {cost:.2f} GiB a ControlNet and frees nothing the "
        f"ModelSet still holds  [{card}]")


def replay_trace(torch, model_sets, flags, argv, counters):
    """One run of the serving launcher (``repro_torch.launch.serve.serve``)
    on ``model_sets`` (a family name to its ``ModelSet``) with
    ``REPRO_DONATE`` and ``REPRO_OVERLAP`` both ``flags`` (both read at
    build and load, so the system is fresh), the kernel counts set to 0
    just before.  Returns the system, its wall seconds, each dispatch's
    (virtual start, model id, request ids, predicted seconds, measured
    seconds), the launches and the peak memory."""
    from repro_torch.core.runtime import Coordinator, set_overlap
    from repro_torch.diffusion.sampler import set_donate_buffers
    from repro_torch.launch.serve import parse_args, serve

    dispatches = []
    real = Coordinator._execute_real

    def recorded(self, batch):
        start = self.now
        measured = real(self, batch)
        dispatches.append((start, batch.model_id,
                           sorted(rn.request.rid for rn in batch.nodes),
                           batch.l_infer, measured))
        return measured

    prev = (set_donate_buffers(flags), set_overlap(flags))
    Coordinator._execute_real = recorded
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        t0 = time.perf_counter()
        system = serve(parse_args(argv), model_sets=model_sets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counters)
    finally:
        Coordinator._execute_real = real
        set_donate_buffers(prev[0])
        set_overlap(prev[1])
    return (system, wall, dispatches, launches,
            torch.cuda.max_memory_allocated() / 2**30)


def trace_missing(dispatch_log, setting) -> list:
    """The segments a replay of ``setting`` must dispatch and no dispatch
    ran: each family's backbone, and a Flux family's +C.N.2 (the request
    f32 cannot serve on one card; phase 4t serves it alone).  A segment id
    is run by a dispatch of it or of it fused with more ControlNets."""
    from repro_torch.diffusion.workflows import TABLE2_FAMILIES

    must = [f"segment:backbone:{f}" for f in TABLE2_FAMILIES[setting]] + [
        f"segment:backbone:{f}+controlnet1:{f}+controlnet2:{f}"
        for f in TABLE2_FAMILIES[setting] if f.startswith("flux")]
    ran = {d.model_id for d in dispatch_log}
    return [m for m in must
            if not any(r == m or r.startswith(m + "+") for r in ran)]


def trace_phase(torch, model_sets, card, counters, device="cuda",
                setting="s1", flag_runs=(False, True)):
    """Phase 7l (and 7t): the first 8 requests of a ``generate_trace`` of
    Table 2's ``setting`` (S1 by default) through the serving launcher on
    ``model_sets`` (a family name to its ``ModelSet``, weights drawn once),
    once for each of ``flag_runs`` (``REPRO_DONATE`` and ``REPRO_OVERLAP``
    both off, then both on), in the active quant mode; the checks and the
    printed metrics of the docstring's 7l.  A run whose admission rejected
    every request of a segment ``trace_missing`` asks for is replayed with
    ``--no-admission``, and says so.  Returns the shapes the runs gave
    flash attention and, under int8, ``quant_matmul``, and each run's
    summary."""
    from repro_torch.core.profiles import GPU_H800
    from repro_torch.nn.layers import quant_mode
    from repro_torch.sim import check_invariants, quantile

    families = [ms.family for ms in model_sets.values()]
    int8 = quant_mode() == "int8"
    argv = SERVE_ARGS + ["--setting", setting, "--device", device]
    runs, shapes, summaries = {}, {"flash": set(), "quant": set()}, []
    for flags in flag_runs:
        system, wall, disp, launches, peak = replay_trace(
            torch, model_sets, flags, argv, counters)
        c, admission = system.coordinator, "on"
        missing = trace_missing(c.dispatch_log, setting)
        if missing and c.rejected:
            log(f"[trace] {setting}: admission rejected every request of "
                f"{missing} ({len(c.rejected)} rejected): replayed with "
                f"--no-admission")
            del system, c
            free(torch)
            system, wall, disp, launches, peak = replay_trace(
                torch, model_sets, flags, argv + ["--no-admission"], counters)
            c, admission = system.coordinator, "off (--no-admission)"
            missing = trace_missing(c.dispatch_log, setting)
        label = (f"{setting}{' int8' if int8 else ''} donate={flags} "
                 f"overlap={flags}")
        if missing:
            ran = sorted({d.model_id for d in c.dispatch_log})
            raise AssertionError(f"trace {label}: no dispatch ran {missing}; "
                                 f"dispatched {ran}")
        if len(c.finished) + len(c.rejected) != 8:
            raise AssertionError(f"trace {label}: {len(c.finished)} done and "
                                 f"{len(c.rejected)} rejected of 8 requests")
        seg_flags = [comps["donate"] for mid, comps
                     in c.backend._components.items()
                     if mid.startswith("segment:")]
        if c.overlap is not flags or not seg_flags or any(
                f is not flags for f in seg_flags):
            raise AssertionError(f"trace {label}: the flags did not reach the "
                                 f"coordinator ({c.overlap}) and the "
                                 f"segments ({seg_flags})")
        want_flash, run_shapes = expected_flash(c.dispatch_log, *families)
        want = {"flash_attention": want_flash}
        shapes["flash"] |= run_shapes
        if int8:
            want["quant_matmul"], q_shapes = quant_path(c.dispatch_log,
                                                        *families)
            want["quantize_rows"] = want["quant_matmul"]
            shapes["quant"] |= q_shapes
        if {k: n for k, n in launches.items() if n} != want:
            raise AssertionError(f"trace {label}: launches {launches}, "
                                 f"expected {want}")
        errs_t = check_invariants(c)
        if errs_t:
            raise AssertionError(f"trace {label}: invariants {errs_t}")
        if not c.finished:
            raise AssertionError(f"trace {label}: no request finished")
        images = {}
        for req in c.finished:
            img = image_of(system, req)
            check_image(torch, img, card, f"trace {req.workflow_name} "
                                          f"request {req.rid}")
            images[req.rid] = img
        lats = sorted(r.latency for r in c.finished)
        by_model = {}
        for _, mid, rids, pred, meas in disp:
            by_model.setdefault(mid, []).append((pred, meas))
        summary = {
            "flags": label, "admission": admission, "wall_s": wall,
            "makespan_s": c.now,
            "done": len(c.finished), "rejected": len(c.rejected),
            "slo_attainment": system.slo_attainment(),
            "mean_latency_s": system.mean_latency(),
            "p50_latency_s": quantile(lats, 0.5),
            "p99_latency_s": c.p99_latency(),
            "dispatches": len(c.dispatch_log),
            "n_overlap_dispatches": c.n_overlap_dispatches,
            "overlap_hidden_seconds": c.overlap_hidden_seconds,
            "peak_memory_gib": peak,
            "predicted_peak_gib": TRACE_PEAK_GIB.get(setting),
            "launches": launches,
            "per_model": {mid: {
                "dispatches": len(v),
                "predicted_s_mean": statistics.mean(p for p, _ in v),
                "measured_s_mean": statistics.mean(m for _, m in v),
                "measured_over_predicted": (sum(m for _, m in v)
                                            / sum(p for p, _ in v))}
                for mid, v in by_model.items()},
            "requests": [{"rid": r.rid, "workflow": r.workflow_name,
                          "arrival": r.arrival, "status": r.status,
                          "latency": r.latency}
                         for r in sorted(c.finished + c.rejected,
                                         key=lambda r: r.rid)],
            "timeline": [(round(s, 4), mid, rids, round(m, 4))
                         for s, mid, rids, _, m in disp],
        }
        summaries.append(summary)
        predicted = summary["predicted_peak_gib"]
        log(f"[trace] {json.dumps(summary)}  [{card}]")
        log(f"[trace] {label}: wall {wall:.3f} s, coordinator makespan "
            f"{c.now:.3f} s, {len(c.finished)} done, {len(c.rejected)} "
            f"rejected (admission {admission}), SLO attainment "
            f"{summary['slo_attainment']:.3f}, "
            f"latency mean {summary['mean_latency_s']:.3f} s p50 "
            f"{summary['p50_latency_s']:.3f} s p99 {c.p99_latency():.3f} s, "
            f"{len(c.dispatch_log)} dispatches, overlap dispatches "
            f"{c.n_overlap_dispatches} hiding {c.overlap_hidden_seconds:.4f} "
            f"s, peak memory {peak:.2f} GiB (predicted "
            + (f"{predicted:.2f}" if predicted else "not") + f"), launches "
            f"{want} (exact)  [{card}]")
        for mid, row in summary["per_model"].items():
            log(f"[trace] {label}: {mid}: {row['dispatches']} dispatches, "
                f"predicted ({GPU_H800.name} profile) "
                f"{row['predicted_s_mean']:.4f} s, measured "
                f"{row['measured_s_mean']:.4f} s a dispatch (its first "
                f"dispatch includes the load)  [{card}]")
        if flags and c.n_overlap_dispatches == 0:
            log("[trace] no decode rode a segment window: on one executor "
                "each request's decode comes ahead of every later request's "
                "segment in the scheduler's order (earlier arrival), so no "
                "decode became ready while a segment held the executor")
        runs[flags] = (c, images, [(mid, rids) for _, mid, rids, _, _ in disp])
        del system, c, images
        free(torch)
    if set(runs) != {False, True}:
        return shapes, summaries
    (c_off, img_off, batches_off), (c_on, img_on, batches_on) = (
        runs[False], runs[True])
    # the batches follow the measured timeline, and a GEMM's bits may
    # depend on its row count: say whether both runs batched alike
    same_batches = batches_off == batches_on
    done_off = sorted((r.rid, r.workflow_name) for r in c_off.finished)
    done_on = sorted((r.rid, r.workflow_name) for r in c_on.finished)
    if done_off != done_on:
        raise AssertionError(f"trace: the runs finished different requests: "
                             f"{done_off} vs {done_on} (same batches: "
                             f"{same_batches})")
    for rid, img in img_off.items():
        if not torch.equal(img, img_on[rid]):
            raise AssertionError(f"trace request {rid}: flags off vs on not "
                                 f"bit-identical, rel err "
                                 f"{rel(img_on[rid], img)} (same batches: "
                                 f"{same_batches})")
    log(f"[trace] flags off vs on: the same {len(done_off)} requests "
        f"finished, every image bit-identical; the same batches in both "
        f"runs: {same_batches}")
    return shapes, summaries


def batch_plan(dispatch_log, reqs) -> list:
    """The batches a run formed for ``reqs``: each dispatch's model id and
    the positions in ``reqs`` of the requests it carried.  Two runs with
    equal plans computed every row in a batch of the same requests."""
    pos = {r.rid: i for i, r in enumerate(reqs)}
    return sorted({(d.model_id, tuple(sorted(pos[rn.request.rid]
                                             for rn in d.nodes)))
                   for d in dispatch_log
                   if all(rn.request.rid in pos for rn in d.nodes)})


def compute_apps() -> dict:
    """pid -> MiB of device memory, for every process nvidia-smi lists on
    the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    apps = {}
    for line in out.stdout.strip().splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps[int(parts[0])] = float(parts[1])
    return apps


def device_used_mib(torch) -> float:
    """MiB in use on the card by every process (``cudaMemGetInfo``)."""
    free, total = torch.cuda.mem_get_info()
    return (total - free) / 2**20


def check_proc_image(torch, img, family, what):
    """A served image off the wire: a CPU tensor of the family's pixel
    size, finite, in [-1, 1]."""
    side = 8 * family.toy.latent_size
    if (tuple(img.shape) != (1, side, side, 3) or img.device.type != "cpu"
            or not bool(torch.isfinite(img).all())
            or float(img.abs().max()) > 1.0):
        raise AssertionError(f"proc image of {what} {tuple(img.shape)} "
                             f"{img.device} out of spec")


def hold_images(torch, got, want, same_plan, what):
    """Each image bit-identical to ``want``'s when the runs batched alike,
    else within ``KERNEL_VS_PLAIN_REL``; returns the largest relative
    error."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        e = rel(g, w)
        worst = max(worst, e)
        if same_plan and not torch.equal(g, w):
            raise AssertionError(f"{what} request {i}: the same batches but "
                                 f"not bit-identical, rel err {e}")
        if not e < KERNEL_VS_PLAIN_REL:
            raise AssertionError(f"{what} request {i}: rel err {e}")
    log(f"[proc] {what}: the same batches: {same_plan}; "
        f"{'bit-identical' if same_plan else 'within 1e-3'}, largest rel err "
        f"{worst:.3e}")
    return worst


def proc_report(label, system, wall, makespan, apps, workers_mib,
                card) -> None:
    """Phase 7p's printed metrics of one proc run: walls, the RPC split as
    shares of the measured dispatch seconds, bytes, staging, spawns, the
    device memory the workers held together (``workers_mib``) and
    nvidia-smi's process list (``apps``, read while the workers lived)."""
    c = system.coordinator
    be = c.backend
    measured = be.exec_seconds
    share = (lambda x: x / measured) if measured else (lambda x: 0.0)
    workers = {eid: {"pid": h.pid, "spawn_s": h.spawn_seconds}
               for eid, h in sorted(be.workers.items())}
    out = {"run": label, "wall_s": wall, "makespan_s": makespan,
           "workers_device_mib": workers_mib, "nvidia_smi_apps_mib": apps,
           "dispatch_s": measured, "execs": be.n_execs,
           "ser_s": be.ser_seconds, "transport_s": be.transport_seconds,
           "worker_s": be.worker_seconds,
           "ser_share": share(be.ser_seconds),
           "transport_share": share(be.transport_seconds),
           "worker_share": share(be.worker_seconds),
           "bytes_tx": be.bytes_tx, "bytes_rx": be.bytes_rx,
           "bytes_shipped": be.bytes_shipped,
           "datastore_ser_s": c.engine.ser_seconds,
           "staging_ships": be.staging_ships, "staging_hits": be.staging_hits,
           "adapter_ships": be.adapter_ships, "adapter_hits": be.adapter_hits,
           "n_exec_replies": be.n_exec_replies,
           "n_exec_applied": be.n_exec_applied, "n_fenced": be.n_fenced,
           "spawns": be.supervisor.n_spawns,
           "restart_s": be.restart_seconds, "workers": workers,
           "parent_pid": os.getpid(),
           "rpcs": [(mid, eid, round(w, 4), round(ld, 4), round(ex, 4))
                    for mid, eid, w, ld, ex in be.rpc_log]}
    log(f"[proc] {json.dumps(out)}  [{card}]")
    log(f"[proc] {label}: wall {wall:.3f} s, coordinator makespan "
        f"{makespan:.3f} s; since the system was built: {be.n_execs} RPCs "
        f"over {measured:.3f} s measured: "
        f"worker {share(be.worker_seconds):.2%}, transport "
        f"{share(be.transport_seconds):.2%}, parent serialization "
        f"{share(be.ser_seconds):.2%}; {be.bytes_tx / 2**20:.2f} MiB out, "
        f"{be.bytes_rx / 2**20:.2f} MiB back; staging {be.staging_ships} "
        f"ships {be.staging_hits} hits; spawns "
        f"{ {eid: [round(x, 2) for x in w['spawn_s']] for eid, w in workers.items()} } s; "
        f"the workers held {workers_mib:.0f} MiB of the card together  "
        f"[{card}]")


def cold_warm(rpc_log) -> dict:
    """model id -> (the RPC walls of each worker's first RPC of it, the
    mean wall of its later ones on the same workers), from a proc
    backend's ``rpc_log``."""
    seen, cold, warm = set(), {}, {}
    for mid, eid, wall, _, _ in rpc_log:
        if (mid, eid) in seen:
            warm.setdefault(mid, []).append(wall)
        else:
            seen.add((mid, eid))
            cold.setdefault(mid, []).append(round(wall, 4))
    return {mid: (cold[mid], round(statistics.mean(warm[mid]), 4)
                  if mid in warm else None) for mid in cold}


def check_workers_on_card(system, apps) -> None:
    """Every worker's pid among the card's compute processes, where
    nvidia-smi's list can be matched to this process's pids at all."""
    pids = {eid: h.pid for eid, h in system.coordinator.backend.workers.items()
            if h.proc is not None and h.proc.is_alive()}
    if os.getpid() in apps or any(p in apps for p in pids.values()):
        missing = {eid: p for eid, p in pids.items() if p not in apps}
        if missing:
            raise AssertionError(f"workers {missing} hold no context on the "
                                 f"card: nvidia-smi lists {sorted(apps)}")
        log(f"[proc] worker pids {sorted(pids.values())} among the card's "
            f"compute processes {sorted(apps)}")
    else:
        log(f"[proc] nvidia-smi's process list (pid: MiB) {apps} holds "
            f"neither the parent ({os.getpid()}) nor a worker "
            f"({sorted(pids.values())}): the pids cannot be matched here")


def proc_phase(torch, family, card, counters, kept, device="cuda"):
    """Phase 7p: the process plane at the family's width; the checks and
    printed metrics of the docstring's 7p.  ``kept`` holds phase 4q's int8
    and phase 4b's mixed-batch images (on the CPU) and batch plans."""
    from repro_torch.core import (
        FaultPlane,
        LocalBackend,
        ProcBackend,
        Scheduler,
        ServingSystem,
    )
    from repro_torch.diffusion import ModelSet, make_basic_workflow
    from repro_torch.nn.layers import quant_mode, set_quant_mode
    from repro_torch.sim import check_invariants

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def basic_system(backend, n_executors, chunk, faults=None):
        system = ServingSystem(n_executors=n_executors, backend=backend,
                               faults=faults)
        if chunk:
            system.coordinator.scheduler = Scheduler(
                system.profiles, use_declared_max_batch=True,
                segment_chunk=chunk)
        system.register(make_basic_workflow("sd3", ModelSet(family)))
        return system

    def memory():
        """(card MiB in use by every process, the parent's reserved MiB)."""
        if device != "cuda":
            return 0.0, 0.0
        return device_used_mib(torch), torch.cuda.memory_reserved() / 2**20

    def run(system, subs, label):
        """Serve ``subs`` with the parent's counts set to 0 just before:
        on the proc plane the parent launches no kernel.  Returns the
        requests, their images, the wall and the card's process list, and
        notes the MiB the workers hold: the card's use less ``base``'s,
        less the parent's own growth."""
        for c in counters:
            c.launches = 0
        v0 = system.coordinator.now
        sync()
        t0 = time.perf_counter()
        reqs = serve(system, subs, STEPS)
        sync()
        wall = time.perf_counter() - t0
        makespans[label] = system.coordinator.now - v0
        apps = compute_apps() if device == "cuda" else {}
        used, reserved = memory()
        workers_mib[label] = (used - base[0]) - (reserved - base[1])
        parent = {c.__name__: c.launches for c in counters if c.launches}
        if parent:
            raise AssertionError(f"{label}: the parent launched {parent}")
        images = [image_of(system, r).cpu() for r in reqs]
        for (name, _), img in zip(subs, images):
            check_proc_image(torch, img, family, f"{label} {name}")
        errs = check_invariants(system.coordinator)
        if errs:
            raise AssertionError(f"{label}: invariants {errs}")
        return reqs, images, wall, apps

    def check_rpcs(be, label):
        if be.n_exec_replies != be.n_exec_applied + be.n_fenced:
            raise AssertionError(f"{label}: {be.n_exec_replies} replies, "
                                 f"{be.n_exec_applied} applied, "
                                 f"{be.n_fenced} fenced")

    subs = [("sd3:basic", inp) for inp in REQUESTS]
    makespans, workers_mib = {}, {}

    # (a) basic: in-process, then proc, on the same executors and chunks
    local = basic_system(LocalBackend(device=device), PROC_EXECUTORS,
                         PROC_CHUNK)
    sync()
    t0 = time.perf_counter()
    local_reqs = serve(local, subs, STEPS)
    sync()
    local_wall = time.perf_counter() - t0
    local_imgs = [image_of(local, r).cpu() for r in local_reqs]
    local_plan = batch_plan(local.coordinator.dispatch_log, local_reqs)
    log(f"[proc] (a) in-process: {PROC_EXECUTORS} executors of one "
        f"LocalBackend, segment chunk {PROC_CHUNK}: wall {local_wall:.3f} s "
        f"(weights drawn included), makespan {local.coordinator.now:.3f} s; "
        f"batches {local_plan}  [{card}]")
    del local, local_reqs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    base = memory()
    system = basic_system(ProcBackend(device=device), PROC_EXECUTORS,
                          PROC_CHUNK)
    with system:
        reqs, a_imgs, wall, apps = run(system, subs, "(a) proc")
        be = system.coordinator.backend
        check_rpcs(be, "(a)")
        if be.n_fenced or not be.staging_hits or be._components:
            raise AssertionError(f"(a): fenced {be.n_fenced}, staging hits "
                                 f"{be.staging_hits}, parent components "
                                 f"{list(be._components)}")
        a_plan = batch_plan(system.coordinator.dispatch_log, reqs)
        a_rpcs = list(be.rpc_log)
        log(f"[proc] (a) proc batches {a_plan}")
        hold_images(torch, a_imgs, local_imgs, a_plan == local_plan,
                    "(a) proc vs in-process")
        proc_report("(a) basic", system, wall, makespans["(a) proc"],
                    apps, workers_mib["(a) proc"], card)
        check_workers_on_card(system, apps)

    # (b) the first request alone, with a SIGKILL right after its second
    # segment RPC's frame is sent: a lone request's RPCs are the text
    # encoder, then the segment chunks, then the VAE
    kill_at = 2
    faults = FaultPlane(seed=0, kill_every_execs=kill_at, max_kills=1)
    base = memory()
    system = basic_system(ProcBackend(device=device), PROC_EXECUTORS,
                          PROC_CHUNK, faults=faults)
    with system:
        reqs, b_imgs, wall, apps = run(system, subs[:1], "(b) kill")
        c = system.coordinator
        be = c.backend
        check_rpcs(be, "(b)")
        killed, victim = be.exec_log[kill_at]
        if (faults.n_kills != 1 or c.n_worker_deaths < 1
                or be.supervisor.n_spawns < 3 or not be.restart_seconds > 0
                or not killed.startswith("segment:")):
            raise AssertionError(
                f"(b): kills {faults.n_kills} (RPC {kill_at}: {killed}), "
                f"deaths {c.n_worker_deaths}, spawns "
                f"{be.supervisor.n_spawns}, restart {be.restart_seconds} s")
        b_plan = batch_plan(c.dispatch_log, reqs)
        alone_in_a = [(m, rs) for m, rs in a_plan if 0 in rs]
        log(f"[proc] (b) batches {b_plan}; the request's in (a) {alone_in_a}")
        hold_images(torch, b_imgs, a_imgs[:1], b_plan == alone_in_a,
                    "(b) killed mid-segment vs (a) proc")
        proc_report("(b) kill", system, wall, makespans["(b) kill"],
                    apps, workers_mib["(b) kill"], card)
        # every RPC before the killed one was applied, so the log's entries
        # from ``kill_at`` on came after the respawn
        after = [(mid, round(w, 4)) for mid, eid, w, _, _
                 in be.rpc_log[kill_at:] if eid == victim]
        log(f"[proc] (b) worker {victim} killed at RPC {kill_at}; respawn "
            f"wall {be.restart_seconds:.3f} s (process start, torch import, "
            f"CUDA context; no nvcc); the respawned worker then served "
            f"{after}; a cold worker's first RPC of a model against its "
            f"warm ones (weights drawn on the card, libraries loaded, "
            f"modules imported), RPC wall s: {cold_warm(a_rpcs)}  [{card}]")

    # (c) two LoRA tenants and a basic request through one worker, twice
    base = memory()
    system, _ = lora_system(ModelSet(family), device,
                            backend=ProcBackend(device=device))
    with system:
        be = system.coordinator.backend
        reqs, c_imgs, wall, apps = run(system, MIXED, "(c) lora wave 1")
        if (be.adapter_ships, be.adapter_hits) != (2, 0):
            raise AssertionError(f"(c) wave 1: adapters shipped "
                                 f"{be.adapter_ships}, hit {be.adapter_hits}")
        c_plan = batch_plan(system.coordinator.dispatch_log, reqs)
        if not any(d.multilora for d in system.coordinator.dispatch_log):
            raise AssertionError("(c): no multilora dispatch")
        log(f"[proc] (c) batches {c_plan} (phase 4b: {kept['lora'][1]})")
        if c_plan != kept["lora"][1]:
            raise AssertionError("(c): other batches than phase 4b's")
        hold_images(torch, c_imgs, kept["lora"][0], True,
                    "(c) mixed batch on one worker vs phase 4b in-process")
        proc_report("(c) lora wave 1", system, wall,
                    makespans["(c) lora wave 1"], apps,
                    workers_mib["(c) lora wave 1"], card)
        reqs2, c2_imgs, wall2, apps2 = run(system, MIXED, "(c) lora wave 2")
        if be.adapter_ships != 2 or be.adapter_hits < 2:
            raise AssertionError(f"(c) wave 2: adapters shipped "
                                 f"{be.adapter_ships}, hit {be.adapter_hits}")
        hold_images(torch, c2_imgs, c_imgs,
                    batch_plan(system.coordinator.dispatch_log, reqs2)
                    == c_plan, "(c) wave 2 vs wave 1")
        check_rpcs(be, "(c)")
        log(f"[proc] (c) the worker's first RPC of each model (wave 1) "
            f"against its wave-2 RPCs, wall s: {cold_warm(be.rpc_log)}  "
            f"[{card}]")
        proc_report("(c) lora wave 2", system, wall2,
                    makespans["(c) lora wave 2"], apps2,
                    workers_mib["(c) lora wave 2"], card)
        check_workers_on_card(system, apps2)

    # (d) int8: the workers inherit REPRO_QUANT at spawn; the parent prices
    # the int8 forwards as phase 4q did
    prev_env = os.environ.get("REPRO_QUANT")
    os.environ["REPRO_QUANT"] = "int8"
    prev_mode = set_quant_mode("int8")
    try:
        base = memory()
        system = basic_system(ProcBackend(device=device), 1, None)
        with system:
            reqs, d_imgs, wall, apps = run(system, subs, "(d) int8")
            check_rpcs(system.coordinator.backend, "(d)")
            d_plan = batch_plan(system.coordinator.dispatch_log, reqs)
            log(f"[proc] (d) batches {d_plan} (phase 4q: {kept['int8'][1]})")
            if d_plan != kept["int8"][1]:
                raise AssertionError("(d): other batches than phase 4q's")
            hold_images(torch, d_imgs, kept["int8"][0], True,
                        "(d) int8 on one worker vs phase 4q in-process")
            proc_report("(d) int8", system, wall, makespans["(d) int8"],
                        apps, workers_mib["(d) int8"], card)
    finally:
        set_quant_mode(prev_mode)
        if prev_env is None:
            os.environ.pop("REPRO_QUANT", None)
        else:
            os.environ["REPRO_QUANT"] = prev_env
    if quant_mode() != prev_mode:
        raise AssertionError("the quant mode was not restored")


# ------------------------------------------------------------ sharded plane

def sharded_flash(dispatch_log, cfg) -> Counter:
    """Flash-attention launches by shape (BH, Sq, Sk, D) that a run's
    dispatches must have made on the sharded plane.  A segment at
    parallelism k over its 2n CFG rows, per step: where k divides the rows,
    each slot runs the backbone's layers on 2n/k rows and each
    ControlNet's on its 2n/k duplicated rows; else each slot runs the
    backbone's layers on its image-token slice against every key (Sq = Tc
    + Ti/k) and each ControlNet runs once, on the home slot, on the n
    latent rows.  At k = 1 the backbone takes the 2n rows and each
    ControlNet the n.  A text batch: two layers."""
    calls = Counter()
    h, hd, tok = cfg.n_heads, cfg.head_dim, cfg.tokens
    for d in dispatch_log:
        n, k = len(d.nodes), d.parallelism
        if d.model_id.startswith("segment:"):
            per_cn = d.segment_steps * n_controlnets(d.model_id) * cn_layers(cfg)
            if k == 1:
                calls[(2 * n * h, tok, tok, hd)] += d.segment_steps * cfg.n_layers
                if per_cn:
                    calls[(n * h, tok, tok, hd)] += per_cn
            elif (2 * n) % k == 0:
                calls[(2 * n // k * h, tok, tok, hd)] += k * (
                    d.segment_steps * cfg.n_layers + per_cn)
            else:
                calls[(2 * n * h, cfg.text_tokens + cfg.image_tokens // k,
                       tok, hd)] += k * d.segment_steps * cfg.n_layers
                if per_cn:
                    calls[(n * h, tok, tok, hd)] += per_cn
        elif d.model_id.startswith("text_encoder:"):
            calls[(4 * n, cfg.text_tokens, cfg.text_tokens,
                   cfg.text_dim // 4)] += 2
    return +calls


def sharded_phase(torch, family, cn_weights, card, counters, device="cuda"):
    """Phase 7s: one sd3:basic and one sd3:cn1 request at full width through
    ``ServingSystem`` -> ``Scheduler(fixed_parallelism=k)`` ->
    ``ShardedBackend.execute_batch(..., mesh=submesh)`` over ``SHARD_SLOTS``
    slots of the one card, at each k of ``SHARD_KS``, each image held
    against the same request on a single-device ``LocalBackend`` from the
    same weights; the checks and printed metrics of the docstring's 7s.
    Returns the shapes the sharded runs gave flash attention, its launches
    in them, and each run's summary."""
    from repro_torch.core import (
        LocalBackend,
        MeshManager,
        Scheduler,
        ServingSystem,
        ShardedBackend,
    )
    from repro_torch.diffusion import make_basic_workflow, make_controlnet_workflow
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.sim import check_invariants

    cfg = family.toy
    ms = s1_model_set(family, cn_weights, device)
    ref = ref_image(torch, REF_SEEDS[0], 8 * cfg.latent_size) \
        if device == "cuda" else None
    runs = {"sd3:basic": (make_basic_workflow("sd3", ms), REQUESTS[0]),
            "sd3:cn1": (make_controlnet_workflow("sd3", 1, ms),
                        {**REQUESTS[0], "ref_image": ref})}
    # every call's shape, read through the ops module's global, which mha
    # looks up at each call (the wrapper's own count is still the count)
    seen = Counter()
    real = fops.flash_attention

    def recorded(q, k, v, **kw):
        seen[(q.shape[0], q.shape[1], k.shape[1], q.shape[2])] += 1
        return real(q, k, v, **kw)

    def one_run(name, k):
        wf, inp = runs[name]
        if k == 1:
            backend = LocalBackend(device=device)
            system = ServingSystem(n_executors=1, backend=backend)
        else:
            mm = MeshManager(devices=[torch.device(device, 0) if device == "cuda"
                                      else torch.device(device)
                                      for _ in range(SHARD_SLOTS)])
            backend = ShardedBackend(mm)
            system = ServingSystem(n_executors=SHARD_SLOTS, backend=backend)
            system.coordinator.scheduler = Scheduler(
                system.profiles, fixed_parallelism=k,
                use_declared_max_batch=True, mesh=mm)
        system.register(wf)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        seen.clear()
        t0 = time.perf_counter()
        req = serve(system, [(wf.name, inp)], STEPS)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        c = system.coordinator
        want = sharded_flash(c.dispatch_log, cfg)
        others = sum(n for m, n in launches.items() if m != "flash_attention")
        if (launches["flash_attention"] != sum(want.values()) or others
                or dict(seen) != dict(want)):
            raise AssertionError(
                f"sharded {name} k={k}: launches {launches}, flash calls by "
                f"shape {dict(seen)}, reckoned {dict(want)}; dispatches "
                f"{[(d.model_id, len(d.nodes), d.parallelism) for d in c.dispatch_log]}")
        errs = check_invariants(c)
        if errs:
            raise AssertionError(f"sharded {name} k={k}: invariants {errs}")
        segs = [d for d in c.dispatch_log if d.model_id.startswith("segment:")]
        modes = []
        if k > 1:
            logged = [s for s in backend.shard_log
                      if s[0].startswith("segment:")]
            if (not segs or any(d.parallelism != k for d in segs)
                    or len(logged) != len(segs)
                    or any(s[2] != k or len(set(s[3])) != k for s in logged)):
                raise AssertionError(
                    f"sharded {name} k={k}: segment dispatches "
                    f"{[(d.model_id, d.parallelism) for d in segs]}, shard "
                    f"log {backend.shard_log}")
            modes = ["rows" if (2 * len(d.nodes)) % k == 0 else "sequence"
                     for d in segs]
        img = image_of(system, req)
        check_image(torch, img, card, f"sharded {name} k={k}")
        summary = {
            "workflow": name, "k": k, "slots": SHARD_SLOTS if k > 1 else 1,
            "wall_s": wall, "makespan_s": c.now,
            "latency_s": req.latency, "segment_modes": modes,
            "shard_log": [list(s[:3]) + [list(s[3])] for s in
                          getattr(backend, "shard_log", [])],
            "dispatches": [(d.model_id, len(d.nodes), d.parallelism,
                            d.segment_steps) for d in c.dispatch_log],
            "flash_attention": launches["flash_attention"],
            "flash_calls_by_shape": {str(s): n for s, n in sorted(seen.items())},
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
        if name == "sd3:basic" and k in (1, max(SHARD_KS)):
            # where the time goes: the request again on the warm system
            profile_path(torch, system, [(wf.name, inp)], card,
                         f"sharded {name} k={k}", SHARD_PROFILE)
        return img, summary, set(seen)

    fops.flash_attention = recorded
    try:
        out, shapes, flash = [], set(), 0
        for name in runs:
            single, base, _ = one_run(name, 1)
            log(f"[sharded] {json.dumps(base)}  [{card}]")
            for k in SHARD_KS:
                img, summary, run_shapes = one_run(name, k)
                err = rel(img, single)
                summary["rel_err_vs_single"] = err
                summary["max_abs_diff_vs_single"] = float(
                    (img - single).abs().max())
                log(f"[sharded] {json.dumps(summary)}  [{card}]")
                if not err < KERNEL_VS_PLAIN_REL:
                    raise AssertionError(f"sharded {name} k={k}: image vs the "
                                         f"single-device image rel err {err}")
                log(f"[sharded] {name} k={k} over {SHARD_SLOTS} slots of one "
                    f"card, segment mode {summary['segment_modes']}: wall "
                    f"{summary['wall_s']:.3f} s, makespan "
                    f"{summary['makespan_s']:.3f} s (single device "
                    f"{base['wall_s']:.3f} / {base['makespan_s']:.3f} s), "
                    f"peak memory {summary['peak_memory_gib']:.2f} GiB, "
                    f"flash_attention launches {summary['flash_attention']} "
                    f"as reckoned; image vs the single-device image rel err "
                    f"{err:.3e} < {KERNEL_VS_PLAIN_REL}, max|diff| "
                    f"{summary['max_abs_diff_vs_single']:.3e}  [{card}]")
                shapes |= run_shapes
                flash += summary["flash_attention"]
                out.append(summary)
            del single
    finally:
        fops.flash_attention = real
    del ms
    gc.collect()
    torch.cuda.empty_cache()
    return shapes, flash, out


# ------------------------------------------------------------ LLM families

# phase 8: decode against forward, and the kernels' route against the plain
# one, relative (max |difference| over max |reference|)
LLM_REL = 1e-3
# phase 8's sizes: (batch, tokens) of each run and the cache depths
LLM_SIZES = {
    "hybrid_prefill": (1, 8192), "hybrid_decode": (2, 64),
    "hybrid_timed": (8, 8192),
    "whisper_prefill": (4, 448), "whisper_decode": 4,
    "llama_prefill": (1, 4096), "llama_decode": (1, 32),
    "llama_cache": 16384, "llama_timed_cache": 32768,
    "llama_shard_slots": 4, "llama_shard_steps": 32,
    "other_prefill": (2, 1024), "other_decode": (2, 16),
}
# 8z: the other configs at full width, depth cut to 2 layers but these
OTHER_LAYERS = {"xlstm-1.3b": 8, "grok-1-314b": 1}
OTHER_ARCHS = ("qwen3-1.7b", "h2o-danube-3-4b", "yi-34b",
               "granite-moe-1b-a400m", "grok-1-314b", "internvl2-2b",
               "xlstm-1.3b")
# what phase 8h's profile sums by kind (the attention separately, through a
# profiler range around each gqa_attention call)
HYBRID_PROFILE = {"rglru_scan": ("rglru_scan",), "gemms": GEMM_KERNELS}


def rel_inf(a, b, vocab) -> float:
    """max |a - b| / max |b| over the first ``vocab`` columns of two logit
    tensors (the padded ones hold -1e9, which would swamp the ratio), in
    float64 on the CPU."""
    a, b = a[..., :vocab].double().cpu(), b[..., :vocab].double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def zero_counts(counters) -> None:
    for c in counters:
        c.launches = 0


def read_counts(counters) -> dict:
    return {c.__name__: c.launches for c in counters}


def launched_since(counters, before) -> dict:
    """The launches of each kernel since ``before`` (``read_counts``), for
    the kernels that launched."""
    return {k: n - before[k] for k, n in read_counts(counters).items()
            if n != before[k]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def llm_draw(torch, cfg, seed, device):
    """The family's parameters, f32, drawn on ``device`` from ``seed``."""
    from repro_torch.models import get_family

    gen = torch.Generator(device).manual_seed(seed)
    return get_family(cfg).init(gen, cfg, dtype=torch.float32, device=device)


def llm_tokens(torch, cfg, shape, seed, device):
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randint(0, cfg.vocab, shape, generator=gen, device=device)


def rglru_blocks(cfg) -> int:
    """The RG-LRU blocks of a hybrid forward: one scan launch each."""
    n_super, rem = divmod(cfg.n_layers, 3)
    return 2 * n_super + rem


def decode_vs_forward(torch, cfg, params, tokens, cache_len, device,
                      ring=False) -> float:
    """Serve ``tokens`` one at a time from a fresh f32 cache ``cache_len``
    deep and hold each step's logits against the forward's at that
    position; returns the largest relative difference (raises past
    ``LLM_REL``)."""
    from repro_torch.models import get_family, make_serve_step

    fam = get_family(cfg)
    full = fam.forward(params, cfg, tokens)
    kw = {"ring": True} if ring else {}
    cache = fam.init_decode_cache(cfg, tokens.shape[0], cache_len,
                                  dtype=torch.float32, device=device, **kw)
    step = make_serve_step(cfg, ring=ring)
    worst = 0.0
    for t in range(tokens.shape[1]):
        logits, cache = step(params, cache, tokens[:, t])
        worst = max(worst, rel_inf(logits, full[:, t], cfg.vocab))
    if not worst <= LLM_REL:
        raise AssertionError(f"{cfg.name}: decode vs forward rel err {worst} "
                             f"(ring={ring})")
    return worst


def profile_prefill(torch, fn, card, label, kernels, device="cuda") -> dict:
    """One ``fn()`` under the profiler: busy and idle, the named kernels'
    device time and shares (as :func:`profile_path`), and the attention's
    device time: the device span of a ``record_function`` range around
    every ``gqa_attention`` call of the model stacks (the profiler lists
    it as a CUDA row of the range's name, which busy time leaves out)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import transformer as tfm

    real = tfm.gqa_attention

    def ranged(*a, **kw):
        with record_function("llm_attention"):
            return real(*a, **kw)

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    tfm.gqa_attention = ranged
    try:
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        tfm.gqa_attention = real
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    attn = sum(r[0] for r in rows if r[2] == "llm_attention")
    rows = sorted((r for r in rows if r[2] != "llm_attention"), reverse=True)
    busy = sum(r[0] for r in rows)
    nm = "not measured"
    out = {"window": label, "wall_ms": wall_ms,
           "device_busy_ms": busy if rows else nm,
           "idle_share": 1 - busy / wall_ms if rows else nm}
    for name, keys in kernels.items():
        ms = sum(r[0] for r in rows if any(k in r[2] for k in keys))
        out[f"{name}_ms"] = ms if rows else nm
        out[f"{name}_share_of_busy"] = ms / busy if rows else nm
    out["attention_ms"] = attn if attn > 0 else nm
    out["attention_share_of_busy"] = attn / busy if attn > 0 else nm
    out["top_kernels"] = [{"ms": ms, "count": n, "name": name[:90]}
                          for ms, n, name in rows[:8]]
    log(f"[profile] {json.dumps(out)}  [{card}]")
    return out


def free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def sharded_decode_phase(torch, cfg, params, card, counters, device, sz
                         ) -> dict:
    """Phase 8s: llama3-8b's decode with its cache's sequence axis split
    over ``llama_shard_slots`` slots of the one card (a ``Submesh`` of
    distinct ``torch.device`` objects, ``decode_shards`` installed: the
    flash-decode over a sequence-sharded cache) against the unsharded
    route, step by step, with the same parameters, cache and tokens.

    Two runs of ``llama_shard_steps`` steps: from an empty cache (every
    slot a step reads lies in the first slot's part, the other parts add
    exact zeros: on the card the logits and the whole cache must be the
    same bits; a CPU rehearsal's reductions group the zeros otherwise),
    and across the boundary of the first two parts from a cache filled
    with seeded normal K/V (the merges meet real partials: the logits
    within ``LLM_REL``, layer 0's K/V the same bits, the deeper layers'
    written K/V within ``LLM_REL``, every other slot untouched)."""
    from repro_torch.core.mesh import Submesh
    from repro_torch.models import act_sharding, get_family, make_serve_step
    from repro_torch.models.transformer import (gather_decode_cache,
                                                shard_decode_cache)

    k, steps, depth = (sz["llama_shard_slots"], sz["llama_shard_steps"],
                       sz["llama_cache"])
    index = 0 if device == "cuda" else None
    mesh = Submesh([torch.device(device, index) for _ in range(k)], range(k))
    fam = get_family(cfg)
    step = make_serve_step(cfg)

    def sharded_step(cache, tok):
        with act_sharding.activation_sharding(None, decode_shards=mesh):
            return step(params, cache, tok)

    def run(start, seed):
        plain = fam.init_decode_cache(cfg, 1, depth, dtype=torch.float32,
                                      device=device)
        if start:
            gen = torch.Generator(device).manual_seed(seed)
            for name in ("k", "v"):
                plain[name].normal_(generator=gen)
            plain["pos"] = start
        sharded = shard_decode_cache(plain, mesh)
        before = {n: plain[n].clone() for n in ("k", "v")}
        tokens = llm_tokens(torch, cfg, (1, steps), seed, device)
        worst, exact, launched = 0.0, True, {}
        for t in range(steps):
            want, plain = step(params, plain, tokens[:, t])
            zero_counts(counters)
            got, sharded = sharded_step(sharded, tokens[:, t])
            torch.cuda.synchronize()
            for name, n in read_counts(counters).items():
                launched[name] = launched.get(name, 0) + n
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"8s step {t}: logits not finite")
            worst = max(worst, rel_inf(got, want, cfg.vocab))
            exact &= bool(torch.equal(got, want))
        if any(launched.values()):
            raise AssertionError(f"8s: kernels launched on the sharded "
                                 f"decode {launched}, reckoned none")
        if not worst <= LLM_REL:
            raise AssertionError(f"8s from {start}: sharded vs unsharded "
                                 f"logits rel err {worst} > {LLM_REL}")
        joined = gather_decode_cache(sharded, mesh)
        written = slice(start, start + steps)
        cache_rel, layer0, untouched = 0.0, True, True
        for name in ("k", "v"):
            got, want = joined[name], plain[name]
            layer0 &= bool(torch.equal(got[0], want[0]))
            w = want[:, :, written].double()
            cache_rel = max(cache_rel, float(
                (got[:, :, written].double() - w).abs().max()
                / w.abs().max()))
            keep = torch.ones(depth, dtype=torch.bool, device=got.device)
            keep[written] = False
            untouched &= bool(torch.equal(got[:, :, keep],
                                          before[name][:, :, keep]))
        same = all(torch.equal(joined[n], plain[n]) for n in ("k", "v"))
        del joined, before
        out = {"start": start, "logits_rel": worst, "logits_exact": exact,
               "cache_written_rel": cache_rel,
               "cache_layer0_bit_identical": layer0,
               "cache_untouched": untouched, "cache_bit_identical": same,
               "launches": launched}
        if not (layer0 and untouched and cache_rel <= LLM_REL):
            raise AssertionError(f"8s from {start}: cache {out}")
        if device == "cuda" and not start and not (same and exact):
            raise AssertionError(f"8s from an empty cache: not the same "
                                 f"bits {out}")
        return out, plain, sharded

    torch.cuda.reset_peak_memory_stats()
    empty, _, _ = run(0, 4)
    cross, plain, sharded = run(depth // k - steps // 2, 5)
    tok1 = llm_tokens(torch, cfg, (1,), 3, device)
    holder = {"plain": plain, "sharded": sharded}

    def time_plain():
        out, holder["plain"] = step(params, holder["plain"], tok1)
        return out

    def time_sharded():
        out, holder["sharded"] = sharded_step(holder["sharded"], tok1)
        return out

    plain_ms = cuda_ms(torch, time_plain, 20)
    sharded_ms = cuda_ms(torch, time_sharded, 20)
    peak = torch.cuda.max_memory_allocated() / 2**30
    result = {"slots": k, "steps": steps, "cache_depth": depth,
              "from_empty": empty, "across_slots": cross,
              "plain_step_ms": plain_ms, "sharded_step_ms": sharded_ms,
              "peak_gib": peak}
    for r in (empty, cross):
        log(f"[llm-8s] {cfg.name}: {steps} decode steps from position "
            f"{r['start']}, a {depth}-slot cache split over {k} slots of "
            f"the card: logits worst rel err {r['logits_rel']:.3e} <= "
            f"{LLM_REL} against the unsharded route (same bits "
            f"{r['logits_exact']}); cache layer 0 bit-identical "
            f"{r['cache_layer0_bit_identical']}, written slots rel err "
            f"{r['cache_written_rel']:.3e}, other slots untouched "
            f"{r['cache_untouched']}, whole cache bit-identical "
            f"{r['cache_bit_identical']}; kernel launches {r['launches']}  "
            f"[{card}]")
    log(f"[llm-8s] one step at position {cross['start'] + steps}: "
        f"unsharded {plain_ms:.3f} ms, sharded {sharded_ms:.3f} ms (median "
        f"of 20); peak memory {peak:.2f} GiB  [{card}]")
    return result


def llm_phase(torch, card, counters, device="cuda", archs=None,
              sizes=None) -> dict:
    """Phase 8: the LLM families' serving path, ``make_prefill_step`` and
    ``make_serve_step``, at the published widths (``archs``: the port's
    ``ARCHS`` unless a rehearsal passes others); the checks and printed
    metrics of the docstring's 8h, 8w, 8d and 8z.  Returns what the
    ``kernels`` line needs: the launches by path, the shapes the paths gave
    the kernels and each run's summary."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.rglru_scan.ref import rglru_ref
    from repro_torch.models import (
        get_family,
        make_prefill_step,
        make_serve_step,
        transformer,
    )
    from repro_torch.nn.layers import rope_frequencies, set_flash_attention

    archs = archs or ARCHS
    sz = {**LLM_SIZES, **(sizes or {})}
    out = {"rglru_shapes": Counter(), "flash_shapes": Counter(), "runs": {}}
    real_scan, real_flash = rops.rglru_scan, fops.flash_attention

    def scan_rec(a, x):
        out["rglru_shapes"][tuple(a.shape)] += 1
        return real_scan(a, x)

    def flash_rec(q, k, v, **kw):
        out["flash_shapes"][(q.shape[0], q.shape[1], k.shape[1],
                             q.shape[2])] += 1
        return real_flash(q, k, v, **kw)

    def counted(fn):
        torch.cuda.synchronize()
        zero_counts(counters)
        res = fn()
        torch.cuda.synchronize()
        return res, read_counts(counters)

    # ------------------------------------------------ 8h. recurrentgemma-2b
    cfg = archs["recurrentgemma-2b"]
    t0 = time.perf_counter()
    params = llm_draw(torch, cfg, 0, device)
    torch.cuda.synchronize()
    log(f"[llm-8h] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, {cfg.n_kv_heads} KV head, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}: "
        f"{sum(t.numel() for t in _leaves(params)):.4g} parameters f32 drawn "
        f"in {time.perf_counter() - t0:.2f} s")
    prefill = make_prefill_step(cfg)
    batch = {"tokens": llm_tokens(torch, cfg, sz["hybrid_prefill"], 1, device)}
    rops.rglru_scan = scan_rec
    try:
        last, counts = counted(lambda: prefill(params, batch))
    finally:
        rops.rglru_scan = real_scan
    reckoned = rglru_blocks(cfg)
    scan_shape = (*sz["hybrid_prefill"], cfg.d_model)
    others = {k: v for k, v in counts.items() if k != "rglru_scan"}
    if (counts["rglru_scan"] != reckoned or any(others.values())
            or out["rglru_shapes"] != Counter({scan_shape: reckoned})):
        raise AssertionError(f"8h prefill: launches {counts} (rglru_scan "
                             f"reckoned {reckoned}), scan shapes "
                             f"{dict(out['rglru_shapes'])}")
    if not bool(torch.isfinite(last).all()):
        raise AssertionError("8h prefill: last logits not finite")
    rops.rglru_scan = rglru_ref              # the plain version in its place
    try:
        plain, plain_counts = counted(lambda: prefill(params, batch))
    finally:
        rops.rglru_scan = real_scan
    if plain_counts["rglru_scan"]:
        raise AssertionError(f"8h plain route launched {plain_counts}")
    e_plain = rel_inf(last, plain, cfg.vocab)
    if not e_plain <= LLM_REL:
        raise AssertionError(f"8h: kernel vs plain scan prefill rel {e_plain}")
    log(f"[llm-8h] prefill {sz['hybrid_prefill']}: rglru_scan launches "
        f"{counts['rglru_scan']} (reckoned {reckoned}: 2 x {cfg.n_layers // 3} "
        f"super-blocks + {cfg.n_layers % 3}) at {scan_shape}, other kernels "
        f"{others}; last logits finite; kernel vs plain scan route rel err "
        f"{e_plain:.3e} <= {LLM_REL}")
    dtokens = llm_tokens(torch, cfg, sz["hybrid_decode"], 2, device)
    e_dec = decode_vs_forward(torch, cfg, params, dtokens,
                              sz["hybrid_decode"][1], device)
    log(f"[llm-8h] decode {sz['hybrid_decode'][1]} steps vs forward "
        f"{sz['hybrid_decode']}: worst rel err {e_dec:.3e} <= {LLM_REL}")
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = cuda_ms(torch, lambda: prefill(params, batch), 3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    fam = get_family(cfg)
    b8, depth = sz["hybrid_timed"]
    cache = [fam.init_decode_cache(cfg, b8, depth, dtype=torch.float32,
                                   device=device)]
    step = make_serve_step(cfg)
    tok8 = llm_tokens(torch, cfg, (b8,), 3, device)

    def one_step():
        logits, cache[0] = step(params, cache[0], tok8)
        return logits

    decode_ms = cuda_ms(torch, one_step, 20)
    prof = profile_prefill(torch, lambda: prefill(params, batch), card,
                           f"{cfg.name} prefill {sz['hybrid_prefill']}",
                           HYBRID_PROFILE, device)
    out["runs"]["8h"] = {"prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
                         "peak_gib": peak, "kernel_vs_plain_rel": e_plain,
                         "decode_vs_forward_rel": e_dec, "profile": prof,
                         "rglru_launches": counts["rglru_scan"]}
    log(f"[llm-8h] prefill {sz['hybrid_prefill']} wall {prefill_ms:.3f} ms "
        f"(CUDA events, median of 3 after 1 warm-up); one decode step at "
        f"batch {b8} against a {depth}-deep cache ({cache[0]['ak'].shape[3]}-"
        f"slot local-attention ring) {decode_ms:.3f} ms (median of 20); "
        f"peak memory {peak:.2f} GiB  [{card}]")
    del params, cache, last, plain, batch
    free(torch)

    # ------------------------------------------------- 8w. whisper-tiny
    cfg = archs["whisper-tiny"]
    params = llm_draw(torch, cfg, 0, device)
    bw, sw = sz["whisper_prefill"]
    gen = torch.Generator(device).manual_seed(5)
    batch = {"tokens": llm_tokens(torch, cfg, (bw, sw), 4, device),
             "frames": torch.randn((bw, cfg.encoder_seq, cfg.d_model),
                                   generator=gen, device=device)}
    prefill = make_prefill_step(cfg)
    fops.flash_attention = flash_rec
    try:
        last, counts = counted(lambda: prefill(params, batch))
    finally:
        fops.flash_attention = real_flash
    flash_shape = (bw * cfg.n_heads, cfg.encoder_seq, cfg.encoder_seq,
                   cfg.head_dim)
    reckoned = cfg.encoder_layers + (cfg.n_layers if sw == cfg.encoder_seq
                                     else 0)
    others = {k: v for k, v in counts.items() if k != "flash_attention"}
    if (counts["flash_attention"] != reckoned or any(others.values())
            or out["flash_shapes"] != Counter({flash_shape: reckoned})):
        raise AssertionError(f"8w prefill: launches {counts} (flash reckoned "
                             f"{reckoned}), shapes {dict(out['flash_shapes'])}")
    prev = set_flash_attention(False)
    try:
        plain, plain_counts = counted(lambda: prefill(params, batch))
    finally:
        set_flash_attention(prev)
    if plain_counts["flash_attention"]:
        raise AssertionError(f"8w plain route launched {plain_counts}")
    e_plain = rel_inf(last, plain, cfg.vocab)
    if not (bool(torch.isfinite(last).all()) and e_plain <= LLM_REL):
        raise AssertionError(f"8w: flash vs plain attention prefill rel "
                             f"{e_plain}")
    wall_ms = cuda_ms(torch, lambda: prefill(params, batch), 3, warmup=1)
    # decode against the encoder's output, as a prefill leaves it
    cache = get_family(cfg).init_decode_cache(cfg, bw, sw,
                                              dtype=torch.float32,
                                              device=device)
    cache["enc_out"] = transformer.encode(
        params, cfg, batch["frames"],
        rope_frequencies(cfg.head_dim, cfg.encoder_seq, cfg.rope_theta,
                         device=device))
    step = make_serve_step(cfg)
    for t in range(sz["whisper_decode"]):
        logits, cache = step(params, cache, batch["tokens"][:, t])
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"8w decode step {t}: logits not finite")
    out["runs"]["8w"] = {"prefill_ms": wall_ms, "flash_vs_plain_rel": e_plain,
                         "flash_launches": counts["flash_attention"]}
    log(f"[llm-8w] {cfg.name}: prefill tokens {(bw, sw)}, frames "
        f"{tuple(batch['frames'].shape)}: flash_attention launches "
        f"{counts['flash_attention']} (reckoned {reckoned}: the encoder's "
        f"layers) at {flash_shape}, other kernels {others}; last logits vs "
        f"set_flash_attention(False) rel err {e_plain:.3e} <= {LLM_REL}; "
        f"prefill wall {wall_ms:.3f} ms (median of 3 after 1 warm-up); "
        f"{sz['whisper_decode']} decode steps finite  [{card}]")
    del params, cache, last, plain, batch
    free(torch)

    # ---------------------------------------------------- 8d. llama3-8b
    cfg = archs["llama3-8b"]
    params = llm_draw(torch, cfg, 0, device)
    prefill = make_prefill_step(cfg)
    batch = {"tokens": llm_tokens(torch, cfg, sz["llama_prefill"], 1, device)}
    torch.cuda.reset_peak_memory_stats()
    last = prefill(params, batch)
    if not bool(torch.isfinite(last).all()):
        raise AssertionError("8d prefill: last logits not finite")
    prefill_ms = cuda_ms(torch, lambda: prefill(params, batch), 3, warmup=1)
    dtokens = llm_tokens(torch, cfg, sz["llama_decode"], 2, device)
    e_full = decode_vs_forward(torch, cfg, params, dtokens, sz["llama_cache"],
                               device)
    e_ring = decode_vs_forward(torch, cfg, params, dtokens, sz["llama_cache"],
                               device, ring=True)
    fam = get_family(cfg)
    cache = [fam.init_decode_cache(cfg, 1, sz["llama_timed_cache"],
                                   dtype=torch.float32, device=device)]
    step = make_serve_step(cfg)
    tok1 = llm_tokens(torch, cfg, (1,), 3, device)

    def one_step():
        logits, cache[0] = step(params, cache[0], tok1)
        return logits

    decode_ms = cuda_ms(torch, one_step, 20)
    peak = torch.cuda.max_memory_allocated() / 2**30
    out["runs"]["8d"] = {"prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
                         "peak_gib": peak, "decode_vs_forward_rel": e_full,
                         "ring_vs_forward_rel": e_ring}
    log(f"[llm-8d] {cfg.name}: prefill {sz['llama_prefill']} finite, wall "
        f"{prefill_ms:.3f} ms (median of 3 after 1 warm-up); decode "
        f"{sz['llama_decode'][1]} steps vs forward against a "
        f"{sz['llama_cache']}-deep cache (blockwise decode) worst rel err "
        f"{e_full:.3e}, ring cache worst {e_ring:.3e} (<= {LLM_REL}); one "
        f"decode step at batch 1 against a {sz['llama_timed_cache']}-deep "
        f"cache {decode_ms:.3f} ms (median of 20); peak memory {peak:.2f} "
        f"GiB  [{card}]")
    del cache, last, batch
    free(torch)

    # ------------ 8s. llama3-8b's decode over a sequence-sharded cache
    out["runs"]["8s"] = sharded_decode_phase(torch, cfg, params, card,
                                             counters, device, sz)
    del params
    free(torch)

    # ------------------------- 8z. every other config, full width, cut depth
    for name in OTHER_ARCHS:
        cfg = dataclasses.replace(archs[name],
                                  n_layers=OTHER_LAYERS.get(name, 2))
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        params = llm_draw(torch, cfg, 0, device)
        batch = {"tokens": llm_tokens(torch, cfg, sz["other_prefill"], 1,
                                      device)}
        if cfg.frontend_tokens:
            gen = torch.Generator(device).manual_seed(5)
            batch["patches"] = torch.randn(
                (sz["other_prefill"][0], cfg.frontend_tokens, cfg.frontend_dim),
                generator=gen, device=device)
        t0 = time.perf_counter()
        last = make_prefill_step(cfg)(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not bool(torch.isfinite(last).all()):
            raise AssertionError(f"8z {name} prefill: last logits not finite")
        dtokens = llm_tokens(torch, cfg, sz["other_decode"], 2, device)
        e_dec = decode_vs_forward(torch, cfg, params, dtokens,
                                  sz["other_decode"][1], device)
        out["runs"][f"8z {name}"] = {"layers": cfg.n_layers,
                                     "decode_vs_forward_rel": e_dec}
        log(f"[llm-8z] {name}: {cfg.n_layers} of {archs[name].n_layers} "
            f"layers, d {cfg.d_model}, vocab {cfg.vocab}"
            f"{', capacity factor 8.0' if cfg.n_experts else ''}: prefill "
            f"{sz['other_prefill']}"
            f"{' + %d patches' % cfg.frontend_tokens if cfg.frontend_tokens else ''}"
            f" finite, first call {wall:.2f} s; decode {sz['other_decode'][1]} "
            f"steps vs forward worst rel err {e_dec:.3e} <= {LLM_REL}  [{card}]")
        del params, last, batch
        free(torch)
    return out


# -------------------------------------------------------------- training

# phase 9: the training path's tolerances, stated before its first run.
# The kernel route against the plain route (the plain attention through
# set_flash_attention(False); the plain scan and rglru_bwd_ref in the
# kernels' places): the first step's loss and each leaf's gradient, max
# |difference| over max |reference| per leaf (f32 on both routes, other
# summation orders; the flash forward's 3xTF32 products keep about 20 bits)
TRAIN_REL = 1e-4
# the flash backward kernel against attention_bwd_ref on the same inputs:
# max |difference| <= FLASH_BWD_TOL * max(1, max |reference|)
FLASH_BWD_TOL = 1e-5
# the RG-LRU backward kernel against rglru_bwd_ref, max |difference| over
# max |reference|; both against the float64 literal reverse recurrence
# (da's slope -a / sqrt(1 - a^2) magnifies the f32 rounding of 1 - a^2 on
# long-memory gates, for the plain version as for the kernel: 3.6e-5 at
# (1, 4096, 2560) on the H100, phase 9h's long-memory check)
RGLRU_BWD_REL = 3e-6
RGLRU_BWD_F64_REL = 1e-4
# (batch, tokens) of each run, the hybrid's cut depth and the steps
TRAIN_SIZES = {"whisper": (4, 448), "hybrid": (1, 4096), "hybrid_layers": 5,
               "steps": 3}
# what a profiled step sums by kind (the optimizer through a range around
# its update, the attention through a range around every gqa_attention)
TRAIN_PROFILE = {"flash_fwd": FLASH_KERNELS, "flash_bwd": ("flash_bwd_",),
                 "rglru_fwd": ("rglru_scan_kernel",),
                 "rglru_bwd": ("rglru_scan_bwd_kernel",),
                 "rglru_init": ("rglru_scan_init_kernel",),
                 "gemms": GEMM_KERNELS}


def leaf_rel(torch, got, want) -> dict:
    """max |got - want| / max |want| for each leaf of two gradient trees
    (float64 on the card), by key path; a leaf whose reference is all 0
    reads its max |got|."""
    from repro_torch.train.tree import paths

    ref = dict(paths(want))
    out = {}
    for key, g in paths(got):
        w = ref[key].double()
        den = float(w.abs().max())
        out[key] = float((g.double() - w).abs().max()) / (den if den else 1.0)
    return out


def time_flash_bwd(torch, fa, fref, shape, reps=10) -> dict:
    """The backward kernel at ``shape`` (f32, non-causal): CUDA events,
    median of ``reps`` after 2 warm-ups, beside its plain version and
    SDPA's backward.  Bound: the five products of the score's size (S, dP,
    dV, dK, dQ), 10 BH Sq Sk D operations, against q, k, v, o, dO and the
    row log-sum-exp read and dq, dk, dv written once; as for the f32
    forward, at the rate of three TF32 passes (the card's f32-accurate
    product rate), with the f32 FMA rate's figure beside it
    (``bound_f32_fma_ms``, on the ``[time]`` line only).  Also on that
    line: the kernel's share of its bound (over ``queued_ms``), its time
    over SDPA's backward,
    and the bound of the 7 products the kernel does (S and dP once in the
    dK/dV sweep and again in the dQ sweep) at three TF32 passes."""
    import torch.nn.functional as F

    bh, sq, sk, d = shape
    q, k, v = attention_inputs(torch, shape, torch.float32, seed=11)
    do = torch.randn_like(q)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    nbytes = 4.0 * (4 * bh * sq * d + 4 * bh * sk * d + bh * sq)
    flops = 10.0 * bh * sq * sk * d
    bound_ms, bound_by = bound(nbytes, 3 * flops, "tf32")
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs)
    ms = cuda_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
                 reps)
    queued = queued_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse,
                                                             do))
    library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (qs, ks, vs), do, retain_graph=True), reps)
    return {
        "shape": "BH=%d,Sq=%d,Sk=%d,D=%d,float32" % shape,
        "ms": ms,
        "queued_ms": queued,
        "plain_ms": cuda_ms(torch, lambda: fref.attention_bwd_ref(
            q, k, v, o, lse, do), reps),
        "library_ms": library_ms,
        "library": "torch.autograd.grad of F.scaled_dot_product_attention",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_share": bound_ms / queued, "over_library": ms / library_ms,
        "bound_7_products_ms": bound(nbytes, 3 * 1.4 * flops, "tf32")[0],
        "bound_f32_fma_ms": bound(nbytes, flops, "float32")[0],
    }


def check_flash_bwd(torch, fa, fref, shape) -> float:
    """dq, dk, dv of the backward kernel against ``attention_bwd_ref``
    within ``FLASH_BWD_TOL``; the same bits on a second call."""
    q, k, v = attention_inputs(torch, shape, torch.float32, seed=12)
    do = torch.randn_like(q)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    want = fref.attention_bwd_ref(q, k, v, o, lse, do)
    err = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        e = float((g - w).abs().max())
        if not e <= FLASH_BWD_TOL * max(1.0, float(w.abs().max())):
            raise AssertionError(f"flash_attention_bwd {shape} {name}: max "
                                 f"|err| {e}")
        err = max(err, e)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_attention_bwd {shape}: a second call "
                             f"gave other bits")
    return err


def rglru_literal_bwd_f64(torch, a, x, h, dh):
    """(da, dx) by the reverse recurrence step by step in float64."""
    a, x, h, dh = (t.double() for t in (a, x, h, dh))
    y = 1 - a * a
    root = torch.sqrt(torch.clamp(y, min=0.0))
    slope = torch.where(y > 0, -a / torch.where(y > 0, root, 1.0), 0.0)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    g = torch.zeros_like(a[:, 0])
    da, dx = torch.empty_like(a), torch.empty_like(a)
    for t in range(a.shape[1] - 1, -1, -1):
        g = dh[:, t] + (a[:, t + 1] * g if t + 1 < a.shape[1] else 0.0)
        dx[:, t] = g * root[:, t]
        da[:, t] = g * (h_prev[:, t] + x[:, t] * slope[:, t])
    return da, dx


def check_rglru_bwd(torch, rk, rref, a, x, dh, what) -> dict:
    """The backward kernel at (a, x, h = scan(a, x), dh) against
    ``rglru_bwd_ref`` (``RGLRU_BWD_REL``) and both against the float64
    reverse recurrence (``RGLRU_BWD_F64_REL``); the same bits twice."""
    h = rk.rglru_scan(a, x)
    got = rk.rglru_scan_bwd(a, x, h, dh)
    torch.cuda.synchronize()
    want = rref.rglru_bwd_ref(a, x, h, dh)
    lit = rglru_literal_bwd_f64(torch, a, x, h, dh)
    out = {}
    for i, name in enumerate(("da", "dx")):
        den = float(want[i].abs().max())
        e = float((got[i] - want[i]).abs().max()) / den
        lden = float(lit[i].abs().max())
        e64 = [float((r[i].double() - lit[i]).abs().max()) / lden
               for r in (got, want)]
        if not (e <= RGLRU_BWD_REL and max(e64) <= RGLRU_BWD_F64_REL):
            raise AssertionError(f"rglru_scan_bwd {what} {name}: rel {e}, "
                                 f"vs float64 kernel {e64[0]} plain {e64[1]}")
        out[name] = {"rel_vs_plain": e, "rel_vs_f64": e64[0],
                     "plain_rel_vs_f64": e64[1], "max_abs": den}
    if not all(torch.equal(p, q) for p, q in
               zip(got, rk.rglru_scan_bwd(a, x, h, dh))):
        raise AssertionError(f"rglru_scan_bwd {what}: other bits on a second "
                             f"call")
    return out


def time_rglru_bwd(torch, rk, rref, shape, reps=10) -> dict:
    """Bound: a, x, h and dh read once and da, dx written once, 24 bytes
    an element."""
    a, x = rglru_inputs(torch, *shape, seed=13)
    dh = torch.randn_like(a)
    h = rk.rglru_scan(a, x)
    b, t, d = shape
    bound_ms, bound_by = bound(24.0 * b * t * d, 12.0 * b * t * d, "float32")
    return {"shape": "B=%d,T=%d,D=%d,float32" % shape,
            "ms": cuda_ms(torch, lambda: rk.rglru_scan_bwd(a, x, h, dh), reps),
            "queued_ms": queued_ms(
                torch, lambda: rk.rglru_scan_bwd(a, x, h, dh)),
            "plain_ms": cuda_ms(torch, lambda: rref.rglru_bwd_ref(a, x, h, dh),
                                reps),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def profile_train_step(torch, step_fn, state, batch, card, label,
                       device="cuda") -> dict:
    """One train step under the profiler: busy and idle, the named
    kernels' device time and shares (``TRAIN_PROFILE``), and the device
    spans of two ``record_function`` ranges, the optimizer's update and
    every ``gqa_attention`` call (the profiler lists a range as a CUDA row
    of its name; busy time leaves it out)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import steps
    from repro_torch.models import transformer as tfm

    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    real = {"adamw_update": steps.adamw_update,
            "gqa_attention": tfm.gqa_attention}
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    steps.adamw_update = ranged("train_optimizer", real["adamw_update"])
    tfm.gqa_attention = ranged("train_attention", real["gqa_attention"])
    try:
        fn = step_fn()                  # built with the ranged update
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn(*state, batch)
            loss = float(out[2]["loss"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        steps.adamw_update = real["adamw_update"]
        tfm.gqa_attention = real["gqa_attention"]
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    spans = {name: sum(r[0] for r in rows if r[2] == name)
             for name in ("train_optimizer", "train_attention")}
    rows = sorted((r for r in rows if r[2] not in spans), reverse=True)
    busy = sum(r[0] for r in rows)
    nm = "not measured"
    prof_out = {"window": label, "wall_ms": wall_ms, "loss": loss,
                "device_busy_ms": busy if rows else nm,
                "idle_share": 1 - busy / wall_ms if rows else nm}
    for name, keys in TRAIN_PROFILE.items():
        ms = sum(r[0] for r in rows if any(k in r[2] for k in keys))
        prof_out[f"{name}_ms"] = ms if rows else nm
        prof_out[f"{name}_share_of_busy"] = ms / busy if rows else nm
    for name, ms in spans.items():
        key = name.replace("train_", "")
        prof_out[f"{key}_ms"] = ms if ms > 0 else nm
        prof_out[f"{key}_share_of_busy"] = ms / busy if ms > 0 else nm
    prof_out["top_kernels"] = [{"ms": ms, "count": n, "name": name[:90]}
                               for ms, n, name in rows[:8]]
    log(f"[profile] {json.dumps(prof_out)}  [{card}]")
    return prof_out


def train_phase(torch, card, counters, device="cuda", archs=None,
                sizes=None) -> dict:
    """Phase 9: the training path (``repro_torch.train.train``,
    ``make_train_step``, AdamW, checkpoints, the data pipeline) at the
    published widths, the checks and printed metrics of the docstring's
    9w and 9h.  ``counters`` are the forward and backward kernels'
    wrappers; ``archs`` and ``sizes`` stand in for a rehearsal.  Returns
    what the ``kernels`` line needs."""
    import shutil
    import tempfile

    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.rglru_scan import kernel as rk
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.rglru_scan import ref as rref
    from repro_torch.models import get_family, make_loss_fn, make_train_step
    from repro_torch.models.steps import _value_and_grad
    from repro_torch.nn.layers import set_flash_attention
    from repro_torch.train import TrainConfig, train
    from repro_torch.train import loop
    from repro_torch.train.loop import device_batch
    from repro_torch.train.tree import paths

    archs = archs or ARCHS
    sz = {**TRAIN_SIZES, **(sizes or {})}
    out = {"runs": {}, "timings": {}}

    def counted(fn):
        torch.cuda.synchronize()
        zero_counts(counters)
        res = fn()
        torch.cuda.synchronize()
        return res, read_counts(counters)

    def first_step_grads(cfg, data_cfg, plain):
        """(loss, grads, launches) of the first step: train()'s initial
        parameters and first batch, through the kernel route or (``plain``)
        the script's plain route."""
        params = get_family(cfg).init(
            torch.Generator(device).manual_seed(data_cfg.seed), cfg,
            device=device)
        batch = device_batch(next(iter(SyntheticLM(cfg, data_cfg))), device)
        vg = _value_and_grad(make_loss_fn(cfg))
        (loss, grads), counts = counted(lambda: plain(vg, params, batch))
        return float(loss), grads, counts

    def run(tag, cfg, data_cfg, kernel_names, plain_route, reckoned):
        """Steps of ``train()`` with the launches of each step, the first
        step's gradients against the plain route, the resume from a
        checkpoint after step 2, walls, peak memory and a profiled step."""
        steps = sz["steps"]
        # the first step's loss and gradients, kernel route then plain
        loss_k, grads_k, counts_k = first_step_grads(
            cfg, data_cfg, lambda vg, p, b: vg(p, b))
        for name, want in reckoned.items():
            if counts_k[name] != want:
                raise AssertionError(f"9{tag} first step: {name} launched "
                                     f"{counts_k[name]}, reckoned {want} "
                                     f"({counts_k})")
        loss_p, grads_p, counts_p = first_step_grads(cfg, data_cfg,
                                                     plain_route)
        if any(counts_p[n] for n in kernel_names):
            raise AssertionError(f"9{tag} plain route launched {counts_p}")
        rels = leaf_rel(torch, grads_k, grads_p)
        worst = max(rels, key=rels.get)
        dead = [k for (k, g), (_, w) in zip(paths(grads_k), paths(grads_p))
                if not bool((g != 0).any()) and bool((w != 0).any())]
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        if not (math.isfinite(loss_k) and loss_rel <= TRAIN_REL
                and rels[worst] <= TRAIN_REL and not dead):
            raise AssertionError(f"9{tag}: loss {loss_k} vs plain {loss_p} "
                                 f"(rel {loss_rel}), worst leaf {worst} "
                                 f"{rels[worst]}, all-zero leaves {dead}")
        # the same gradients again: the bits of a step repeat
        _, grads_k2, _ = first_step_grads(cfg, data_cfg,
                                          lambda vg, p, b: vg(p, b))
        repeat = all(torch.equal(a, b) for (_, a), (_, b) in
                     zip(paths(grads_k), paths(grads_k2)))
        log(f"[train-9{tag}] first step: loss {loss_k:.6f}, plain route "
            f"{loss_p:.6f} (rel {loss_rel:.3e}); gradients of "
            f"{len(rels)} leaves, worst rel {rels[worst]:.3e} ({worst}) <= "
            f"{TRAIN_REL}; no leaf all zero; launches {counts_k}; the "
            f"gradients' bits repeat: {repeat}")
        del grads_k, grads_p, grads_k2
        free(torch)

        # train(): every step counted, then a checkpoint after step 2 (its
        # seconds timed apart and left out of the step walls)
        per_step, lines, saves = [], [], []
        starts, ends = [time.perf_counter()], []
        real_save = loop.save_checkpoint

        def on_log(line):
            torch.cuda.synchronize()
            per_step.append(read_counts(counters))
            zero_counts(counters)
            ends.append(time.perf_counter())
            starts.append(ends[-1])
            lines.append(line)

        def timed_save(*a, **kw):
            t0 = time.perf_counter()
            path = real_save(*a, **kw)
            saves.append(time.perf_counter() - t0)
            starts[-1] += saves[-1]       # the next step starts after it
            return path

        ckpt = tempfile.mkdtemp(prefix=f"train9{tag}_")
        try:                  # 9h's checkpoint is 21 GB: never left behind
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts(counters)
            loop.save_checkpoint = timed_save
            try:
                whole = train(cfg, data_cfg, TrainConfig(
                    steps=steps, log_every=1, checkpoint_every=2,
                    checkpoint_dir=ckpt), log=on_log, device=device)
            finally:
                loop.save_checkpoint = real_save
            peak = torch.cuda.max_memory_allocated() / 2**30
            walls = [(b - a) * 1e3 for a, b in zip(starts, ends)]
            for i, counts in enumerate(per_step):
                for name, want in reckoned.items():
                    if counts[name] != want:
                        raise AssertionError(f"9{tag} step {i + 1}: {name} "
                                             f"launched {counts[name]}, "
                                             f"reckoned {want} ({counts})")
            losses = whole["losses"]
            if not (len(losses) == steps and all(map(math.isfinite, losses))
                    and losses[0] == loss_k):
                raise AssertionError(f"9{tag}: losses {losses} (first step "
                                     f"alone {loss_k})")
            final = [t.cpu() for _, t in paths(whole["params"])]
            del whole
            free(torch)
            # a fresh train() restores step 2 and takes step 3
            t0 = time.perf_counter()
            rlog = []
            resumed = train(cfg, data_cfg, TrainConfig(
                steps=steps, log_every=1, checkpoint_dir=ckpt),
                log=rlog.append, device=device)
            resume_s = time.perf_counter() - t0
            same = (rlog[0] == f"restored checkpoint at step {steps - 1}"
                    and resumed["losses"] == losses[-1:]
                    and all(torch.equal(a.cpu(), b) for (_, a), b in
                            zip(paths(resumed["params"]), final)))
            if not same:
                raise AssertionError(f"9{tag}: the resumed step 3 differs: "
                                     f"{rlog[:1]}, losses {resumed['losses']} "
                                     f"vs {losses[-1:]}")
            state = (resumed["params"], resumed["opt_state"])
            del resumed, final
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        tokens = data_cfg.batch_size * data_cfg.seq_len
        wall = statistics.median(walls)
        log(f"[train-9{tag}] {steps} AdamW steps of train() at "
            f"({data_cfg.batch_size}, {data_cfg.seq_len}): losses "
            f"{[round(l, 6) for l in losses]}; launches each step "
            f"{per_step[0]}; step walls {[round(w, 1) for w in walls]} ms "
            f"(median {wall:.1f} ms, data and host included), "
            f"{tokens / wall * 1e3:,.0f} tok/s; peak memory {peak:.2f} GiB; "
            f"the loop's lines {lines}; the step-2 checkpoint saved in "
            f"{saves[0]:.1f} s; a fresh train() restored it and took step 3 "
            f"in {resume_s:.1f} s: its parameters bit-identical  [{card}]")
        batch = device_batch(next(iter(SyntheticLM(cfg, data_cfg))), device)
        prof = profile_train_step(
            torch, lambda: make_train_step(cfg), state, batch, card,
            f"{cfg.name} train step ({data_cfg.batch_size}, "
            f"{data_cfg.seq_len})", device)
        del state, batch
        free(torch)
        return {"losses": losses, "launches_per_step": per_step[0],
                "launches_total": {n: sum(c[n] for c in per_step)
                                   for n in per_step[0]},
                "step_ms": walls, "median_step_ms": wall,
                "tok_per_s": tokens / wall * 1e3, "peak_gib": peak,
                "first_loss_rel": loss_rel, "worst_grad_rel": rels[worst],
                "grad_bits_repeat": repeat, "save_s": saves[0],
                "resume_s": resume_s,
                "profile": prof}

    # ------------------------------------------------ 9w. whisper-tiny
    cfg = archs["whisper-tiny"]
    bw, sw = sz["whisper"]
    flash_shape = (bw * cfg.n_heads, cfg.encoder_seq, cfg.encoder_seq,
                   cfg.head_dim)

    def plain_attention(vg, p, b):
        prev = set_flash_attention(False)
        try:
            return vg(p, b)
        finally:
            set_flash_attention(prev)

    out["runs"]["9w"] = run(
        "w", cfg, DataConfig(batch_size=bw, seq_len=sw, seed=0),
        ("flash_attention", "flash_attention_bwd"), plain_attention,
        {"flash_attention": cfg.encoder_layers,
         "flash_attention_bwd": cfg.encoder_layers,
         "rglru_scan": 0, "rglru_scan_bwd": 0})
    err = check_flash_bwd(torch, fa, fref, flash_shape)
    t = time_flash_bwd(torch, fa, fref, flash_shape)
    out["timings"]["flash_attention_bwd"] = {**t, "max_abs_err": err,
                                             "path": "whisper-tiny encoder "
                                                     "(phase 9w)"}
    log(f"[kernel] flash_attention_bwd {flash_shape}: max|err| {err:.2e} "
        f"(<= {FLASH_BWD_TOL} x max(1, max|ref|)); bits repeat")
    log(f"[time] {json.dumps(t)}  [{card}]")
    free(torch)

    # ------------------------------- 9h. recurrentgemma-2b, depth cut
    cfg = dataclasses.replace(archs["recurrentgemma-2b"],
                              n_layers=sz["hybrid_layers"])
    bh_, sh = sz["hybrid"]
    n_super, rem = divmod(cfg.n_layers, 3)
    seen = {}
    real_bwd = rops.rglru_scan_bwd

    def bwd_rec(a, x, h, dh):          # the first call's inputs, kept
        if "inputs" not in seen:
            seen["inputs"] = (a.detach().clone(), x.detach().clone(),
                              dh.detach().clone())
        return real_bwd(a, x, h, dh)

    def plain_scan(vg, p, b):
        real_fwd = rops.rglru_scan
        rops.rglru_scan, rops.rglru_scan_bwd = rref.rglru_ref, rref.rglru_bwd_ref
        try:
            return vg(p, b)
        finally:
            rops.rglru_scan, rops.rglru_scan_bwd = real_fwd, real_bwd

    rops.rglru_scan_bwd = bwd_rec
    try:
        out["runs"]["9h"] = run(
            "h", cfg, DataConfig(batch_size=bh_, seq_len=sh, seed=0),
            ("rglru_scan", "rglru_scan_bwd"), plain_scan,
            {"rglru_scan": 4 * n_super + rem, "rglru_scan_bwd": 2 * n_super
             + rem, "flash_attention": 0, "flash_attention_bwd": 0})
    finally:
        rops.rglru_scan_bwd = real_bwd
    a, x, dh = seen.pop("inputs")
    checks = {"model gates": check_rglru_bwd(torch, rk, rref, a, x, dh,
                                             "on the model's gates")}
    del a, x, dh
    shape = (bh_, sh, cfg.d_model)
    a, x = rglru_inputs(torch, *shape, seed=14, long_memory=True)
    checks["long memory"] = check_rglru_bwd(torch, rk, rref, a, x,
                                            torch.randn_like(a),
                                            "long memory")
    del a, x
    t = time_rglru_bwd(torch, rk, rref, shape)
    out["timings"]["rglru_scan_bwd"] = {
        **t, "path": "recurrentgemma-2b train step (phase 9h)",
        "max_abs_err": max(c[n]["rel_vs_plain"] * c[n]["max_abs"]
                           for c in checks.values() for n in ("da", "dx"))}
    log(f"[kernel] rglru_scan_bwd {shape}: {json.dumps(checks)} (rel <= "
        f"{RGLRU_BWD_REL} vs plain, <= {RGLRU_BWD_F64_REL} vs float64); "
        f"bits repeat")
    log(f"[time] {json.dumps(t)}  [{card}]")
    free(torch)
    summary = {tag: {k: v for k, v in run.items() if k != "profile"}
               for tag, run in out["runs"].items()}
    log(f"[train] summary {json.dumps(summary)}  [{card}]")
    return out


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
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.lora_matmul import kernel as lk
    from repro_torch.kernels.lora_matmul import ref as lref
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.quant_matmul import ref as qref
    from repro_torch.kernels.rglru_scan import kernel as rk
    from repro_torch.kernels.rglru_scan import ref as rref
    from repro_torch.nn.layers import quant_mode, set_flash_attention, set_quant_mode
    from repro_torch.sim import check_invariants

    t_start = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16
    path_types = (f32, bf16, bf16)
    # 10. the dry-run CLIs, on the host's cores beside the card's phases
    dryruns = start_dryruns()

    # ---------------------------------------------------------- 1. card
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    def timed_build(source):
        t0 = time.perf_counter()
        return build.build(source), time.perf_counter() - t0

    sources = (fa.SOURCE, fa.BWD_SOURCE, lk.SOURCE, qk.SOURCE, qk.ROWS_SOURCE,
               rk.SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(timed_build, sources))
    log(f"[build] {len(sources)} sources in {time.perf_counter() - t0:.1f} s")
    for source, (lib, secs) in zip(sources, built):
        log(f"[build] {source.name} in {secs:.1f} s")
        lines = lib.with_suffix(".log").read_text().splitlines()
        for line in dict.fromkeys(l.strip() for l in lines
                                  if "registers" in l or "spill" in l):
            log(f"[build] {source.name}: {line}")
    # every instantiation of flash attention's forward and of the int8
    # route's kernels, by name; the int8 kernels and flash attention's
    # head-dim-128 kernels must spill nothing
    for source, (lib, _) in zip(sources, built):
        if source not in (qk.SOURCE, qk.ROWS_SOURCE, fa.SOURCE):
            continue
        report = ptxas_report(lib.with_suffix(".log").read_text())
        for name, regs, stores, loads in report:
            log(f"[build] {source.name}: {name}: {regs} registers, {stores} "
                f"bytes spill stores, {loads} bytes spill loads")
        if source == fa.SOURCE:
            report = [r for r in report
                      if any(name in r[0] for name in D128_KERNELS)]
            if not all(any(name in r[0] for r in report)
                       for name in D128_KERNELS):
                raise AssertionError(f"{source.name}: ptxas reports no "
                                     f"{D128_KERNELS}: {report}")
        if not report or any(st or ld for _, _, st, ld in report):
            raise AssertionError(f"{source.name}: ptxas reports spills (or no "
                                 f"entry function): {report}")

    # ------------------------------------------ 2. kernel vs plain version
    for shape, causal, window in GRID:
        for dtype, atol in ((f32, 2e-5), (bf16, 3e-2)):
            err = check_attention(torch, fa, shape, causal, window, dtype, atol)
            log(f"[kernel] grid {shape} causal={causal} window={window} "
                f"{dtype}: max|err| {err:.2e} <= {atol}")
    # the tensor-core tiles (f32, D 64) and the split-KV grid (f32, D 1024)
    # under causal and window bands: wholly masked tiles and chunks, ragged
    # edges, rows with no key, and a merge of 266 chunks
    for shape, causal, window in (((3, 500, 500, 64), True, None),
                                  ((2, 300, 300, 64), True, 37),
                                  ((1, 200, 150, 64), True, 1),
                                  *D128_BANDS,
                                  ((3, 100, 77, 1024), False, None),
                                  ((2, 333, 333, 1024), True, 70),
                                  ((2, 333, 333, 1024), False, 40),
                                  ((1, 200, 150, 1024), True, 1),
                                  ((1, 16, 17000, 1024), False, None)):
        err = check_attention(torch, fa, shape, causal, window, f32, 2e-5,
                              same_bits=shape[3] == 128)
        log(f"[kernel] bands {shape} causal={causal} window={window} "
            f"float32: max|err| {err:.2e} <= 2e-05")
    # head dim 128 in bf16: the CUDA-core template
    for shape, causal, window in D128_BANDS:
        err = check_attention(torch, fa, shape, causal, window, bf16, 3e-2)
        log(f"[kernel] bands {shape} causal={causal} window={window} "
            f"bfloat16: max|err| {err:.2e} <= 3e-02")
    path_err = 0.0
    for shape in ((48, 4429, 4429, 64), (96, 4429, 4429, 64),
                  (144, 4429, 4429, 64), (4, 333, 333, 1024),
                  (8, 333, 333, 1024), *FAMILY_SHAPES, (4, 512, 512, 128)):
        err = check_attention(torch, fa, shape, False, None, f32, 2e-5,
                              same_bits=shape[3] == 128)
        path_err = max(path_err, err)
        log(f"[kernel] path {shape} float32: max|err| {err:.2e} <= 2e-05"
            + (", the same bits twice" if shape[3] == 128 else ""))
    # the D = 128 route's pre-pass: a ragged Sk and Flux's shape
    for shape in ((2, 77, 77, 128), (24, 4608, 4608, 128)):
        check_split_planes(torch, fa, fref, shape)
        log(f"[kernel] split planes {shape}: bit-identical to the plain "
            f"version")
    for shape, causal, window in (((4, 333, 333, 1024), False, None),
                                  ((8, 333, 333, 1024), False, None),
                                  ((2, 333, 333, 1024), True, 70),
                                  ((1, 200, 150, 1024), True, 1),
                                  ((1, 16, 17000, 1024), False, None)):
        err = check_split_kv(torch, fa, fref, shape, causal, window)
        log(f"[kernel] split-KV partials and merge {shape} causal={causal} "
            f"window={window}: max|err| {err:.2e} (atol = rtol = 2e-05)")

    for shape in LORA_GRID:
        for types, tol in (((f32,) * 3, 1e-4), ((bf16,) * 3, 1.5e-1)):
            err = check_lora_single(torch, lk, lref, shape, types, 0.7, tol, tol)
            log(f"[kernel] lora_matmul grid {shape} {types[0]}: max|err| "
                f"{err:.2e} (atol=rtol={tol})")
    for shape in LORA_EDGE:
        err = check_lora_single(torch, lk, lref, shape, (f32,) * 3, 1.3,
                                1e-4, 1e-4)
        log(f"[kernel] lora_matmul edge {shape}: max|err| {err:.2e} (1e-4)")
    for g, r in LORA_GROUPED:
        for types in ((f32,) * 3, path_types):
            err = check_lora_grouped(torch, lk, lref, (11, 48, 56, g, r),
                                     types, cycle_idx(torch, 11, g), 1e-4, 1e-4)
            log(f"[kernel] lora_matmul_grouped grid G={g} r={r} {types}: "
                f"max|err| {err:.2e} (1e-4, idx -1..{g - 1})")
    # the three full-width path shapes: MMDiT grouped (3 requests x CFG 2 x
    # 4096 tokens; tenant A, tenant B, basic), text encoder grouped (3 x 333
    # tokens), single adapter at the MMDiT projection shape
    lora_path_err = {"grouped": 0.0, "single": 0.0}
    mmdit_groups = [0, 1, -1, 0, 1, -1]
    for name, shape, types, groups in (
            ("mmdit", (24576, 1536, 1536, 2, 8), path_types, mmdit_groups),
            ("text", (999, 4096, 4096, 2, 8), (f32,) * 3, [0, 1, -1])):
        atol = 2e-5 * math.sqrt(shape[1] / 64)
        idx = path_idx(torch, groups, shape[0] // len(groups))
        err = check_lora_grouped(torch, lk, lref, shape, types, idx, atol, 0.0)
        lora_path_err["grouped"] = max(lora_path_err["grouped"], err)
        log(f"[kernel] lora_matmul_grouped path {name} {shape}: max|err| "
            f"{err:.2e} <= {atol:.2e}")
    atol = 2e-5 * math.sqrt(1536 / 64)
    err = check_lora_single(torch, lk, lref, (24576, 1536, 1536, 8),
                            path_types, 0.7, atol, 0.0)
    lora_path_err["single"] = err
    log(f"[kernel] lora_matmul path (24576, 1536, 1536, 8): max|err| "
        f"{err:.2e} <= {atol:.2e}")
    # a row's base product must not depend on the other rows' adapters
    x, w, a, b = lora_inputs(torch, 24576, 1536, 1536, 16, path_types)
    idx = path_idx(torch, mmdit_groups, 4096)
    scales = torch.tensor([0.5, 0.75], device="cuda")
    mixed = lk.lora_matmul_grouped(x, w, a, b, idx, scales)
    none = lk.lora_matmul_grouped(x, w, a, b, torch.full_like(idx, -1), scales)
    if not torch.equal(mixed[idx < 0], none[idx < 0]):
        raise AssertionError("lora_matmul_grouped: an idx=-1 row changed with "
                             "the other rows' adapters")
    log("[kernel] lora_matmul_grouped: idx=-1 rows bit-identical to an "
        "all-idx=-1 batch")
    del x, w, a, b, mixed, none

    # int8 products: bit for bit on the JAX grid, with all-127 operands at
    # K = 16384 (127^2 * K in every element, near the top of int32) split
    # along K and not, on every route, and at the full-width path's shapes
    # (2 requests with CFG: 4 rows, 16384 image and 1332 text tokens; text
    # encoder 333 or 666 rows)
    quant_checked = set()
    for shape in QUANT_GRID:
        check_quant(torch, qk, qref, shape)
        quant_checked.add(shape)
        log(f"[kernel] quant_matmul grid {shape}: bit-identical")
    for shape in ((4, 16384, 8), (4096, 16384, 1152)):
        check_quant(torch, qk, qref, shape, fill=127)
        log(f"[kernel] quant_matmul all-127 {shape} "
            f"({quant_route(torch, qk, shape)}): bit-identical, "
            f"{127 * 127 * 16384} in every element")
    for shape in QUANT_ROUTES:
        check_quant(torch, qk, qref, shape)
        quant_checked.add(shape)
        log(f"[kernel] quant_matmul {shape} ({quant_route(torch, qk, shape)}): "
            f"bit-identical")
    d, ff, td = 1536, 6144, 4096
    quant_full = ([(4, d, 6 * d)]
                  + [(m, k, n) for m in (16384, 1332)
                     for k, n in ((d, d), (d, ff), (ff, d))]
                  + [(m, k, n) for m in (333, 666)
                     for k, n in ((td, td), (td, 4 * td), (4 * td, td))])
    for shape in quant_full:
        check_quant(torch, qk, qref, shape)
        quant_checked.add(shape)
        log(f"[kernel] quant_matmul path {shape} "
            f"({quant_route(torch, qk, shape)}): bit-identical")
    # the row quantization at every (M, K) the path quantizes, then the
    # edges; bit for bit
    rows_checked = set()
    for shape in sorted({(m, k) for m, k, _ in quant_full} | set(ROWS_EDGE)):
        check_rows(torch, qk, qref, shape)
        rows_checked.add(shape)
        log(f"[kernel] quantize_rows {shape}: bit-identical")
    rglru_err = 0.0
    for shape in RGLRU_GRID + RGLRU_WIDE + RGLRU_ODD:
        for long_memory in (False, True):
            err, f64 = check_rglru(torch, rk, rref, shape, long_memory)
            rglru_err = max(rglru_err, err)
            log(f"[kernel] rglru_scan {shape}"
                f"{' long memory' if long_memory else ''}: max|err| "
                f"{err:.2e} (atol=rtol=2e-5)" + (
                    "" if f64 is None else
                    f"; against float64: kernel {f64[0]:.2e}, plain "
                    f"{f64[1]:.2e} (atol=rtol={RGLRU_F64_TOL})")
                + "; bits repeat")

    # -------------------------------------------- 3. toy path, card vs CPU
    cpu_ms = ModelSet(SD3)
    gpu_ms = ModelSet(SD3)
    for name in ("text_enc", "backbone", "vae_dec"):
        getattr(gpu_ms, name).weights = getattr(cpu_ms, name).load("cpu")["params"]
    images = {}
    for dev, ms in (("cuda", gpu_ms), ("cpu", cpu_ms)):
        system = ServingSystem(n_executors=1, backend=LocalBackend(device=dev))
        system.register(make_basic_workflow("sd3", ms))
        req = system.submit("sd3:basic", inputs=dict(REQUESTS[0]), steps=STEPS)
        system.run()
        if req.status != "done":
            raise AssertionError(f"toy request on {dev}: {req.status}")
        images[dev] = image_of(system, req)
    if images["cuda"].device.type != "cuda":
        raise AssertionError("toy request on cuda produced a CPU image")
    toy_rel = rel(images["cuda"], images["cpu"])
    if not toy_rel < 1e-4:
        raise AssertionError(f"toy image card vs CPU: rel err {toy_rel}")
    log(f"[toy] sd3:basic card vs CPU image rel err {toy_rel:.2e} < 1e-4")

    toy_subs = [(n, {"seed": s, "prompt": "parity probe"}) for n, s in TOY_MIXED]
    mixed_imgs = {}
    adapter_weights = None
    for dev, ms in (("cpu", cpu_ms), ("cuda", gpu_ms)):
        system, adapters = lora_system(ms, dev)
        if adapter_weights is None:
            adapter_weights = {mid: p.load("cpu") for mid, p in adapters.items()}
        for mid, p in adapters.items():
            p.weights = adapter_weights[mid]
        reqs = serve(system, toy_subs, 3)
        if system.coordinator.backend.multilora_forwards <= 0:
            raise AssertionError(f"toy mix on {dev}: no multilora forward")
        mixed_imgs[dev] = [image_of(system, r) for r in reqs]
    for (name, _), got, want in zip(toy_subs, mixed_imgs["cuda"],
                                    mixed_imgs["cpu"]):
        e = rel(got, want)
        if got.device.type != "cuda" or not e < 1e-4:
            raise AssertionError(f"toy {name} card vs CPU: rel err {e}")
        log(f"[toy] {name} in the mixed batch, card vs CPU rel err {e:.2e} "
            f"< 1e-4")
    for i, (name, inp) in enumerate(toy_subs):
        system, adapters = lora_system(gpu_ms, "cuda", multilora=False)
        for mid, p in adapters.items():
            p.weights = adapter_weights[mid]
        solo = image_of(system, serve(system, [(name, inp)], 3)[0])
        d = float((mixed_imgs["cuda"][i] - solo).abs().max())
        if not d <= 2e-4:
            raise AssertionError(f"toy {name}: grouped vs folded solo {d}")
        log(f"[toy] {name} on the card: grouped vs folded solo max|diff| "
            f"{d:.2e} <= 2e-4")

    # toy sd3:basic under each quantized mode, card against CPU on the same
    # weights (each device quantizes them on load)
    for mode in ("int8", "fp8"):
        prev = set_quant_mode(mode)
        quant_imgs = {}
        try:
            for role, dev, tms in (("card", "cuda", gpu_ms),
                                   ("cpu", "cpu", cpu_ms)):
                system = ServingSystem(n_executors=1,
                                       backend=LocalBackend(device=dev))
                system.register(make_basic_workflow("sd3", tms))
                req = serve(system, [("sd3:basic", REQUESTS[0])], STEPS)[0]
                quant_imgs[role] = image_of(system, req)
        finally:
            set_quant_mode(prev)
        e = rel(quant_imgs["card"], images["cpu"])
        q_rel = rel(quant_imgs["card"], quant_imgs["cpu"])
        if not q_rel <= TOY_QUANT_REL[mode] or not e > 1e-3:
            raise AssertionError(f"toy {mode} card vs CPU rel err {q_rel} "
                                 f"(bound {TOY_QUANT_REL[mode]}); vs the CPU's "
                                 f"fp32 image {e}")
        log(f"[toy] sd3:basic {mode} card vs CPU image rel err {q_rel:.2e} <= "
            f"{TOY_QUANT_REL[mode]}; against the fp32 image {e:.2e}")

    # ------------------------------------------- 4. full-width basic path
    family = dataclasses.replace(SD3, toy=REAL["sd3"])
    cfg = family.toy
    ms = ModelSet(family)
    # one card is one executor: the coordinator's timeline then matches
    # what the card did, and the two requests share its batches
    system = ServingSystem(n_executors=1, backend=LocalBackend(device="cuda"))
    system.register(make_basic_workflow("sd3", ms))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    lk.lora_matmul.launches = lk.lora_matmul_grouped.launches = 0
    qk.quant_matmul.launches = qk.quantize_rows.launches = 0
    rk.rglru_scan.launches = 0
    t0 = time.perf_counter()
    reqs = [system.submit("sd3:basic", inputs=dict(inp), arrival=0.0,
                          steps=STEPS) for inp in REQUESTS]
    system.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    lora_on_basic = lk.lora_matmul.launches + lk.lora_matmul_grouped.launches
    others_on_basic = (qk.quant_matmul.launches + qk.quantize_rows.launches
                       + rk.rglru_scan.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    expected, path_shapes = expected_flash(system.coordinator.dispatch_log,
                                            family)
    fp32_images = []
    for req in reqs:
        if req.status != "done":
            raise AssertionError(f"full-width request {req.rid}: {req.status}")
        img = image_of(system, req)
        fp32_images.append(img)
        check_image(torch, img, card, f"request {req.rid}")
        log(f"[path] request {req.rid} done: latency {req.latency:.3f} s on "
            f"the coordinator's measured timeline; image {tuple(img.shape)} "
            f"range [{float(img.min()):.3f}, {float(img.max()):.3f}]  [{card}]")
    if launches < expected or expected == 0:
        raise AssertionError(f"flash_attention launched {launches} times on "
                             f"the main path, expected >= {expected}")
    if lora_on_basic or others_on_basic:
        raise AssertionError(f"the fp32 basic path launched a LoRA kernel "
                             f"{lora_on_basic} times, quant_matmul, "
                             f"quantize_rows or rglru_scan {others_on_basic} "
                             f"times")
    log(f"[path] 2 full-width sd3:basic requests, {STEPS} steps, wall "
        f"{wall_s:.2f} s (weights drawn on the card included), peak memory "
        f"{peak_gib:.2f} GiB, flash_attention launches {launches} "
        f"(expected {expected})  [{card}]")
    # the same requests through the plain attention route: the kernel's
    # 3xTF32 products must not move the served image
    prev_flash = set_flash_attention(False)
    try:
        before = fa.flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_attn = serve(system, [("sd3:basic", inp) for inp in REQUESTS],
                           STEPS)
        torch.cuda.synchronize()
        plain_attn_s = time.perf_counter() - t0
        if fa.flash_attention.launches != before:
            raise AssertionError("the plain attention route launched the "
                                 "flash-attention kernel")
    finally:
        set_flash_attention(prev_flash)
    for req, img in zip(plain_attn, fp32_images):
        e = rel(img, image_of(system, req))
        if not e < KERNEL_VS_PLAIN_REL:
            raise AssertionError(f"fp32 image through the kernel vs the plain "
                                 f"attention route: rel err {e}")
        log(f"[path] request {req.rid}: image through the kernel vs through "
            f"the plain attention route rel err {e:.3e} < "
            f"{KERNEL_VS_PLAIN_REL}, max|diff| "
            f"{float((img - image_of(system, req)).abs().max()):.3e}")
    log(f"[path] the plain attention route served the same 2 requests in "
        f"{plain_attn_s:.2f} s (weights loaded)  [{card}]")
    del plain_attn

    # --------------------------- 5. the basic path's own shapes, timed
    timings, errs = [], [path_err]
    shapes = sorted(path_shapes | {(48, 4429, 4429, 64), (4, 333, 333, 1024)},
                    key=lambda s: -s[0] * s[1] * s[2] * s[3])
    for shape in shapes:
        errs.append(check_attention(torch, fa, shape, False, None, f32, 2e-5))
        timings.append(time_attention(torch, fa, shape, f32))
        log_attention_time(timings[-1], shape, card)
    # the flash shapes held and timed so far; each later phase 5x takes
    # only those it adds
    basic_flash = frozenset(shapes)
    checked_flash = set(shapes)
    # ------------------------------------------- 6. where the time goes
    profile_path(torch, system, [("sd3:basic", inp) for inp in REQUESTS],
                 card, "sd3:basic", {"flash_attention": FLASH_KERNELS})
    del system, ms, reqs, img
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 4t. Table 2's SD3.5-Large and Flux workflows at REAL width (with
    # 6t, and 7t: S2, S5, S3 and S4 through the launcher)
    counters = (fa.flash_attention, lk.lora_matmul, lk.lora_matmul_grouped,
                qk.quant_matmul, qk.quantize_rows, rk.rglru_scan)
    log(f"[table2] device memory held before phase 4t: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t2 = table2_phase(torch, card, counters)
    # -------- 5t. each kernel at the shapes phase 4t gave it, held against
    # its plain version and timed (flash attention where phase 5 did not)
    fam_timings = []
    for shape, label in sorted(t2["flash"].items(),
                               key=lambda x: -math.prod(x[0])):
        if shape in checked_flash:
            continue
        checked_flash.add(shape)
        err = check_attention(torch, fa, shape, False, None, f32, 2e-5)
        errs.append(err)
        log(f"[kernel] {label} path {shape} float32: max|err| {err:.2e} "
            f"<= 2e-05")
        fam_timings.append({**time_attention(torch, fa, shape, f32),
                            "path": f"{label} (phase 4t)"})
        log_attention_time(fam_timings[-1], shape, card)
    t2_lora_times = []
    for label, spec in t2["lora"].items():
        _, m, k, n, g, r, types, groups = spec
        atol = 2e-5 * math.sqrt(k / 64)
        err = check_lora_grouped(torch, lk, lref, (m, k, n, g, r), types,
                                 path_idx(torch, groups, m // len(groups)),
                                 atol, 0.0)
        lora_path_err["grouped"] = max(lora_path_err["grouped"], err)
        log(f"[kernel] lora_matmul_grouped {label} ({m}, {k}, {n}, {g}, {r}): "
            f"max|err| {err:.2e} <= {atol:.2e}")
        timing, fma_ms = time_lora(torch, lk, lref, spec)
        t2_lora_times.append({**timing, "path": f"{label} (phase 4t)"})
        log_lora_time(t2_lora_times[-1], fma_ms, card)
    # the int8 products and the row quantization at the families' shapes,
    # bit for bit; timed where they are not the SD3 path's (phase 5q)
    t2_quant_times, t2_rows_times = [], []
    sd3_quant = set(quant_full)
    for shape, label in sorted(t2["quant"].items(),
                               key=lambda x: -math.prod(x[0])):
        if shape not in quant_checked:
            check_quant(torch, qk, qref, shape)
            quant_checked.add(shape)
            log(f"[kernel] quant_matmul {label} {shape} "
                f"({quant_route(torch, qk, shape)}): bit-identical")
        if shape not in sd3_quant:
            t2_quant_times.append({**time_quant(torch, qk, qref, shape),
                                   "path": f"{label} (phase 4t)"})
            log(f"[time] {json.dumps(t2_quant_times[-1])}  [{card}]")
    t2_rows = {}
    for (m, k, _), label in t2["quant"].items():
        t2_rows.setdefault((m, k), label)
    for shape, label in sorted(t2_rows.items(), key=lambda x: -math.prod(x[0])):
        if shape not in rows_checked:
            check_rows(torch, qk, qref, shape)
            rows_checked.add(shape)
            log(f"[kernel] quantize_rows {label} {shape}: bit-identical")
        if shape not in {(m, k) for m, k, _ in sd3_quant}:
            t2_rows_times.append({**time_rows(torch, qk, qref, shape),
                                  "path": f"{label} (phase 4t)"})
            log(f"[time] {json.dumps(t2_rows_times[-1])}  [{card}]")

    # -------------------------- 4q. full-width basic path under int8
    prev_mode = set_quant_mode("int8")
    real_rows = qops._quantize_rows
    try:
        ms = ModelSet(family)
        system = ServingSystem(n_executors=1,
                               backend=LocalBackend(device="cuda"))
        system.register(make_basic_workflow("sd3", ms))
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        fa.flash_attention.launches = 0
        lk.lora_matmul.launches = lk.lora_matmul_grouped.launches = 0
        qk.quant_matmul.launches = qk.quantize_rows.launches = 0
        rk.rglru_scan.launches = 0
        t0 = time.perf_counter()
        reqs = serve(system, [("sd3:basic", inp) for inp in REQUESTS], STEPS)
        torch.cuda.synchronize()
        q_wall_s = time.perf_counter() - t0
        q_launches = qk.quant_matmul.launches
        q_rows = qk.quantize_rows.launches
        q_flash = fa.flash_attention.launches
        q_others = (lk.lora_matmul.launches + lk.lora_matmul_grouped.launches
                    + rk.rglru_scan.launches)
        q_peak_gib = torch.cuda.max_memory_allocated() / 2**30
        q_log = system.coordinator.dispatch_log
        q_expected, q_shapes = quant_path(q_log, family)
        q_expected_flash, _ = expected_flash(q_log, family)
        segs = [d for d in q_log if d.model_id.startswith("segment:")]
        if (q_launches != q_expected or not segs
                or any(d.segment_steps != STEPS for d in segs)):
            raise AssertionError(
                f"quant_matmul launched {q_launches} times on the int8 path, "
                f"expected {q_expected} (1344 per {STEPS}-step segment "
                f"dispatch + 12 per text batch); dispatches "
                f"{[(d.model_id, len(d.nodes), d.segment_steps) for d in q_log]}")
        if q_rows != q_launches:
            raise AssertionError(f"quantize_rows launched {q_rows} times on "
                                 f"the int8 path, quant_matmul {q_launches}: "
                                 f"one quantization per product expected")
        if q_flash != q_expected_flash or q_others:
            raise AssertionError(f"int8 path: flash_attention {q_flash} "
                                 f"(expected {q_expected_flash}), other "
                                 f"kernels {q_others}")
        q_images = []
        for req, f32_img in zip(reqs, fp32_images):
            img = image_of(system, req)
            check_image(torch, img, card, f"int8 request {req.rid}")
            q_images.append(img)
            e = rel(img, f32_img)
            if not e < INT8_VS_FP32_REL:
                raise AssertionError(f"int8 image {req.rid} vs fp32: rel err "
                                     f"{e} >= {INT8_VS_FP32_REL}")
            log(f"[path-int8] request {req.rid} done: latency "
                f"{req.latency:.3f} s on the coordinator's measured timeline; "
                f"int8 vs fp32 image rel err {e:.3e} < {INT8_VS_FP32_REL}  "
                f"[{card}]")
        # phase 7p serves these requests again on the process plane
        kept_int8 = ([img.cpu() for img in q_images], batch_plan(q_log, reqs))
        log(f"[path-int8] 2 full-width sd3:basic requests under int8, {STEPS} "
            f"steps, wall {q_wall_s:.2f} s (weights drawn and quantized on the "
            f"card included), peak memory {q_peak_gib:.2f} GiB, quant_matmul "
            f"launches {q_launches} (expected {q_expected}: "
            f"{[(d.model_id, len(d.nodes), d.segment_steps) for d in q_log]}), "
            f"quantize_rows launches {q_rows}, flash_attention launches {q_flash} (expected "
            f"{q_expected_flash})  [{card}]")
        # the same two requests, with the script putting both plain versions
        # in the kernels' places (the package has no such switch)
        qops.quant_matmul = qref.quant_matmul_ref
        qops._quantize_rows = qref.quantize_rows_ref
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain_reqs = serve(system, [("sd3:basic", inp) for inp in REQUESTS],
                               STEPS)
            torch.cuda.synchronize()
            plain_wall_s = time.perf_counter() - t0
        finally:
            qops.quant_matmul = qk.quant_matmul
            qops._quantize_rows = real_rows
        for req, img in zip(plain_reqs, q_images):
            other = image_of(system, req)
            e = rel(img, other)
            if not torch.equal(img, other):
                raise AssertionError(f"int8 path, kernels vs plain route: not "
                                     f"bit-identical, rel err {e}")
            log(f"[path-int8] kernels vs plain route image rel err {e:.2e}, "
                f"bit-identical: True")
        log(f"[path-int8] the plain route served the same 2 requests in "
            f"{plain_wall_s:.2f} s (weights loaded)  [{card}]")

        # ------------------- 5q. the kernels at their shapes, timed
        q_times, q_err = [], 0.0
        for shape in sorted(q_shapes, key=lambda s: -s[0] * s[1] * s[2]):
            if shape not in quant_checked:
                q_err = max(q_err, check_quant(torch, qk, qref, shape))
                log(f"[kernel] quant_matmul served {shape}: bit-identical")
            q_times.append(time_quant(torch, qk, qref, shape))
            log(f"[time] {json.dumps(q_times[-1])}  [{card}]")
        rows_times = []
        for shape in sorted({(m, k) for m, k, _ in q_shapes},
                            key=lambda s: -s[0] * s[1]):
            if shape not in rows_checked:
                check_rows(torch, qk, qref, shape)
                log(f"[kernel] quantize_rows served {shape}: bit-identical")
            rows_times.append(time_rows(torch, qk, qref, shape))
            log(f"[time] {json.dumps(rows_times[-1])}  [{card}]")
        r_times = []
        for shape in RGLRU_WIDE:
            r_times.append(time_rglru(torch, rk, rref, shape))
            log(f"[time] {json.dumps(r_times[-1])}  [{card}]")

        # ---------------------------- 6q. where the time goes, int8
        profile_path(torch, system, [("sd3:basic", inp) for inp in REQUESTS],
                     card, "sd3:basic int8",
                     {"quant_matmul": QUANT_KERNELS,
                      "quantize_rows": ("quantize_rows_kernel",),
                      "flash_attention": FLASH_KERNELS})
    finally:
        set_quant_mode(prev_mode)
    if quant_mode() != prev_mode:
        raise AssertionError("the quant mode was not restored")
    del system, ms, reqs, plain_reqs, q_images, fp32_images, img, other
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------ 4b. full-width multi-tenant path
    ms = ModelSet(family)
    system, adapters = lora_system(ms, "cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    lk.lora_matmul.launches = lk.lora_matmul_grouped.launches = 0
    qk.quant_matmul.launches = qk.quantize_rows.launches = 0
    rk.rglru_scan.launches = 0
    t0 = time.perf_counter()
    reqs = serve(system, MIXED, STEPS)
    torch.cuda.synchronize()
    ml_wall_s = time.perf_counter() - t0
    ml_flash = fa.flash_attention.launches
    ml_grouped = lk.lora_matmul_grouped.launches
    ml_single = lk.lora_matmul.launches
    ml_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log_ml = system.coordinator.dispatch_log
    ml_segments = [d for d in log_ml
                   if d.multilora and d.model_id.startswith("segment:")]
    if not ml_segments:
        raise AssertionError("the mixed batch formed no multilora segment "
                             "dispatch: " + ", ".join(
                                 f"{d.model_id} x{len(d.nodes)}" for d in log_ml))
    want_grouped = sum(TARGETS * cfg.n_layers
                       * (d.segment_steps if d.model_id.startswith("segment:")
                          else 1) for d in log_ml if d.multilora)
    if ml_grouped < want_grouped:
        raise AssertionError(f"lora_matmul_grouped launched {ml_grouped} times "
                             f"on the LoRA path, expected >= {want_grouped}")
    if (ml_single or qk.quant_matmul.launches or qk.quantize_rows.launches
            or rk.rglru_scan.launches):
        raise AssertionError(f"on the fp32 LoRA path lora_matmul launched "
                             f"{ml_single} times (it has no serving path), "
                             f"quant_matmul {qk.quant_matmul.launches}, "
                             f"quantize_rows {qk.quantize_rows.launches}, "
                             f"rglru_scan {rk.rglru_scan.launches}")
    ml_expected_flash, ml_flash_shapes = expected_flash(log_ml, family)
    if ml_flash < ml_expected_flash:
        raise AssertionError(f"flash_attention launched {ml_flash} times on "
                             f"the LoRA path, expected >= {ml_expected_flash}")
    ml_images = {}
    for (name, _), req in zip(MIXED, reqs):
        img = image_of(system, req)
        check_image(torch, img, card, name)
        ml_images[name] = img
        log(f"[path-lora] {name} request {req.rid} done: latency "
            f"{req.latency:.3f} s on the coordinator's measured timeline; "
            f"range [{float(img.min()):.3f}, {float(img.max()):.3f}]  [{card}]")
    # phase 7p serves this batch again on the process plane
    kept_lora = ([ml_images[name].cpu() for name, _ in MIXED],
                 batch_plan(log_ml, reqs))
    ab = float((ml_images["sd3:lora:tenantA"]
                - ml_images["sd3:lora:tenantB"]).abs().max())
    if not ab > 1e-6:
        raise AssertionError(f"tenants A and B gave the same image ({ab})")
    lora_rows = sorted({2 * len(d.nodes) * cfg.image_tokens
                        for d in ml_segments}, reverse=True)
    log(f"[path-lora] 3 full-width requests (2 LoRA tenants + basic), "
        f"{STEPS} steps, wall {ml_wall_s:.2f} s (weights and adapters drawn "
        f"on the card included), peak memory {ml_peak_gib:.2f} GiB; "
        f"dispatches {[(d.model_id, len(d.nodes), d.segment_steps, d.multilora) for d in log_ml]}; "
        f"lora_matmul_grouped launches {ml_grouped} (expected {want_grouped}) "
        f"at M = {lora_rows}; flash_attention launches {ml_flash} (expected "
        f"{ml_expected_flash})  [{card}]")
    basic_inp = dict(MIXED[2][1])
    solo_basic = image_of(system, serve(system, [("sd3:basic", basic_inp)],
                                        STEPS)[0])
    e = rel(ml_images["sd3:basic"], solo_basic)
    if not e < 1e-4:
        raise AssertionError(f"basic request in the mixed batch vs alone: "
                             f"rel err {e}")
    log(f"[path-lora] the basic request in the mixed batch vs served alone: "
        f"rel err {e:.2e} < 1e-4")
    # tenant A against its folded solo run, and against its own inputs
    # served without its adapter (a dropped adapter) and with tenant B's (a
    # swapped one).  The fold rounds W + dW to bf16, so A differs from its
    # solo run by more than the toy bound; the gate sits between that
    # reading and the controls', and the controls must clear it.
    a_name, a_inp = MIXED[0]
    a_img = ml_images[a_name]
    readings = {}
    for label, name in (("its own adapter folded", a_name),
                        ("no adapter", "sd3:basic"),
                        ("tenant B's adapter", "sd3:lora:tenantB")):
        other = image_of(system, serve(system, [(name, a_inp)], STEPS)[0])
        readings[label] = rel(a_img, other)
        log(f"[path-lora] tenant A grouped vs its inputs served alone with "
            f"{label}: max|diff| {float((a_img - other).abs().max()):.3e}, "
            f"rel err {readings[label]:.3e}  [{card}]")
    own = readings["its own adapter folded"]
    controls = min(readings["no adapter"], readings["tenant B's adapter"])
    if not own < TENANT_FOLD_REL < controls:
        raise AssertionError(
            f"tenant A grouped vs folded solo {own:.3e}, nearest control "
            f"{controls:.3e}: the gate {TENANT_FOLD_REL} must lie between them")
    log(f"[path-lora] tenant A grouped vs folded solo rel err {own:.3e} < "
        f"{TENANT_FOLD_REL} < nearest control {controls:.3e}")

    # --------------------------- 4c. text encoder, grouped vs folded runs
    backend = system.coordinator.backend
    enc = ms.text_enc
    enc_comps, _ = backend.ensure_loaded(enc)
    ads = [adapters["lora:tenantA:sd3"], adapters["lora:tenantB:sd3"]]
    pcs = {p.model_id: backend.adapter_pool.get(p)[0] for p in ads}
    batch = [{"prompt": inp["prompt"], "_patches": ps}
             for (_, inp), ps in zip(MIXED, ([ads[0]], [ads[1]], []))]
    lk.lora_matmul_grouped.launches = 0
    got = enc.execute_batch_multilora(enc_comps, batch, pcs)
    torch.cuda.synchronize()
    text_launches = lk.lora_matmul_grouped.launches
    if got is None or text_launches != 1:
        raise AssertionError(f"text encoder grouped call: {text_launches} "
                             f"launches")
    for kw, out in zip(batch, got):
        solo = enc_comps
        for p in kw["_patches"]:
            solo = enc.fold_patches(enc_comps, [p], [pcs[p.model_id]])
        want = enc.execute(solo, prompt=kw["prompt"])["prompt_embeds"]
        e = rel(out["prompt_embeds"], want)
        if not e < 1e-4:
            raise AssertionError(f"text encoder grouped vs folded: {e}")
        log(f"[text-lora] {[p.model_id for p in kw['_patches']]} grouped vs "
            f"folded: rel err {e:.2e} < 1e-4")

    # ---------------------------------- 5b. the LoRA kernels, timed
    lora_specs = {"mmdit": (True, 24576, 1536, 1536, 2, 8, path_types,
                            mmdit_groups),
                  "text": (True, 999, 4096, 4096, 2, 8, (f32,) * 3, [0, 1, -1]),
                  "single": (False, 24576, 1536, 1536, 1, 8, path_types, None)}
    lora_times = {}
    for key, spec in lora_specs.items():
        lora_times[key], fma_ms = time_lora(torch, lk, lref, spec)
        log_lora_time(lora_times[key], fma_ms, card)
    for m in lora_rows:
        if m != 24576:        # a served batch of another size: check, time
            groups = mmdit_groups[:m // 4096]
            atol = 2e-5 * math.sqrt(1536 / 64)
            err = check_lora_grouped(torch, lk, lref, (m, 1536, 1536, 2, 8),
                                     path_types, path_idx(torch, groups, 4096),
                                     atol, 0.0)
            lora_path_err["grouped"] = max(lora_path_err["grouped"], err)
            log(f"[kernel] lora_matmul_grouped served M={m}: max|err| "
                f"{err:.2e} <= {atol:.2e}")
            spec = (True, m, 1536, 1536, 2, 8, path_types, groups)
            lora_times[f"mmdit-{m}"], fma_ms = time_lora(torch, lk, lref, spec)
            log_lora_time(lora_times[f"mmdit-{m}"], fma_ms, card)

    # ------------------------------------ 6b. where the time goes, LoRA
    profile_path(torch, system, MIXED, card, "mixed LoRA batch",
                 {"lora_matmul_grouped": LORA_KERNELS,
                  "flash_attention": FLASH_KERNELS})
    del (system, ms, adapters, reqs, ml_images, a_img, other, solo_basic, img,
         backend, enc, enc_comps, pcs, got, solo, want)
    gc.collect()
    torch.cuda.empty_cache()

    # -------------- 5c. flash attention at the LoRA path's own shapes
    ml_timings = []
    for shape in sorted(ml_flash_shapes - checked_flash,
                        key=lambda s: -s[0] * s[1] * s[2] * s[3]):
        checked_flash.add(shape)
        err = check_attention(torch, fa, shape, False, None, f32, 2e-5)
        errs.append(err)
        log(f"[kernel] LoRA path {shape} float32: max|err| {err:.2e} <= 2e-05")
        ml_timings.append({**time_attention(torch, fa, shape, f32),
                           "path": "mixed LoRA batch"})
        log_attention_time(ml_timings[-1], shape, card)

    # ------------------------- 4n. full-width ControlNet path, fp32
    cn_weights = controlnet_weights(family)
    refs = [ref_image(torch, seed, 8 * cfg.latent_size) for seed in REF_SEEDS]
    cn_subs = [(name, {**inp, "ref_image": img})
               for name, inp, img in zip(CN_NAMES, REQUESTS, refs)]
    system = cn_system(family, cn_weights)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    lk.lora_matmul.launches = lk.lora_matmul_grouped.launches = 0
    qk.quant_matmul.launches = qk.quantize_rows.launches = 0
    rk.rglru_scan.launches = 0
    t0 = time.perf_counter()
    reqs = serve(system, cn_subs, STEPS)
    torch.cuda.synchronize()
    cn_wall_s = time.perf_counter() - t0
    cn_flash = fa.flash_attention.launches
    cn_others = (lk.lora_matmul.launches + lk.lora_matmul_grouped.launches
                 + qk.quant_matmul.launches + qk.quantize_rows.launches
                 + rk.rglru_scan.launches)
    cn_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cn_log = system.coordinator.dispatch_log
    cn_dispatches = [(d.model_id, len(d.nodes), d.segment_steps) for d in cn_log]
    cn_expected_flash, cn_flash_shapes = expected_flash(cn_log, family)
    # each request's steps ran fused with its ControlNets, in one chunk or
    # several (the scheduler picks the chunk by its queue)
    cn_steps = {}
    for d in cn_log:
        if d.model_id.startswith("segment:"):
            cn_steps[d.model_id] = cn_steps.get(d.model_id, 0) + d.segment_steps
    want_steps = {"segment:backbone:sd3+controlnet1:sd3": STEPS,
                  "segment:backbone:sd3+controlnet1:sd3+controlnet2:sd3": STEPS}
    if cn_steps != want_steps:
        raise AssertionError(f"ControlNet path: segment steps {cn_steps}, "
                             f"expected {want_steps}; {cn_dispatches}")
    if cn_flash != cn_expected_flash or cn_others:
        raise AssertionError(f"ControlNet path: flash_attention launched "
                             f"{cn_flash} times, expected {cn_expected_flash} "
                             f"({cn_dispatches}); other kernels {cn_others}")
    cn_images = {}
    for (name, _), req in zip(cn_subs, reqs):
        img = image_of(system, req)
        check_image(torch, img, card, name)
        cn_images[name] = img
        log(f"[path-cn] {name} request {req.rid} done: latency "
            f"{req.latency:.3f} s on the coordinator's measured timeline; "
            f"image {tuple(img.shape)} range [{float(img.min()):.3f}, "
            f"{float(img.max()):.3f}]  [{card}]")
    errs_cn = check_invariants(system.coordinator)
    if errs_cn:
        raise AssertionError(f"ControlNet path invariants: {errs_cn}")
    log("[path-cn] check_invariants(coordinator): no violation")
    log(f"[path-cn] sd3:cn1 + sd3:cn2 at full width, {STEPS} steps, wall "
        f"{cn_wall_s:.2f} s (weights drawn on the card included), peak "
        f"memory {cn_peak_gib:.2f} GiB, dispatches {cn_dispatches}, "
        f"flash_attention launches {cn_flash} (expected {cn_expected_flash}: "
        f"{cfg.n_layers} per backbone batch step, {cn_layers(cfg)} per "
        f"ControlNet batch step, 2 per text batch)  [{card}]")
    # the same requests through the plain attention route
    prev_flash = set_flash_attention(False)
    try:
        before = fa.flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_reqs = serve(system, cn_subs, STEPS)
        torch.cuda.synchronize()
        cn_plain_s = time.perf_counter() - t0
        if fa.flash_attention.launches != before:
            raise AssertionError("the plain attention route launched the "
                                 "flash-attention kernel")
    finally:
        set_flash_attention(prev_flash)
    cn_plain_err = {}
    for (name, _), req in zip(cn_subs, plain_reqs):
        other = image_of(system, req)
        e = rel(cn_images[name], other)
        cn_plain_err[name] = e
        if not e < KERNEL_VS_PLAIN_REL:
            raise AssertionError(f"{name}: image through the kernel vs the "
                                 f"plain attention route: rel err {e}")
        log(f"[path-cn] {name}: image through the kernel vs through the plain "
            f"attention route rel err {e:.3e} < {KERNEL_VS_PLAIN_REL}, "
            f"max|diff| {float((cn_images[name] - other).abs().max()):.3e}")
    log(f"[path-cn] the plain attention route served the same 2 requests in "
        f"{cn_plain_s:.2f} s (weights loaded)  [{card}]")
    # two controls: the conditioning reaches the image (another reference
    # image), and the residuals do (the basic workflow, same seed and prompt)
    gate = CONTROL_FACTOR * max(cn_plain_err.values())
    alt = {**cn_subs[0][1],
           "ref_image": ref_image(torch, REF_SEEDS[0] + 1, 8 * cfg.latent_size)}
    for label, sub in (("another reference image", ("sd3:cn1", alt)),
                       ("the basic workflow", ("sd3:basic", REQUESTS[0]))):
        other = image_of(system, serve(system, [sub], STEPS)[0])
        e = rel(cn_images["sd3:cn1"], other)
        log(f"[path-cn] control, sd3:cn1 vs {label} (same seed and prompt): "
            f"rel err {e:.3e}, max|diff| "
            f"{float((cn_images['sd3:cn1'] - other).abs().max()):.3e}; must "
            f"exceed {CONTROL_FACTOR} x the kernel-vs-plain error = {gate:.3e}")
        if not e > gate:
            raise AssertionError(f"control {label}: {e} <= {gate}")
    del plain_reqs, other

    # -------- 5n. flash attention at the ControlNet path's own shapes
    cn_timings = []
    for shape in sorted(cn_flash_shapes - checked_flash,
                        key=lambda s: -s[0] * s[1] * s[2] * s[3]):
        checked_flash.add(shape)
        err = check_attention(torch, fa, shape, False, None, f32, 2e-5)
        errs.append(err)
        log(f"[kernel] ControlNet path {shape} float32: max|err| {err:.2e} "
            f"<= 2e-05")
        cn_timings.append({**time_attention(torch, fa, shape, f32),
                           "path": "ControlNet (sd3:cn1, sd3:cn2)"})
        log_attention_time(cn_timings[-1], shape, card)
    # the branch's own rows are a shape the basic path never gave (7t's S5
    # trace may have held and timed it first)
    if not cn_flash_shapes - basic_flash:
        raise AssertionError(f"the ControlNet path gave flash attention no "
                             f"shape beyond the basic path's: "
                             f"{sorted(cn_flash_shapes)}")

    # -------------------------- 4nq. the cn1 request under int8
    prev_mode = set_quant_mode("int8")
    try:
        q_system = cn_system(family, cn_weights)
        cn1_sub = [cn_subs[0]]
        torch.cuda.synchronize()
        fa.flash_attention.launches = 0
        lk.lora_matmul.launches = lk.lora_matmul_grouped.launches = 0
        qk.quant_matmul.launches = qk.quantize_rows.launches = 0
        rk.rglru_scan.launches = 0
        t0 = time.perf_counter()
        q_req = serve(q_system, cn1_sub, STEPS)[0]
        torch.cuda.synchronize()
        nq_wall_s = time.perf_counter() - t0
        nq_launches = qk.quant_matmul.launches
        nq_rows = qk.quantize_rows.launches
        nq_flash = fa.flash_attention.launches
        nq_others = (lk.lora_matmul.launches + lk.lora_matmul_grouped.launches
                     + rk.rglru_scan.launches)
        nq_log = q_system.coordinator.dispatch_log
        nq_expected, nq_shapes = quant_path(nq_log, family)
        nq_expected_flash, _ = expected_flash(nq_log, family)
        nq_dispatches = [(d.model_id, len(d.nodes), d.segment_steps)
                         for d in nq_log]
        if (nq_launches != nq_expected or nq_rows != nq_launches
                or nq_flash != nq_expected_flash or nq_others):
            raise AssertionError(
                f"int8 ControlNet path: quant_matmul {nq_launches} (expected "
                f"{nq_expected}), quantize_rows {nq_rows}, flash_attention "
                f"{nq_flash} (expected {nq_expected_flash}), other kernels "
                f"{nq_others}; dispatches {nq_dispatches}")
        nq_img = image_of(q_system, q_req)
        check_image(torch, nq_img, card, "int8 sd3:cn1")
        e = rel(nq_img, cn_images["sd3:cn1"])
        if not e < INT8_VS_FP32_REL:
            raise AssertionError(f"int8 sd3:cn1 vs fp32: rel err {e}")
        log(f"[path-cn-int8] sd3:cn1 under int8, {STEPS} steps, wall "
            f"{nq_wall_s:.2f} s (weights drawn and quantized on the card "
            f"included), quant_matmul launches {nq_launches} and "
            f"quantize_rows launches {nq_rows} (expected {nq_expected}: 2 "
            f"streams x 7 x ({cfg.n_layers} backbone + {cn_layers(cfg)} "
            f"ControlNet layers) x {STEPS} steps + 12 per text batch), "
            f"flash_attention launches {nq_flash} (expected "
            f"{nq_expected_flash}), dispatches {nq_dispatches}; int8 vs fp32 "
            f"image rel err {e:.3e} < {INT8_VS_FP32_REL}  [{card}]")
        qops.quant_matmul = qref.quant_matmul_ref
        qops._quantize_rows = qref.quantize_rows_ref
        try:
            plain_img = image_of(q_system, serve(q_system, cn1_sub, STEPS)[0])
        finally:
            qops.quant_matmul = qk.quant_matmul
            qops._quantize_rows = real_rows
        if not torch.equal(nq_img, plain_img):
            raise AssertionError(f"int8 sd3:cn1, kernels vs plain route: not "
                                 f"bit-identical, rel err {rel(nq_img, plain_img)}")
        log(f"[path-cn-int8] kernels vs plain route image rel err "
            f"{rel(nq_img, plain_img):.2e}, bit-identical: True")
        # every new (M, K, N) and (M, K): bit for bit, then timed as in 5q
        for shape in sorted(nq_shapes - q_shapes,
                            key=lambda s: -s[0] * s[1] * s[2]):
            if shape not in quant_checked:
                q_err = max(q_err, check_quant(torch, qk, qref, shape))
                quant_checked.add(shape)
                log(f"[kernel] quant_matmul ControlNet path {shape}: "
                    f"bit-identical")
            q_times.append({**time_quant(torch, qk, qref, shape),
                            "path": "ControlNet int8 (sd3:cn1)"})
            log(f"[time] {json.dumps(q_times[-1])}  [{card}]")
        q_rows_done = {(m, k) for m, k, _ in q_shapes}
        for shape in sorted({(m, k) for m, k, _ in nq_shapes} - q_rows_done,
                            key=lambda s: -s[0] * s[1]):
            if shape not in rows_checked:
                check_rows(torch, qk, qref, shape)
                rows_checked.add(shape)
                log(f"[kernel] quantize_rows ControlNet path {shape}: "
                    f"bit-identical")
            rows_times.append({**time_rows(torch, qk, qref, shape),
                               "path": "ControlNet int8 (sd3:cn1)"})
            log(f"[time] {json.dumps(rows_times[-1])}  [{card}]")
    finally:
        set_quant_mode(prev_mode)
    if quant_mode() != prev_mode:
        raise AssertionError("the quant mode was not restored")
    del q_system, q_req, nq_img, plain_img
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------- 6n. where the time goes, ControlNet fp32
    profile_path(torch, system, cn_subs, card, "sd3:cn1 + sd3:cn2",
                 {"flash_attention": FLASH_KERNELS, "convs": CONV_KERNELS,
                  "f32_gemms": GEMM_KERNELS})
    del system, reqs, cn_images, img
    gc.collect()
    torch.cuda.empty_cache()

    # ------------- 7l. a trace through the serving launcher, S1 at full width
    trace_shapes, trace_runs = trace_phase(
        torch, {"sd3": s1_model_set(family, cn_weights)}, card, counters)
    trace_shapes = trace_shapes["flash"]
    trace_flash = [run["launches"]["flash_attention"] for run in trace_runs]
    gc.collect()
    torch.cuda.empty_cache()

    # ---------- 5l. flash attention at the trace's own shapes
    trace_timings = []
    for shape in sorted(trace_shapes - checked_flash,
                        key=lambda s: -s[0] * s[1] * s[2] * s[3]):
        checked_flash.add(shape)
        err = check_attention(torch, fa, shape, False, None, f32, 2e-5)
        errs.append(err)
        log(f"[kernel] trace path {shape} float32: max|err| {err:.2e} "
            f"<= 2e-05")
        trace_timings.append({**time_attention(torch, fa, shape, f32),
                              "path": "S1 trace (phase 7l)"})
        log_attention_time(trace_timings[-1], shape, card)

    # ---------- 7p. the process plane at full width
    proc_phase(torch, family, card, counters,
               {"int8": kept_int8, "lora": kept_lora})
    del kept_int8, kept_lora
    gc.collect()
    torch.cuda.empty_cache()

    # ---------- 7s. the sharded plane over slots of the card
    shard_shapes, shard_flash, _ = sharded_phase(torch, family, cn_weights,
                                                 card, counters)
    del cn_weights

    # ---------- 5s. flash attention at the sharded plane's own shapes
    shard_timings = []
    seq_shape = (2 * cfg.n_heads,
                 cfg.text_tokens + cfg.image_tokens // max(SHARD_KS),
                 cfg.tokens, cfg.head_dim)
    new_shapes = sorted(shard_shapes - checked_flash,
                        key=lambda s: (s != seq_shape, -s[0] * s[1] * s[2] * s[3]))
    if seq_shape not in new_shapes:
        raise AssertionError(f"the sharded plane gave flash attention no "
                             f"{seq_shape}: {sorted(shard_shapes)}")
    for shape in new_shapes:
        err = check_attention(torch, fa, shape, False, None, f32, 2e-5)
        errs.append(err)
        log(f"[kernel] sharded path {shape} float32: max|err| {err:.2e} "
            f"<= 2e-05")
        shard_timings.append({**time_attention(torch, fa, shape, f32),
                              "path": "sharded plane (phase 7s)"})
        log_attention_time(shard_timings[-1], shape, card)

    # ---------- 8. the LLM families at full width, once the earlier systems
    # are freed: 8h recurrentgemma-2b, 8w whisper-tiny, 8d llama3-8b, 8z
    # the other configs at cut depth
    del shard_shapes
    free(torch)
    log(f"[llm] device memory held before phase 8: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    llm = llm_phase(torch, card, counters)
    # flash attention at whisper's encoder shape: against the plain version,
    # then timed as in phase 5
    llm_timings = []
    for shape in sorted(llm["flash_shapes"]):
        err = check_attention(torch, fa, shape, False, None, f32, 2e-5)
        errs.append(err)
        log(f"[kernel] whisper-tiny encoder {shape} float32: max|err| "
            f"{err:.2e} <= 2e-05")
        llm_timings.append({**time_attention(torch, fa, shape, f32),
                            "path": "whisper-tiny encoder (phase 8w)"})
        log_attention_time(llm_timings[-1], shape, card)
    # the scan at its served shape: phase 2 checked and timed it already
    served_scan = {"B=%d,T=%d,D=%d,float32" % s for s in llm["rglru_shapes"]}
    if not served_scan <= {t["shape"] for t in r_times}:
        raise AssertionError(f"rglru_scan served at {served_scan}, not timed")
    for t in r_times:
        if t["shape"] in served_scan:
            t["path"] = "recurrentgemma-2b prefill (phase 8h)"
    r_times.sort(key=lambda t: t["shape"] not in served_scan)
    log(f"[llm] summary {json.dumps(llm['runs'])}  [{card}]")

    # ---------- 9. training at full width, once phase 8's models are freed:
    # 9w whisper-tiny, 9h recurrentgemma-2b over 5 layers
    free(torch)
    log(f"[train] device memory held before phase 9: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    trained = train_phase(torch, card, counters + (fa.flash_attention_bwd,
                                                   rk.rglru_scan_bwd))
    train_launches = {tag: run["launches_total"]
                      for tag, run in trained["runs"].items()}

    # ---------- 10. the dry-run CLIs, started with the script
    finish_dryruns(dryruns, card)

    # the headline is the largest shape each path really launched
    served = max(path_shapes, key=lambda s: s[0] * s[1] * s[2] * s[3])
    main = timings[shapes.index(served)]

    def entry(name, source, replaces, launches, err, lead, others,
              by_path=None):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                **({"launches_by_path": by_path} if by_path else {}),
                "max_abs_err": err, "ms": lead["ms"],
                "plain_ms": lead["plain_ms"], "bound_ms": lead["bound_ms"],
                "bound_by": lead["bound_by"], "library_ms": lead["library_ms"],
                **({key: lead[key] for key in ("library", "queued_ms")
                    if key in lead}),
                "shape": lead["shape"], "other_shapes": others}

    lora_src = "src/repro_torch/kernels/lora_matmul/csrc/lora_matmul.cu"
    # phase 4t's launches of a kernel by run (7t's traces among them)
    def t2_launches(kernel):
        return {label: run["launches"][kernel]
                for label, run in t2["runs"].items()
                if kernel in run.get("launches", {})}

    lead_key = f"mmdit-{lora_rows[0]}" if lora_rows[0] != 24576 else "mmdit"
    kernels = [
        entry("flash_attention",
              "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:109", launches,
              max(errs), main,
              [t for t in timings if t is not main] + fam_timings
              + ml_timings + cn_timings + trace_timings + shard_timings
              + llm_timings,
              {"basic": launches, **t2_launches("flash_attention"),
               "basic int8": q_flash, "lora": ml_flash,
               "controlnet": cn_flash, "controlnet int8": nq_flash,
               "S1 trace, flags off": trace_flash[0],
               "S1 trace, flags on": trace_flash[1],
               "sharded": shard_flash,
               "whisper-tiny prefill": llm["runs"]["8w"]["flash_launches"],
               "whisper-tiny train, 3 steps":
                   train_launches["9w"]["flash_attention"]}),
        entry("flash_attention_bwd",
              "src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_bwd.cu",
              # no Pallas kernel: the JAX package's custom_vjp backward
              "src/repro/kernels/flash_attention/ops.py:42",
              train_launches["9w"]["flash_attention_bwd"],
              trained["timings"]["flash_attention_bwd"]["max_abs_err"],
              trained["timings"]["flash_attention_bwd"], [],
              {"whisper-tiny train, 3 steps":
                   train_launches["9w"]["flash_attention_bwd"]}),
        entry("lora_matmul_grouped", lora_src,
              "src/repro/kernels/lora_matmul/kernel.py:172", ml_grouped,
              lora_path_err["grouped"], lora_times[lead_key],
              [t for k, t in lora_times.items() if k not in (lead_key, "single")]
              + t2_lora_times,
              {"lora": ml_grouped, **t2_launches("lora_matmul_grouped"),
               **{f"{label}, text encoder (one direct call)": 1
                  for label in t2["runs"] if label.endswith("mixed LoRA")}}),
        entry("lora_matmul", lora_src,
              "src/repro/kernels/lora_matmul/kernel.py:133", 0,
              lora_path_err["single"], lora_times["single"], []),
        entry("quant_matmul",
              "src/repro_torch/kernels/quant_matmul/csrc/quant_matmul.cu",
              "src/repro/kernels/quant_matmul/kernel.py:68", q_launches,
              q_err, q_times[0], q_times[1:] + t2_quant_times,
              {"basic int8": q_launches, "controlnet int8": nq_launches,
               **t2_launches("quant_matmul")}),
        # not a Pallas kernel: the plain jnp quantization before it
        entry("quantize_rows",
              "src/repro_torch/kernels/quant_matmul/csrc/quantize_rows.cu",
              "src/repro/kernels/quant_matmul/ops.py:112", q_rows, 0.0,
              rows_times[0], rows_times[1:] + t2_rows_times,
              {"basic int8": q_rows, "controlnet int8": nq_rows,
               **t2_launches("quantize_rows")}),
        entry("rglru_scan",
              "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
              "src/repro/kernels/rglru_scan/kernel.py:61",
              llm["runs"]["8h"]["rglru_launches"], rglru_err,
              r_times[0], r_times[1:],
              {"recurrentgemma-2b prefill":
                   llm["runs"]["8h"]["rglru_launches"],
               "recurrentgemma-2b train, 3 steps, 5 layers":
                   train_launches["9h"]["rglru_scan"]}),
        entry("rglru_scan_bwd",
              "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
              # no Pallas kernel: the JAX package differentiates the oracle
              "src/repro/kernels/rglru_scan/ref.py:9",
              train_launches["9h"]["rglru_scan_bwd"],
              trained["timings"]["rglru_scan_bwd"]["max_abs_err"],
              trained["timings"]["rglru_scan_bwd"], [],
              {"recurrentgemma-2b train, 3 steps, 5 layers":
                   train_launches["9h"]["rglru_scan_bwd"]}),
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
