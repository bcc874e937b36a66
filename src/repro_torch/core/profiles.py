"""Per-model latency profiles (§5, "collected offline").

The paper's scheduler consumes stable offline estimates of data-fetch time,
model-loading time and inference time per (model, batch, parallelism).  On
real hardware these come from measurement; here they come from an *analytic
roofline model* over each model's :class:`~repro_torch.core.model.ModelCost` and a
:class:`HardwareSpec` — the same three-term structure (compute / memory /
collective) we use in the roofline analysis.  Measured profiles can be
plugged in via :meth:`ProfileStore.override`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.core.model import Model, ModelCost


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # bf16 FLOP/s per chip
    hbm_bw: float              # bytes/s
    hbm_capacity: float        # bytes
    ici_bw: float              # bytes/s per link (device<->device)
    host_load_bw: float        # bytes/s host->device (model loading)
    dcn_bw: float              # bytes/s per host, cross-pod
    dispatch_overhead: float   # s fixed per node execution
    transfer_latency: float    # s fixed per inter-device transfer
    remote_bw: float = 2e9     # bytes/s remote adapter storage (LoRA fetch)
    patch_swap_time: float = 0.05  # s to hot-patch adapter weights in HBM


# TPU v5e — the target chip for the roofline analysis (system prompt consts).
TPU_V5E = HardwareSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    hbm_capacity=16 * 2**30,
    ici_bw=50e9,
    host_load_bw=32e9,
    dcn_bw=25e9,
    dispatch_overhead=120e-6,
    transfer_latency=10e-6,
)

# H800-like — mirrors the paper's testbed for the serving simulation so that
# absolute latencies land in the paper's 2-20 s/request regime.
GPU_H800 = HardwareSpec(
    name="gpu-h800",
    peak_flops=990e12,
    hbm_bw=3.35e12,
    hbm_capacity=80 * 2**30,
    ici_bw=200e9,            # NVLink effective per-peer
    host_load_bw=25e9,       # PCIe gen5 effective
    dcn_bw=25e9,
    dispatch_overhead=100e-6,
    transfer_latency=10e-6,
)


# Roofline factors for quantized forwards on a QUANTIZABLE model's cost
# (REPRO_QUANT; identity when off).  int8 is w8a8: the MXU issues int8
# MACs at 2x the bf16 rate and the resident weights halve vs the bf16
# baseline the roofline prices.  fp8 here is weight-only storage (the
# matmul upcasts): residency halves, issue rate does not.
QUANT_COMPUTE_SCALE = {"off": 1.0, "int8": 0.5, "fp8": 1.0}
QUANT_PARAM_SCALE = {"off": 1.0, "int8": 0.5, "fp8": 0.5}


def _quant_mode() -> str:
    # core -> nn is a one-way import; read lazily so profile
    # construction never forces the flag module early
    from repro_torch.nn.layers import quant_mode

    return quant_mode()


class LatencyProfile:
    """Analytic (model × batch × parallelism) → seconds estimates."""

    def __init__(self, model_id: str, cost: ModelCost, hw: HardwareSpec) -> None:
        self.model_id = model_id
        self.cost = cost
        self.hw = hw
        self._eff_max_batch = None

    # Amdahl: fraction of a model call that latent/sequence parallelism
    # cannot split (embeddings, final projection, per-step barriers) —
    # yields the ~1.9x max speedup at k=2 the paper measures (Fig 10)
    SERIAL_FRACTION = 0.05

    # -------------------------------------------------------------- terms
    def _quant_scales(self) -> tuple:
        """(compute_scale, param_scale) under the active quant mode —
        identity for models whose weights never quantize (VAEs)."""
        if not self.cost.quantizable:
            return 1.0, 1.0
        mode = _quant_mode()
        return QUANT_COMPUTE_SCALE[mode], QUANT_PARAM_SCALE[mode]

    def compute_term(self, batch: int, k: int = 1) -> float:
        # MXU efficiency ~0.6 of peak for well-tiled matmuls
        cs, _ = self._quant_scales()
        t = (cs * batch * self.cost.flops_per_item) / (0.6 * self.hw.peak_flops)
        if k <= 1:
            return t
        return t * (self.SERIAL_FRACTION + (1 - self.SERIAL_FRACTION) / k)

    def memory_term(self, batch: int, k: int = 1) -> float:
        # latent parallelism replicates the weights on every participant
        # (CFG branches are data-parallel, not tensor-parallel)
        _, ps = self._quant_scales()
        bytes_moved = (ps * self.cost.param_bytes
                       + batch * self.cost.act_io_bytes / k)
        return bytes_moved / self.hw.hbm_bw

    def collective_term(self, batch: int, k: int = 1) -> float:
        if k <= 1:
            return 0.0
        # per-call scatter/gather of the activations across k peers
        sync_bytes = batch * self.cost.output_bytes * (k - 1) / k
        return sync_bytes / self.hw.ici_bw + self.hw.transfer_latency * 2

    # ------------------------------------------------------------ queries
    def infer_time(self, batch: int, k: int = 1,
                   steps: Optional[int] = None, adapters: int = 0) -> float:
        """Seconds for one call.  For segment models the per-step terms
        repeat ``steps`` times (weights re-stream from HBM and collectives
        re-synchronize every step) while the fixed dispatch overhead is
        paid ONCE — the analytic form of what segment fusion buys.
        ``steps=None`` means the model's full ``steps_per_call``.

        ``adapters`` is the count of DISTINCT LoRA adapters a mixed
        multi-tenant batch carries: the grouped unfolded forward adds the
        skinny per-rank matmuls for every row (a compute term scaled by
        the model's ``lora_rank``) and streams each resident adapter's
        A/B factors from HBM once per step (a memory term scaled by the
        adapter count) — the rank/adapter pricing the scheduler and
        admission controller use for multi-LoRA batches."""
        k = max(1, min(k, self.cost.max_parallelism))
        s = self.cost.steps_per_call if steps is None else max(1, int(steps))
        t = max(self.compute_term(batch, k), self.memory_term(batch, k))
        if adapters > 0:
            c = self.cost
            lora_flops = batch * c.lora_flops_per_rank * max(1, c.lora_rank)
            lora_bytes = adapters * c.lora_bytes_per_adapter
            t += (lora_flops / (0.6 * self.hw.peak_flops)
                  + lora_bytes / self.hw.hbm_bw)
        return s * (t + self.collective_term(batch, k)) + self.hw.dispatch_overhead

    def exposed_cost(self, full: float, overlap_window: float) -> float:
        """Price of an OVERLAPPED dispatch (REPRO_OVERLAP): ``full``
        seconds of work launched while the target executor still has
        ``overlap_window`` seconds of an in-flight denoise segment to
        run.  The hidden portion rides the segment window for free; only
        the exposed remainder extends the executor's occupancy — floored
        at the fixed dispatch overhead, which async dispatch never
        hides."""
        return max(self.hw.dispatch_overhead,
                   full - max(0.0, overlap_window))

    def exposed_infer_time(self, batch: int, k: int = 1,
                           steps: Optional[int] = None, adapters: int = 0,
                           overlap_window: float = 0.0) -> float:
        """:meth:`infer_time` priced at the exposed (non-overlapped)
        cost given ``overlap_window`` seconds of hiding — what the
        scheduler charges an overlapped decode placement."""
        return self.exposed_cost(
            self.infer_time(batch, k, steps=steps, adapters=adapters),
            overlap_window)

    def speedup(self, batch: int, k: int) -> float:
        return self.infer_time(batch, 1) / self.infer_time(batch, k)

    def load_time(self) -> float:
        if self.cost.param_bytes <= 0:
            return 0.0
        _, ps = self._quant_scales()
        return ps * self.cost.param_bytes / self.hw.host_load_bw + 0.01

    def fetch_time(self, nbytes: float, cross_pod: bool = False) -> float:
        bw = self.hw.dcn_bw if cross_pod else self.hw.ici_bw
        return nbytes / bw + self.hw.transfer_latency

    @property
    def max_batch(self) -> int:
        """PROFILED B_max (§5.1): largest batch whose throughput gain over
        sequential service is >=1.25x.  Compute-bound models (diffusion
        backbones) profile to B_max=1 — batching them multiplies latency
        with no throughput gain; memory-bound models (text encoders)
        profile to large batches."""
        if self._eff_max_batch is None:
            t1 = self.infer_time(1, 1)
            best = 1
            b = 2
            while b <= self.cost.max_batch:
                if self.infer_time(b, 1) <= 0.8 * b * t1:
                    best = b
                else:
                    break
                b *= 2
            self._eff_max_batch = best
        return self._eff_max_batch

    @property
    def max_parallelism(self) -> int:
        return self.cost.max_parallelism

    @property
    def param_bytes(self) -> float:
        """HBM footprint the executor's capacity accounting charges —
        quantized residency for quantizable models under REPRO_QUANT."""
        _, ps = self._quant_scales()
        return ps * self.cost.param_bytes


def node_segment_steps(node: Any) -> Optional[int]:
    """Total step count a segment NODE carries (its schedule length), or
    None for ordinary nodes.  Segment ops share a profile per model_id,
    but two workflows may fuse different step counts under it — per-node
    estimates must read the schedule off the node, not the profile."""
    if not getattr(node.op, "is_segment", False):
        return None
    return len(node.inputs.get("t_mid") or ()) or None


def node_infer_time(profiles: "ProfileStore", node: Any,
                    batch: int = 1, k: int = 1) -> float:
    """Analytic inference seconds for one workflow node (segment-aware).
    Patched nodes on multi-LoRA-capable models carry the unfolded
    grouped forward's rank/adapter term."""
    adapters = 0
    if getattr(node.op, "supports_multilora", False):
        adapters = len(getattr(node.op, "patches", []) or [])
    return profiles.profile_model(node.op).infer_time(
        batch, k, steps=node_segment_steps(node), adapters=adapters)


class ProfileStore:
    """Registry of latency profiles keyed by model_id."""

    def __init__(self, hw: HardwareSpec = GPU_H800) -> None:
        self.hw = hw
        self._profiles: Dict[str, LatencyProfile] = {}
        self._overrides: Dict[str, LatencyProfile] = {}

    def profile_model(self, model: Model) -> LatencyProfile:
        if model.model_id in self._overrides:
            return self._overrides[model.model_id]
        if model.model_id not in self._profiles:
            self._profiles[model.model_id] = LatencyProfile(
                model.model_id, model.cost(), self.hw
            )
        return self._profiles[model.model_id]

    def get(self, model_id: str) -> LatencyProfile:
        if model_id in self._overrides:
            return self._overrides[model_id]
        return self._profiles[model_id]

    def override(self, model_id: str, profile: LatencyProfile) -> None:
        """Install a measured profile in place of the analytic one."""
        self._overrides[model_id] = profile

    def known(self, model_id: str) -> bool:
        return model_id in self._profiles or model_id in self._overrides

    def transfer_time(self, nbytes: float, cross_pod: bool = False) -> float:
        bw = self.hw.dcn_bw if cross_pod else self.hw.ici_bw
        return nbytes / bw + self.hw.transfer_latency
