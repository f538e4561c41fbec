"""Roofline cost model + DVFS power model for the TPU-target benchmarks.

This container is CPU-only; TPU v5e is the target. Per DESIGN.md section 2,
all TPU-scale step times come from the three-term roofline —

    T(f) = max( T_compute / phi,  T_memory,  T_interconnect ),  phi = f/f_max

— and energy from  P(phi) = P_static + P_dyn * u * phi^3  (V proportional to
f cube law; HBM/ICI clocks are independent domains and do not scale, the
same assumption GPU DVFS studies make for SM-clock-only scaling).

The serving "accelerator" unit is a v5e-4 slice (4 chips): 64 GB HBM is the
natural TPU unit comparable to the paper's A100-40GB per-GPU setup, and we
keep the paper's 28 GB KV pool so the eviction cliff lands at the same
batch size. Documented hardware-adaptation decision (DESIGN.md section 2).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


# ----------------------------------------------------------------------
# hardware constants (TPU v5e + host, per assignment + public specs)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class ChipSpec:
    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bw: float = 819e9               # B/s per chip
    ici_bw_per_link: float = 50e9       # B/s per ICI link
    ici_links: int = 4
    hbm_gb: float = 16.0
    # power model (200 W-class chip): static + dynamic at full utilization
    p_static_w: float = 65.0
    p_dyn_w: float = 135.0
    # deep-sleep residual draw (rails down, HBM in self-refresh) — what a
    # scale-to-zero fleet pays instead of p_static_w; waking costs the
    # controller-configured wake latency, not extra energy beyond idle draw
    p_sleep_w: float = 5.0


@dataclass(frozen=True)
class HostSpec:
    pcie_bw: float = 16e9               # B/s device<->host (per direction)
    dram_bw: float = 100e9              # B/s host DRAM
    disk_read_bw: float = 3.0e9         # B/s NVMe (page cache bypassed)
    disk_write_bw: float = 2.0e9
    # active/idle power per component (RAPL-style constants, modeled)
    cpu_active_w: float = 150.0
    cpu_idle_w: float = 50.0
    dram_active_w: float = 25.0
    dram_idle_w: float = 8.0
    disk_active_w: float = 12.0
    disk_idle_w: float = 2.0
    # per-byte transfer energy (modeled; pJ/B)
    ici_pj_per_byte: float = 10.0
    pcie_pj_per_byte: float = 60.0
    dram_pj_per_byte: float = 20.0
    disk_nj_per_byte: float = 1.5


@dataclass(frozen=True)
class AcceleratorSpec:
    """One serving 'accelerator' = a v5e slice of ``chips`` chips."""
    chips: int = 4
    chip: ChipSpec = ChipSpec()
    kv_pool_gb: float = 28.0            # paper's per-GPU KV budget

    @property
    def peak_flops(self) -> float:
        return self.chips * self.chip.peak_flops

    @property
    def hbm_bw(self) -> float:
        return self.chips * self.chip.hbm_bw

    @property
    def hbm_gb(self) -> float:
        return self.chips * self.chip.hbm_gb

    @property
    def ici_bw(self) -> float:
        """Slice-to-slice interconnect bandwidth (the dis-ici path)."""
        return self.chip.ici_bw_per_link * self.chip.ici_links

    @property
    def p_static_w(self) -> float:
        return self.chips * self.chip.p_static_w

    @property
    def p_dyn_w(self) -> float:
        return self.chips * self.chip.p_dyn_w

    @property
    def p_sleep_w(self) -> float:
        return self.chips * self.chip.p_sleep_w


# frequency grid mirroring the paper's 0.36..1.26 GHz sweep of a 1.41 GHz
# part: phi = f/f_max in [0.26, 0.90] plus full speed.
DEFAULT_FREQ_GRID: Tuple[float, ...] = (
    0.26, 0.34, 0.42, 0.50, 0.58, 0.66, 0.74, 0.82, 0.90, 1.00)


# ----------------------------------------------------------------------
# model-derived step costs
# ----------------------------------------------------------------------
@dataclass
class StepCost:
    compute_s: float
    memory_s: float
    interconnect_s: float = 0.0

    def time(self, phi: float = 1.0) -> float:
        return max(self.compute_s / phi, self.memory_s, self.interconnect_s)

    def utilization(self, phi: float = 1.0) -> float:
        """Compute-unit busy fraction during the step (drives P_dyn)."""
        t = self.time(phi)
        return 0.0 if t <= 0 else min(1.0, (self.compute_s / phi) / t)


class CostModel:
    """Per-scheduler-step roofline costs for one accelerator."""

    def __init__(self, cfg: ModelConfig, acc: AcceleratorSpec = None,
                 host: HostSpec = None):
        self.cfg = cfg
        self.acc = acc or AcceleratorSpec()
        self.host = host or HostSpec()
        bytes_per_param = 2  # bf16 serving weights
        self.param_bytes_active = cfg.param_count(active_only=True) * \
            bytes_per_param
        self.flops_per_token = 2 * cfg.param_count(active_only=True)
        self.kv_bytes_per_token = cfg.kv_bytes_per_token()
        self.state_bytes = cfg.state_bytes()
        # attention flops per (token, context) pair: qk^T and pv
        hd = cfg.head_dim
        attn_layers = cfg.num_layers
        if cfg.family == "hybrid":
            attn_layers = cfg.num_layers // cfg.hybrid.shared_attn_every
        if cfg.family == "encdec":
            attn_layers = cfg.encdec.num_decoder_layers
        self.attn_flops_per_tok_ctx = (
            0 if cfg.family == "ssm" else 4 * attn_layers * cfg.num_heads * hd)

    # ------------------------------------------------------------------
    def prefill_cost(self, chunk_tokens: int, ctx_begin: int,
                     ctx_end: int) -> StepCost:
        """One prefill chunk of ``chunk_tokens`` tokens spanning absolute
        context [ctx_begin, ctx_end) of its sequence(s)."""
        flops = self.flops_per_token * chunk_tokens
        # causal attention over growing context: sum of ctx over the chunk
        avg_ctx = 0.5 * (ctx_begin + ctx_end)
        flops += self.attn_flops_per_tok_ctx * chunk_tokens * avg_ctx
        # weights stream once per step; KV written for each new token
        bytes_moved = (self.param_bytes_active
                       + self.kv_bytes_per_token * chunk_tokens)
        return StepCost(compute_s=flops / self.acc.peak_flops,
                        memory_s=bytes_moved / self.acc.hbm_bw)

    def prefill_step_cost(self, chunks) -> StepCost:
        """One fused scheduler step over ``chunks`` = [(tokens, c0, c1), ...]
        (vLLM-V1-style token-budget step possibly spanning sequences).
        Weights stream once for the fused step; attention/KV per chunk."""
        flops = 0.0
        kv_bytes = 0.0
        for tokens, c0, c1 in chunks:
            flops += self.flops_per_token * tokens
            flops += self.attn_flops_per_tok_ctx * tokens * 0.5 * (c0 + c1)
            kv_bytes += self.kv_bytes_per_token * tokens
        bytes_moved = self.param_bytes_active + kv_bytes
        return StepCost(compute_s=flops / self.acc.peak_flops,
                        memory_s=bytes_moved / self.acc.hbm_bw)

    def mixed_step_cost(self, chunks, batch: int,
                        total_ctx_tokens: int) -> StepCost:
        """One composed chunked-interleave step (repro.sched): prefill
        ``chunks`` = [(tokens, c0, c1), ...] fused with a decode step
        emitting one token for each of ``batch`` sequences whose
        contexts sum to ``total_ctx_tokens``. Compute adds; HBM traffic
        adds EXCEPT the weight stream, which both halves share — the
        whole point of piggybacking decode on a prefill step (Sarathi):
        the second weight read is subtracted back out."""
        p = self.prefill_step_cost(chunks)
        d = self.decode_cost(batch, total_ctx_tokens)
        dup_weights_s = self.param_bytes_active / self.acc.hbm_bw
        return StepCost(
            compute_s=p.compute_s + d.compute_s,
            memory_s=p.memory_s + d.memory_s - dup_weights_s)

    def decode_cost(self, batch: int, total_ctx_tokens: int) -> StepCost:
        """One decode step emitting 1 token for each of ``batch`` sequences
        whose context lengths sum to ``total_ctx_tokens``."""
        flops = self.flops_per_token * batch
        flops += self.attn_flops_per_tok_ctx * total_ctx_tokens
        bytes_moved = (self.param_bytes_active
                       + self.kv_bytes_per_token * total_ctx_tokens
                       + self.state_bytes * batch  # recurrent-state archs
                       + self.kv_bytes_per_token * batch)  # new-token write
        return StepCost(compute_s=flops / self.acc.peak_flops,
                        memory_s=bytes_moved / self.acc.hbm_bw)

    def decode_step_arrays(self, batch: int, ctx0_sum: int, k: int,
                           phi: float = 1.0
                           ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Per-step ``(dt, watts)`` arrays for ``k`` consecutive decode
        steps of a fixed ``batch`` whose context sum starts at
        ``ctx0_sum`` and grows by ``batch`` each step — the uniform run
        the coalescing fast stepper consumes (DESIGN.md section 13).

        Element ``i`` reproduces the scalar pipeline
        ``decode_cost(batch, ctx0_sum + i*batch)`` -> ``StepCost.time``
        / ``utilization`` -> ``power_w`` bit-for-bit: the flop/byte
        counts are exact integers that convert exactly to float64 below
        2**53, and every float op keeps the scalar expression's
        association. Returns ``None`` when that guarantee would not hold
        (astronomical contexts) so callers fall back to the exact
        stepper rather than drift."""
        ctx_max = ctx0_sum + (k - 1) * batch
        flops_max = self.flops_per_token * batch \
            + self.attn_flops_per_tok_ctx * ctx_max
        bytes_max = (self.param_bytes_active
                     + self.kv_bytes_per_token * ctx_max
                     + self.state_bytes * batch
                     + self.kv_bytes_per_token * batch)
        if max(flops_max, bytes_max) >= 2 ** 53:
            return None
        ctx = ctx0_sum + np.arange(k, dtype=np.int64) * batch
        flops = self.flops_per_token * batch \
            + self.attn_flops_per_tok_ctx * ctx
        bytes_moved = (self.param_bytes_active
                       + self.kv_bytes_per_token * ctx
                       + self.state_bytes * batch
                       + self.kv_bytes_per_token * batch)
        scaled = (flops / self.acc.peak_flops) / phi
        memory_s = bytes_moved / self.acc.hbm_bw
        dt = np.maximum(scaled, memory_s)       # interconnect term is 0
        util = np.minimum(1.0, scaled / dt)
        watts = self.acc.p_static_w + self.acc.p_dyn_w * util * phi ** 3
        return dt, watts

    # ------------------------------------------------------------------
    # first-order per-token rates: the signals online governors and the
    # min-energy router act on (full-precision projections would mean
    # simulating the future; these are roofline steady-states)
    # ------------------------------------------------------------------
    def prefill_rate_tok_s(self, phi: float = 1.0,
                           chunk: int = 8192) -> float:
        """Steady-state prefill throughput at ``phi``: one full
        ``chunk``-token scheduler step amortizing a single weight
        stream, context term at zero (optimistic for long prompts —
        callers carry a safety factor)."""
        c = self.prefill_step_cost([(chunk, 0, chunk)])
        return chunk / c.time(phi)

    def prefill_time_s(self, tokens: int, ctx_begin: int = 0,
                       phi: float = 1.0, chunk: int = 8192) -> float:
        """Latency to prefill ``tokens`` starting at absolute context
        ``ctx_begin``, chunked the way the engine actually schedules it
        (one weight stream per ``chunk``-token step, causal attention
        over the growing context) — the governor's TTFT projection."""
        t = 0.0
        pos = ctx_begin
        end = ctx_begin + tokens
        while pos < end:
            take = min(chunk, end - pos)
            t += self.prefill_step_cost([(take, pos, pos + take)]).time(phi)
            pos += take
        return t

    def joules_per_token(self, phi: float = 1.0, chunk: int = 8192,
                         ctx_tokens: int = 0) -> float:
        """Projected marginal joules per prefill-equivalent token at
        ``phi``: step power (static + utilization-scaled dynamic) over
        the steady-state token rate. Monotone pieces pull opposite ways
        — dynamic J/token grows ~phi^2, static J/token shrinks as 1/phi
        on compute-bound steps — which is exactly the U-curve the
        min-energy router and fig8 trade along."""
        c = self.prefill_step_cost([(chunk, ctx_tokens,
                                     ctx_tokens + chunk)])
        t = c.time(phi)
        return self.power_w(phi, c.utilization(phi)) * t / chunk

    # ------------------------------------------------------------------
    def kv_bytes(self, ctx_tokens: int) -> int:
        """Handoff payload for one sequence at context length ctx."""
        return self.kv_bytes_per_token * ctx_tokens + self.state_bytes

    # ------------------------------------------------------------------
    def power_w(self, phi: float, utilization: float) -> float:
        """Accelerator power at relative frequency phi and compute util."""
        return (self.acc.p_static_w
                + self.acc.p_dyn_w * utilization * phi ** 3)

    def idle_power_w(self) -> float:
        return self.acc.p_static_w

    def sleep_power_w(self) -> float:
        """Deep-sleep residual draw (fleet controller's scale-to-zero)."""
        return self.acc.p_sleep_w

    # ------------------------------------------------------------------
    def slice(self, frac: float) -> "CostModel":
        """An SM-partition slice of this accelerator (RAPID-Serve-style
        intra-GPU P/D disaggregation): compute, HBM bandwidth, and ALL
        power rails (static/dynamic/sleep) scale by ``frac``, so two
        complementary slices sum back to the whole accelerator's
        roofline and power envelope. Model-derived constants
        (``kv_bytes_per_token``, ``param_bytes_active``, ...) are
        cfg-derived and unchanged — KV pages are the same size on a
        slice, which is what lets the two slices share one pool."""
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"slice fraction must be in (0, 1], "
                             f"got {frac}")
        chip = self.acc.chip
        sliced = dataclasses.replace(
            chip,
            peak_flops=chip.peak_flops * frac,
            hbm_bw=chip.hbm_bw * frac,
            p_static_w=chip.p_static_w * frac,
            p_dyn_w=chip.p_dyn_w * frac,
            p_sleep_w=chip.p_sleep_w * frac)
        return CostModel(self.cfg,
                         dataclasses.replace(self.acc, chip=sliced),
                         self.host)
