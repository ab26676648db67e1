"""Hardware constants for the two platforms the port reasons about.

``FPGA_2012`` is the paper's experimental platform (Table 2 of Cong et
al. 2018), copied verbatim from the reference: ``core.costmodel``
evaluates the paper's analytic model on it, and its numbers stay the
model's, never the card's.

``H100_SXM`` is the card the port runs on, in the reference's
``TPU_V5E``'s place.  Every constant is a published data-sheet value
(NVIDIA's H100 SXM data sheet and the Hopper architecture white paper,
dense rates without sparsity, at the full 700 W power limit); a card set
to a lower limit runs slower under load.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GpuSpec:
    """One GPU and its link to the other cards of its host."""

    name: str
    sms: int                    # streaming multiprocessors
    smem_per_block: int         # bytes of shared memory one block may use
    hbm_bytes: int              # device memory
    hbm_bw: float               # bytes/s of device memory
    peak_bf16_flops: float      # FLOP/s, dense bf16 on the tensor cores
    peak_f32_flops: float       # FLOP/s, f32 FMAs outside the tensor cores
    link_bw: float              # bytes/s each way over NVLink


H100_SXM = GpuSpec(
    name="h100_sxm",
    sms=132,                     # data sheet
    # 227 KB of the SM's 256 KB, above 48 KB only as dynamic shared
    # memory after cudaFuncSetAttribute (CUDA programming guide, cc 9.0)
    smem_per_block=232_448,
    hbm_bytes=80 * 10**9,        # 80 GB HBM3
    hbm_bw=3.35e12,              # 3.35 TB/s
    peak_bf16_flops=989e12,      # 989 TFLOP/s bf16, dense
    peak_f32_flops=67e12,        # 67 TFLOP/s f32 on the CUDA cores
    link_bw=450e9,               # NVLink 900 GB/s total: 450 GB/s each way
)


@dataclasses.dataclass(frozen=True)
class FpgaSpec:
    """The paper's 2012 CPU-FPGA platform (Table 2 + §3 constants)."""

    name: str = "virtex7_sdaccel_2015_4"
    clock_hz: float = 200e6                  # FPGA fabric clock
    cpu_clock_hz: float = 1.9e9              # Xeon E5-2420
    dram_bw: float = 12.8e9                  # device DDR3-1600, bytes/s
    pcie_bw: float = 8e9                     # PCIe gen3 x8, bytes/s
    dram_init_cycles: int = 100              # per-burst initiation (~500 ns)
    bram_total_bytes: int = 4 * 1024**2      # usable for accelerators (~4 MB)
    bram_blocks: int = 3000                  # 18 Kb blocks on the fabric
    bram_block_bits: int = 18 * 1024
    bram_block_max_width: int = 36           # bits, single block
    axi_bus_bits: int = 512                  # max burst datapath width
    max_pe: int = 128                        # paper sweeps 1..128 PEs

    @property
    def cycle_s(self) -> float:
        return 1.0 / self.clock_hz

    def burst_time(self, payload_bytes: float, width_bits: int = 512) -> float:
        """Time for one DRAM burst: init overhead + streaming at bus width.

        The paper's model (§3.2): 100 cycles init + ~1 cycle per beat.
        A beat moves ``width_bits`` bits.
        """
        beats = payload_bytes * 8.0 / width_bits
        return (self.dram_init_cycles + beats) * self.cycle_s


FPGA_2012 = FpgaSpec()
