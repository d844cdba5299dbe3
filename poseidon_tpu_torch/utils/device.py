"""The card the port targets, and device selection for its entry points.

``H100`` holds the published peaks of one NVIDIA H100 SXM (NVIDIA's data
sheet, dense rates, 700 W): they are used only to state a kernel's bound,
the least time the card could take for the same work.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    name: str
    peak_bf16_flops: float   # dense tensor-core FLOP/s
    peak_fp32_flops: float   # fp32 FMA FLOP/s on the CUDA cores (no tensor cores)
    peak_tf32_flops: float   # dense tensor-core FLOP/s with tf32 operands
    hbm_bandwidth: float     # bytes/s
    smem_per_block: int      # bytes of shared memory a block may opt into
    num_sms: int


H100 = GPUSpec("NVIDIA H100 SXM", 989e12, 67e12, 495e12, 3.35e12, 232_448, 132)


def bound_ms(flops: float, nbytes: float, spec: GPUSpec = H100, fp32: bool = False,
             tf32x3: bool = False):
    """(least time in ms, "operations" or "bytes"): the larger of the time
    for ``flops`` at the peak rate of the instructions that do them (bf16
    tensor cores; with ``fp32`` the fp32 FMA rate; with ``tf32x3`` three
    tf32 tensor-core products a product, the fp32 split of the general
    attention kernels) and the memory time for ``nbytes``."""
    if tf32x3:
        t_ops = 3.0 * flops / spec.peak_tf32_flops
    else:
        t_ops = flops / (spec.peak_fp32_flops if fp32 else spec.peak_bf16_flops)
    t_mem = nbytes / spec.hbm_bandwidth
    if t_ops >= t_mem:
        return t_ops * 1e3, "operations"
    return t_mem * 1e3, "bytes"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or left as the default) and
    absent; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
