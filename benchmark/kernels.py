"""Device kernels by group, from their names in the profiler's trace. The
port's kernels carry the names of ``poseidon_tpu_torch/csrc``'s entry
kernels; the rest are PyTorch's, cuBLAS's, cuDNN's and NCCL's."""

from __future__ import annotations

from typing import Dict

# Checked in this order; a kernel matching none is "other" (PyTorch's
# elementwise, reduction and copy kernels).
GROUPS = (
    ("attention", ("window_attention_fwd_kernel", "attn_bwd_", "attn_general_")),
    ("mlp", ("mlp_fwd_kernel", "mlp_bwd_", "mlp_cln_", "mlp_general_", "tail_rows_kernel",
             "tail_prep", "tail_reduce")),
    ("nccl", ("nccl",)),
    ("optimizer", ("multi_tensor_apply",)),
    ("conv", ("conv_", "convolution", "depthwise", "cudnn", "fprop", "dgrad", "wgrad")),
    ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "cublas", "nvjet")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, patterns in GROUPS:
        if any(p in low for p in patterns):
            return group
    return "other"


def seconds_by_group(kernels: Dict[str, float]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, s in kernels.items():
        g = group_of(name)
        out[g] = out.get(g, 0.0) + s
    return out
