"""Where the MLP backward kernel's time goes: the kernel against builds of
itself that leave out part of its work.

    python -m poseidon_tpu_torch.ops.mlp_bwd_variants    # one CUDA card

``csrc/mlp_bwd.cu`` is built four times, with ``-DMLP_BWD_VARIANT`` 0 to 3
(``csrc/mlp_bwd.cuh`` says what each leaves out; 0 is the kernel itself),
into ``build/kernels/variants/``. At each ScOT-T/B/L batch-32 shape the
script calls each build on the same inputs, with the row splits of
``ops.mlp.bwd_splits``, and prints one JSON line: the profiler's device time
of the main kernel and of the whole call (with the reduce), mean of 20
calls. Build 0 must give the bits of ``ops.mlp.mlp_bwd``. The other builds'
outputs are wrong by design and are not used.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from . import _build
from .mlp import _BWD_SIGNATURES, bwd_splits, mlp_bwd

VARIANTS = {0: "kernel", 1: "dW CTAs without the u/dh/GELU recompute", 2: "dx CTAs only",
            3: "dW CTAs only"}
# (model, stage, M, C, F) at batch 32, 128x128, patch 4.
SHAPES = (("T", 0, 32768, 48, 192), ("B", 0, 32768, 96, 384), ("B", 1, 8192, 192, 768),
          ("L", 0, 32768, 192, 768), ("L", 1, 8192, 384, 1536))


def build_variants():
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in VARIANTS:
        out = out_dir / f"libmlp_bwd_v{v}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DMLP_BWD_VARIANT={v}", "-o", str(out),
               str(_build.CSRC / "mlp_bwd.cu")]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), out)
    libs = {}
    for v, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {v}:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.mlp_bwd.argtypes = list(_BWD_SIGNATURES["mlp_bwd"])
        lib.mlp_bwd.restype = ctypes.c_int
        libs[v] = lib
    return libs


def device_times(fn, iters: int = 20):
    """(main kernel, whole call) device ms of one call, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    main = total = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        total += us
        if "mlp_bwd_kernel" in e.key:
            main += us
    return main / 1e3 / iters, total / 1e3 / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("mlp_bwd_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    print(card)
    libs = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    for model, stage, m, c, f in SHAPES:
        def rand(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen) * scale).to(dev)

        x = rand(m, c).bfloat16()
        dy = rand(m, c, scale=0.1).bfloat16()
        w1 = rand(f, c, scale=c ** -0.5).bfloat16()
        w2 = rand(c, f, scale=f ** -0.5).bfloat16()
        b1 = rand(f, scale=0.1)
        r = bwd_splits(m, c, f)
        n_out = 2 * f * c + f + c
        dx = torch.empty_like(x)
        grads = torch.empty(n_out, dtype=torch.float32, device=dev)
        part = torch.empty((r, n_out), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call(lib):
            err = lib.mlp_bwd(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                              dy.data_ptr(), dx.data_ptr(), grads.data_ptr(), part.data_ptr(),
                              m, c, f, r, stream)
            if err != 0:
                raise RuntimeError(f"mlp_bwd variant launch failed: CUDA error {err}")

        call(libs[0])
        torch.cuda.synchronize()
        ref = mlp_bwd(x, w1, b1, w2, dy)
        same = bool(torch.equal(dx, ref[0]) and torch.equal(grads[:f * c].view(f, c), ref[1]))
        if not same:
            raise SystemExit(f"variant 0 differs from ops.mlp.mlp_bwd at {model} stage {stage}")
        row = {"model": model, "stage": stage, "M": m, "C": c, "F": f, "R": r,
               "variant0_bits_match_mlp_bwd": same, "card": card}
        for v, what in VARIANTS.items():
            kernel_ms, call_ms = device_times(lambda: call(libs[v]))
            row[f"v{v}"] = {"what": what, "kernel_device_ms": kernel_ms,
                            "call_device_ms": call_ms}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
