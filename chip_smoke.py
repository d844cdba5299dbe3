#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of poseidon-tpu on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, one JSON line each (any failure ends the run with a non-zero exit):

1. environment: versions, the card (nvidia-smi name and power limit on a
   line of its own), the nvcc build of every kernel from csrc/ (ptxas
   lines, and the registers, spills and shared memory of every
   instantiation of the attention and MLP kernels), TF32 off;
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, bf16, at every shape the ScOT-B batch-32 serving path gives it
   (and ScOT-L's and ScOT-T's, C = 48 and D = 16; the attention also at one
   7x7 window, T = 49), with kernel / plain / library times (CUDA events,
   median of 20 after warm-up; also the profiler's device time, mean of 10
   calls), the least time the card could take (bound) and, for the MLP, the
   GELU's floor on the fp32 lanes (alu_floor_ms, from the shape);
3. model: ScOT-B, 128x128, 4 channels, bf16, batch 32, seeded random
   weights, the attention's position bias, logit scales and q/v biases
   redrawn so that they differ by head and position, and the embedding and
   post-attention norm scales set to 1 so that the output depends on every
   attention pattern (see ``perturb_attention``); the kernel path
   ("pallas") against the plain path ("xla") on the same weights, its time,
   and its kernel launches (counts reset just before one forward, read just
   after);
4. profile: torch.profiler over one kernel-path forward (device busy time
   against the unprofiled forward time, the kernels that take the most);
5. rollout: autoregressive_rollout with ar_steps=4 on the same model,
   launches counted the same way;
6. backward kernels: each backward kernel against its plain version on the
   card, bf16, at every ScOT-B, ScOT-L and ScOT-T batch-32 shape (the
   attention's also at T = 49), with the max abs
   error and relative L2 of every output, kernel / plain / library times
   (the library time is the autograd backward of the forward's library
   call), the bound, and two calls on the same inputs compared bit for bit;
7. train: the ScOT-B train step (forward, pixel mask, grouped L1 loss,
   backward through the kernels, global-norm clip, grouped AdamW) at batch
   32 on the weights of phase 3: the kernel path's loss and gradients
   against the plain path's, every parameter with a finite gradient and the
   attention and MLP weights of every block with non-zero ones, launches
   per step (counts reset just before one step, read just after), six steps
   on one batch with a falling loss, step time and peak memory;
8. train profile: torch.profiler over one train step (device busy time
   against the unprofiled step time, busy time by group, top kernels);
9. fused-tail kernels: the block tail's forward and backward kernels (MLP +
   conditional LayerNorm + residual) against their plain versions at every
   ScOT-B, ScOT-L and ScOT-T batch-32 stage they serve, with a per-image scale and
   shift that differ by image and channel, times and bounds as in 2 and 6;
10. separate-q/k/v attention: the op ``poseidon_tpu_torch.ops.
   fused_window_attention`` forward and backward through autograd at every
   ScOT-B, ScOT-L and ScOT-T attention shape and T = 49 (nthd) and at one
   shape in each other
   layout, counts reset just before and read just after; then its two
   kernels against their plain versions at each shape, with times;
11. fused-tail model, train and train profile: phases 3, 7 and 8 under
   ``fused_block_tail=True`` (the post-MLP norm scales set to 1 as well, and
   its weights in the non-zero-gradient check), launches 64 attention and 32
   tail kernels per forward, 64/64/32/32 per step;
12. the unfused and fused-tail forward and train step timed in turns;
13. ScOT-T (head width 16 at every stage): phases 3 and 7 on its model
   ("model_T", "train_T"), launches one attention kernel per block and the
   MLP kernel at stages 0-1 (C = 48 and 96): 32/16 per forward, 32/32/16/16
   per step;
14. general kernels ("general_kernel"): the general attention and MLP
   kernels (wgmma; fp32 operands as 3xTF32) against their plain versions,
   forward and backward (two backward calls bit-identical), at every
   ScOT-B attention and MLP shape in fp32, ScOT-T's with heads (2, 4, 8,
   16) (D = 24) and mlp_ratio 3 (F = 144, 288) in bf16, ScOT-T's and
   ScOT-L's MLP in fp32 and a 24x24 window (T = 576) in bf16 and fp32; fp32
   held by relative L2 <= 1e-4, bf16 as the wgmma phases; times, library
   times and bounds as in 2 and 6 (fp32 at three tf32 products a product
   on the tensor cores);
15. ScOT-T in fp32 ("model_T_fp32", "train_T_fp32"; kernel path vs plain
   path relative L2 <= 1e-4, forward and gradients; every attention and MLP
   call on the general kernels: 32/16 per forward) and ScOT-T with heads
   (2, 4, 8, 16) and mlp_ratio 3 in bf16 ("model_T_odd", "train_T_odd"; the
   bf16 gates of 3 and 7; the general kernels again);
16. ScOT-B in fp32, the inference CLI's compute dtype ("model_B_fp32",
   "train_B_fp32", each with a profile): full width and depth, kernel path
   vs plain path relative L2 <= 1e-4, 64 general attention and 32 general
   MLP launches a forward, 64 / 64 and 32 / 32 a step; wall ms, device busy
   ms, idle share and the general attention and MLP kernels' device ms of
   one forward and one step;
17. general tail kernels ("general_cln_kernel"): the fused tail's general
   forward and backward kernels (``csrc/mlp_cln_general.cu``) against their
   plain versions at ScOT-B, ScOT-L and ScOT-T stages 0-1 in fp32 and
   ScOT-T's with mlp_ratio 3 (F = 144, 288) in bf16, batch 32 (two backward
   calls bit-identical); fp32 held by relative L2 <= 1e-4, bf16 as phase 9;
   times, library times and bounds as in 14;
18. ScOT-T in fp32 and ScOT-T with heads (2, 4, 8, 16) and mlp_ratio 3 in
   bf16 under ``fused_block_tail=True`` ("model_T_fp32_tail",
   "train_T_fp32_tail", "model_T_odd_tail", "train_T_odd_tail"; the gates
   of 15; the tail on its general kernels at stages 0-1);
19. ScOT-B in fp32 under ``fused_block_tail=True`` ("model_B_fp32_tail",
   "rollout_B_fp32_tail", "train_B_fp32_tail", each with the gates and the
   profile of 16, the rollout held to the plain path's too): 64 general
   attention and 32 general tail launches a forward and no MLP launch, 64 /
   64 and 32 / 32 a step; the step's gradient difference by parameter kind,
   beside the tail's plain versions and the unfused kernel path on the same
   weights (``tail_grad_witness``);
20. trainer: the port's Trainer on a synthetic CE-Gauss file (see
   ``phase_trainer``): ScOT-B train with mid-epoch checkpoints, evaluate,
   predict with two AR steps, and a resumed run held to the uninterrupted
   one bit for bit; steps/s beside the bare step, the loader's time, the
   device idle share, launches per step (64/64/32/32);
21. remat: the ScOT-B bf16 train step with hidden dropout and drop-path on
   (masks from a CUDA generator) under each gradient-checkpointing mode
   against the step without it: loss, gradients (relative L2 <= 1e-6) and
   the generator's end state; launches (128/64/64/32 under ``True``); step
   time and peak memory per mode (see ``phase_remat``);
22. cli_train: ``python -m poseidon_tpu_torch.train`` in process on a
   synthetic CE-Gauss directory (ScOT-B bf16, two epochs), then
   ``save_pretrained`` and the fine-tune onto a Poisson-Gauss directory
   with ``--replace_embedding_recovery``, and the same without the flag
   failing (see ``phase_cli_train``);
23. cli_inference: ``python -m poseidon_tpu_torch.inference`` in process
   on that run directory in fp32 (general kernels), every mode that reads
   one model, ``eval`` held to the plain path (see ``phase_cli_inference``);
24. intermediates: ``forward_with_intermediates`` and
   ``rollout_with_intermediates`` on ScOT-B fp32 (see
   ``phase_intermediates``);
25. data_parallel: the Trainer over a process group of worker copies of
   this script, DDP (and with two cards or more HSDP) held to one process
   (see ``phase_data_parallel``);
26. bench: ``python bench_torch.py`` in a subprocess, eager (ScOT-B b128
   and ScOT-L b64) and with ``BENCH_SCAN=10`` (a CUDA graph of the step),
   each JSON line checked and printed, then the graph's step held to the
   eager step at ScOT-B b32 (see ``phase_bench``);
27. the kernels line (with each kernel's launches in phases 21-23 and on
   rank 0 of phase 25); 28. the device line, last.

    python3 chip_smoke.py --phase data_parallel   # phase 25 alone
    python3 chip_smoke.py --phase bench           # phase 26 alone

runs one phase alone, after the cards' line and the build of the four
sources the bf16 step runs; with four cards the data parallel phase adds
the throughput and memory cells (``DP_CELLS``).

Exits non-zero without printing results when CUDA is absent.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

BATCH = 32
ITERS = 20
ATTN_TOL = 3e-2   # bf16 output, allclose atol = rtol: rounding-order flips only
MLP_TOL = 3e-2
MODEL_REL_TOL = 3e-2  # relative L2, kernel path vs plain path, bf16 end to end
SUM_REL_TOL = 1e-2    # backward outputs summed over rows or windows: relative L2
GRAD_REL_TOL = 5e-2   # relative L2 of the whole gradient, kernel path vs plain path
TRAIN_STEPS = 6


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; phase lines carry the seconds since the script began
    ("elapsed_s"), so that a run shows where its time goes."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_ms(fn, iters: int = 10, by_kernel: bool = False):
    """Device time of one call: torch.profiler's device-side kernel time over
    ``iters`` calls, divided by ``iters``. Unlike ``cuda_ms`` it leaves out
    the host's gaps between a call's launches (its wrapper, allocations).
    The profiler runs a warm-up cycle of ``iters`` calls before the recorded
    one: without it, it dropped some or all of a cycle's kernel records (run
    4 of PR 6). None when it recorded no device time. With ``by_kernel``,
    also the time of each kernel (by its name up to the template arguments)
    a call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    recorded = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: recorded.append(p.key_averages())) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    kernels = [e for e in recorded[0] if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("ProfilerStep")]
    total = sum(dev_us(e) for e in kernels)
    ms = total / 1e3 / iters if total > 0 else None
    if not by_kernel:
        return ms
    names = {}
    for e in kernels:
        name = e.key.replace("(anonymous namespace)", "").split("<")[0].split("(")[0]
        name = name.split("::")[-1].split(" ")[-1]
        names[name] = names.get(name, 0.0) + dev_us(e) / 1e3 / iters
    return ms, names


def dev_us(evt):
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def host_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median wall time of one call that ends in a synchronize."""
    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_environment(build, wa, mlp_op):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[torch.cuda.current_device()] if smi else ""
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    seconds = build.build()
    wall = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]
             for name in build.SOURCES}
    emit({"phase": "environment", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "csrc": str(build.CSRC), "build_dir": str(build.BUILD_DIR),
          "nvcc_seconds": seconds, "build_wall_s": wall,
          "ptxas": ptxas, "attention_kernels": wa.kernel_info(),
          "mlp_kernels": mlp_op.kernel_info(),
          "tf32": "off for matmul and cudnn (comparisons in full fp32/bf16)"})
    return card


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def attention_shapes(cfg, batch):
    """(tag, n_windows, T, heads, D, nW of bm) for every block kind of the
    model: per stage, unshifted and (where the stage shifts) shifted."""
    out = []
    for i in range(cfg.num_stages):
        res = cfg.stage_resolution(i)
        heads = cfg.num_heads[i]
        d = cfg.stage_dim(i) // heads
        for shifted in (False, True):
            window, shift = cfg.stage_window_and_shift(i, shifted)
            if shifted and not shift:
                continue
            nw_img = (res // window) ** 2
            out.append((f"stage{i}{'_shifted' if shift else ''}", batch * nw_img,
                        window * window, heads, d, nw_img if shift else 1, window, res, shift))
    return out


def attention_cases(pt):
    """(model, tag, n_windows, T, heads, D, nW, window, res, shift) of every
    attention block kind of ScOT-B, ScOT-L and ScOT-T (D = 16) at batch 32 on
    128x128 inputs, and one 7x7 window (T = 49, the config's default window
    size) at ScOT-B's stage-0 width, shifted, on a 28x28 token map ("W7")."""
    out = []
    for name in ("B", "L", "T"):
        cfg = pt.make_config(name, image_size=128, num_channels=4, num_out_channels=4)
        out += [(name, *geo) for geo in attention_shapes(cfg, BATCH)]
    out.append(("W7", "T49_shifted", BATCH * 16, 49, 3, 32, 16, 7, 28, 3))
    return out


def attention_case(attn_mod, n, t, heads, d, nw, window, res, shift, gen, dtype=torch.bfloat16):
    c = heads * d
    dev = "cuda"
    qkv = torch.randn(n, t, 3 * c, generator=gen).to(dev, dtype)
    qb = (0.1 * torch.randn(c, generator=gen)).to(dev)
    bias = 16.0 * torch.sigmoid(torch.randn(heads, t, t, generator=gen))
    if nw > 1:
        mask = torch.from_numpy(attn_mod.shifted_window_mask(res, res, window, shift))
        bm = bias[None] + 2.0 * mask[:, None]
    else:
        bm = bias[None]
    bm = bm.contiguous().to(dev)
    scale = torch.exp(torch.log(torch.tensor(10.0)) + 0.2 * torch.randn(heads, generator=gen)).to(dev)
    return qkv, qb, bm, scale


def split_qkv(qkv, qb, heads):
    """(N, T, H, D) q (with the q-bias added, rounded), k, v of a packed
    (N, T, 3C) qkv."""
    n, t, c3 = qkv.shape
    q, k, v = qkv.reshape(n, t, 3, heads, c3 // (3 * heads)).unbind(2)
    return q + qb.reshape(heads, -1).to(q.dtype), k, v


def attention_library_inputs(q, k, v, bm, scale):
    """(qs, kn, v, mask) for SDPA from (N, T, H, D) q, k, v: the queries
    normalised, scaled and rounded, the keys normalised and rounded, bm as a
    materialised mask."""
    n, t, heads, _ = q.shape
    q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    qs = (F.normalize(q.float(), dim=-1) * scale.reshape(heads, 1, 1)).to(q.dtype)
    kn = F.normalize(k.float(), dim=-1).to(k.dtype)
    nw = bm.shape[0]
    mask = bm.to(q.dtype).unsqueeze(0).expand(n // nw, nw, heads, t, t).reshape(n, heads, t, t)
    return qs, kn, v.contiguous(), mask


def attention_library_call(q, k, v, bm, scale):
    """One PyTorch call computing the same attention on pre-normalised
    inputs (timed only; the port never calls it)."""
    qs, kn, v, mask = attention_library_inputs(q, k, v, bm, scale)
    return lambda: F.scaled_dot_product_attention(qs, kn, v, attn_mask=mask, scale=1.0)


def attention_library_bwd(q, k, v, bm, scale, do):
    """The autograd backward of that call, for the same output cotangent,
    to its four inputs (timed only)."""
    leaves = [a.detach().requires_grad_() for a in attention_library_inputs(q, k, v, bm, scale)]
    out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=1.0)
    dor = do.reshape(q.shape).transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, dor, retain_graph=True)


def attention_bwd_bound(n, t, heads, d, nw, bound_ms, es=2):
    """Scores once (the probabilities are not stored), dp, dv, dq, dk: 10 T^2 D
    FLOPs a pair; qkv, do, bm, qb and scale read once, dqkv, dbm, dqb and
    dscale written once. ``es``: bytes an operand (4: fp32, whose products
    the general kernel issues as three tf32 ones, at the dense TF32 rate)."""
    c = heads * d
    flops = 10.0 * n * heads * t * t * d
    nbytes = (2 * n * t * 3 * c * es + n * t * c * es + 2 * nw * heads * t * t * 4
              + 2 * (c + heads) * 4)
    return bound_ms(flops, nbytes, tf32x3=es == 4)


def mlp_bwd_bound(m, c, f, bound_ms, es=2):
    """u (recomputed), dh, dx, dW1, dW2: 10 M C F FLOPs; x, dy, W1, W2, b1
    read once, dx, dW1, dW2, db1, db2 written once. ``es``: bytes an operand
    (4: fp32, whose products the general kernels issue as three tf32 ones,
    at the dense TF32 rate)."""
    nbytes = 3 * m * c * es + 2 * c * f * es + f * 4 + 2 * c * f * 4 + (f + c) * 4
    return bound_ms(10.0 * m * c * f, nbytes, tf32x3=es == 4)


# The MLP's second floor: the GELU (forward) or the GELU and its derivative
# (backward, the tail backward too) once on every hidden value of every row,
# as the function needs them, in fp32 lane operations counted from the
# sources (mlp_tile.cuh; the bias, the erf's 12 operations and its two SFU
# operations at four each, their quarter rate, the product and the bf16
# packing; the derivative shares the erf and the exponential), over the
# card's fp32 lanes: 132 SMs x 128 lanes x 1.98 GHz (H100 SXM boost clock).
# A floor of the function, not of the kernels: the backward's dx and dW CTAs
# each compute the GELU and its derivative, twice this work.
GELU_OPS = {"fwd": 20, "bwd": 25}
FP32_LANE_OPS = 132 * 128 * 1.98e9


def alu_floor_ms(m, f, kind):
    """Least time of the GELU work on the fp32 lanes (kind "fwd" or
    "bwd"); computed from the shape, not measured."""
    return m * f * GELU_OPS[kind] / FP32_LANE_OPS * 1e3


def compare(names, out, ref):
    """Max abs error and relative L2 of each output, kernel vs plain."""
    rows = {}
    for name, a, b in zip(names, out, ref):
        a, b = a.float(), b.float()
        rows[name] = {"max_abs_err": float((a - b).abs().max()),
                      "rel_l2": float((a - b).norm() / b.norm())}
    return rows


def backward_ok(errs, out, ref, again, tol, close=1):
    """The first ``close`` outputs (dqkv, dx, or dq, dk, dv) allclose
    atol = rtol = tol, the outputs summed over rows or windows by relative
    L2, all finite, and a second call bit-identical."""
    return (all(bool(((o.float() - r.float()).abs() <= tol + tol * r.float().abs()).all())
                for o, r in zip(out[:close], ref[:close]))
            and all(bool(torch.isfinite(o.float()).all()) for o in out)
            and all(torch.equal(x, y) for x, y in zip(out, again))
            and all(r["rel_l2"] <= SUM_REL_TOL for r in list(errs.values())[close:]))


def attention_bound(n, t, heads, d, nw, bound_ms, es=2):
    c = heads * d
    flops = 4.0 * n * heads * t * t * d
    nbytes = n * t * 3 * c * es + c * 4 + nw * heads * t * t * 4 + heads * 4 + n * t * c * es
    return bound_ms(flops, nbytes, tf32x3=es == 4)


def mlp_case(m, c, f, gen, dtype=torch.bfloat16):
    """x (M, C), w1 (F, C), w2 (C, F) in ``dtype`` (bf16 by default) and b1,
    b2 fp32 on the card."""
    x = torch.randn(m, c, generator=gen).to("cuda", dtype)
    w1 = (torch.randn(f, c, generator=gen) / math.sqrt(c)).to("cuda", dtype)
    w2 = (torch.randn(c, f, generator=gen) / math.sqrt(f)).to("cuda", dtype)
    b1 = (0.1 * torch.randn(f, generator=gen)).to("cuda")
    b2 = (0.1 * torch.randn(c, generator=gen)).to("cuda")
    return x, w1, b1, w2, b2


def mlp_shapes(cfg, batch, mlp_op):
    out = []
    for i in range(cfg.num_stages):
        c, l = cfg.stage_dim(i), cfg.stage_resolution(i) ** 2
        if mlp_op.use_mlp_kernel(c, l):
            out.append((f"stage{i}", batch * l, c, int(cfg.mlp_ratio * c)))
    return out


def phase_kernels(pt, wa, mlp_op, attn_mod, bound_ms, card):
    gen = torch.Generator().manual_seed(1)
    cfg_b = pt.make_config("B", image_size=128, num_channels=4, num_out_channels=4)
    cfg_l = pt.make_config("L", image_size=128, num_channels=4, num_out_channels=4)
    results = {"attention": [], "mlp": []}
    for model_name, tag, n, t, heads, d, nw, window, res, shift in attention_cases(pt):
        qkv, qb, bm, scale = attention_case(attn_mod, n, t, heads, d, nw, window,
                                            res, shift, gen)
        out = wa.window_attention(qkv, qb, bm, scale, heads)
        ref = wa.window_attention_plain(qkv, qb, bm, scale, heads)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        ok = bool(torch.isfinite(out.float()).all()) and bool(
            (err <= ATTN_TOL + ATTN_TOL * ref.float().abs()).all())
        bms, by = attention_bound(n, t, heads, d, nw, bound_ms)
        row = {"phase": "kernel", "kernel": "window_attention_fwd", "model": model_name,
               "shape": f"{tag}: windows={n} T={t} H={heads} D={d} nW={nw}",
               "max_abs_err": float(err.max()), "tol": f"allclose atol=rtol={ATTN_TOL}",
               "ok": ok,
               "kernel_ms": cuda_ms(lambda: wa.window_attention(qkv, qb, bm, scale, heads)),
               "plain_ms": cuda_ms(lambda: wa.window_attention_plain(qkv, qb, bm, scale, heads)),
               "library_ms": cuda_ms(attention_library_call(*split_qkv(qkv, qb, heads),
                                                            bm, scale)),
               "kernel_device_ms": device_ms(lambda: wa.window_attention(qkv, qb, bm, scale,
                                                                         heads)),
               "library_device_ms": device_ms(attention_library_call(
                   *split_qkv(qkv, qb, heads), bm, scale)),
               "bound_ms": bms, "bound_by": by, "card": card}
        emit(row)
        results["attention"].append(row)
        if not ok:
            raise SystemExit(f"window_attention kernel disagrees at {row['shape']}")
        del qkv, out, ref
    cfg_t = pt.make_config("T", image_size=128, num_channels=4, num_out_channels=4)
    for model_name, cfg in (("B", cfg_b), ("L", cfg_l), ("T", cfg_t)):
        for tag, m, c, f in mlp_shapes(cfg, BATCH, mlp_op):
            x, w1, b1, w2, b2 = mlp_case(m, c, f, gen)
            out = mlp_op.mlp(x, w1, b1, w2, b2)
            ref = mlp_op.mlp_plain(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            ok = bool(torch.isfinite(out.float()).all()) and bool(
                (err <= MLP_TOL + MLP_TOL * ref.float().abs()).all())
            b1b, b2b = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
            flops = 4.0 * m * c * f
            nbytes = 2 * m * c * 2 + 2 * c * f * 2 + (f + c) * 4
            bms, by = bound_ms(flops, nbytes)
            row = {"phase": "kernel", "kernel": "fused_mlp_fwd", "model": model_name,
                   "shape": f"{tag}: M={m} C={c} F={f}",
                   "max_abs_err": float(err.max()), "tol": f"allclose atol=rtol={MLP_TOL}",
                   "ok": ok,
                   "kernel_ms": cuda_ms(lambda: mlp_op.mlp(x, w1, b1, w2, b2)),
                   "plain_ms": cuda_ms(lambda: mlp_op.mlp_plain(x, w1, b1, w2, b2)),
                   "library_ms": cuda_ms(lambda: F.linear(F.gelu(F.linear(x, w1, b1b)), w2, b2b)),
                   "kernel_device_ms": device_ms(lambda: mlp_op.mlp(x, w1, b1, w2, b2)),
                   "library_device_ms": device_ms(
                       lambda: F.linear(F.gelu(F.linear(x, w1, b1b)), w2, b2b)),
                   "bound_ms": bms, "bound_by": by, "alu_floor_ms": alu_floor_ms(m, f, "fwd"),
                   "card": card}
            emit(row)
            results["mlp"].append(row)
            if not ok:
                raise SystemExit(f"mlp kernel disagrees at {row['shape']}")
    return results


def phase_bwd_kernels(pt, wa, mlp_op, attn_mod, bound_ms, card):
    gen = torch.Generator().manual_seed(4)
    results = {"attention": [], "mlp": []}
    for model_name, tag, n, t, heads, d, nw, window, res, shift in attention_cases(pt):
        qkv, qb, bm, scale = attention_case(attn_mod, n, t, heads, d, nw, window,
                                            res, shift, gen)
        do = torch.randn(n, t, heads * d, generator=gen).to("cuda", torch.bfloat16)
        args = (qkv, qb, bm, scale, heads, do)
        out = wa.window_attention_bwd(*args)
        again = wa.window_attention_bwd(*args)
        ref = wa.window_attention_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = compare(("dqkv", "dqb", "dbm", "dscale"), out, ref)
        ok = backward_ok(errs, out, ref, again, ATTN_TOL)
        bms, by = attention_bwd_bound(n, t, heads, d, nw, bound_ms)
        row = {"phase": "bwd_kernel", "kernel": "window_attention_bwd", "model": model_name,
               "shape": f"{tag}: windows={n} T={t} H={heads} D={d} nW={nw}",
               "groups": wa.bwd_groups(n, nw, heads, t), "errors": errs,
               "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
               "tol": f"dqkv allclose atol=rtol={ATTN_TOL}; dqb, dbm, dscale rel L2 <= "
                      f"{SUM_REL_TOL}; second call bit-identical", "ok": ok,
               "kernel_ms": cuda_ms(lambda: wa.window_attention_bwd(*args)),
               "plain_ms": cuda_ms(lambda: wa.window_attention_bwd_plain(*args)),
               "library_ms": cuda_ms(attention_library_bwd(*split_qkv(qkv, qb, heads),
                                                           bm, scale, do)),
               "kernel_device_ms": device_ms(lambda: wa.window_attention_bwd(*args)),
               "library_device_ms": device_ms(attention_library_bwd(
                   *split_qkv(qkv, qb, heads), bm, scale, do)),
               "bound_ms": bms, "bound_by": by, "card": card}
        emit(row)
        results["attention"].append(row)
        if not ok:
            raise SystemExit(f"window_attention_bwd kernel disagrees at {row['shape']}")
        del qkv, do, out, again, ref
    for model_name in ("B", "L", "T"):
        cfg = pt.make_config(model_name, image_size=128, num_channels=4, num_out_channels=4)
        for tag, m, c, f in mlp_shapes(cfg, BATCH, mlp_op):
            x, w1, b1, w2, b2 = mlp_case(m, c, f, gen)
            dy = torch.randn(m, c, generator=gen).to("cuda", torch.bfloat16)
            args = (x, w1, b1, w2, dy)
            out = mlp_op.mlp_bwd(*args)
            again = mlp_op.mlp_bwd(*args)
            ref = mlp_op.mlp_bwd_plain(*args)
            torch.cuda.synchronize()
            errs = compare(("dx", "dw1", "db1", "dw2", "db2"), out, ref)
            ok = backward_ok(errs, out, ref, again, MLP_TOL)
            leaves = [a.detach().requires_grad_() for a in (x, w1, b1.to(torch.bfloat16), w2,
                                                            b2.to(torch.bfloat16))]
            lib_out = F.linear(F.gelu(F.linear(leaves[0], leaves[1], leaves[2])), leaves[3], leaves[4])
            bms, by = mlp_bwd_bound(m, c, f, bound_ms)
            row = {"phase": "bwd_kernel", "kernel": "fused_mlp_bwd", "model": model_name,
                   "shape": f"{tag}: M={m} C={c} F={f}",
                   "splits": mlp_op.bwd_splits(m, c, f), "errors": errs,
                   "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                   "tol": f"dx allclose atol=rtol={MLP_TOL}; dw1, db1, dw2, db2 rel L2 <= "
                          f"{SUM_REL_TOL}; second call bit-identical", "ok": ok,
                   "kernel_ms": cuda_ms(lambda: mlp_op.mlp_bwd(*args)),
                   "plain_ms": cuda_ms(lambda: mlp_op.mlp_bwd_plain(*args)),
                   "library_ms": cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, dy,
                                                                     retain_graph=True)),
                   "kernel_device_ms": device_ms(lambda: mlp_op.mlp_bwd(*args)),
                   "library_device_ms": device_ms(lambda: torch.autograd.grad(
                       lib_out, leaves, dy, retain_graph=True)),
                   "bound_ms": bms, "bound_by": by, "alu_floor_ms": alu_floor_ms(m, f, "bwd"),
                   "card": card}
            emit(row)
            results["mlp"].append(row)
            if not ok:
                raise SystemExit(f"mlp_bwd kernel disagrees at {row['shape']}")
            del x, dy, out, again, ref, lib_out, leaves
    return results


# ---------------------------------------------------------------------------
# The fused block tail's kernels, and the separate-q/k/v attention op
# ---------------------------------------------------------------------------

def cln_shapes(cfg, batch, mlp_op):
    """(tag, B, L, C, F) of every stage whose blocks take the fused tail."""
    out = []
    for i in range(cfg.num_stages):
        c, l = cfg.stage_dim(i), cfg.stage_resolution(i) ** 2
        if mlp_op.use_fused_tail(c, l):
            out.append((f"stage{i}", batch, l, c, int(cfg.mlp_ratio * c)))
    return out


def cln_case(b, l, c, f, gen, dtype=torch.bfloat16):
    """mlp_case's operands with x as (B, L, C), and a per-image scale and
    shift that differ by image and channel (a tile that read another image's
    row would disagree)."""
    x, w1, b1, w2, b2 = mlp_case(b * l, c, f, gen, dtype)
    scale = (1.0 + 0.5 * torch.randn(b, c, generator=gen)).to("cuda")
    shift = (0.5 * torch.randn(b, c, generator=gen)).to("cuda")
    return x.view(b, l, c), w1, b1, w2, b2, scale, shift


def cln_library_inputs(x, w1, b1, w2, b2, scale, shift):
    dt = x.dtype
    return x, w1, b1.to(dt), w2, b2.to(dt), scale.to(dt)[:, None], shift.to(dt)[:, None]


def cln_library_call(x, w1, b1, w2, b2, s, sh, eps):
    """PyTorch's calls for the fused tail: F.linear -> F.gelu -> F.linear ->
    F.layer_norm, the per-image affine and the residual (timed only)."""
    o = F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)
    return x + F.layer_norm(o, (o.shape[-1],), eps=eps) * s + sh


def cln_bound(b, l, c, f, bound_ms, backward=False, es=2):
    """Forward: 4 M C F FLOPs; x and W1, W2 (``es`` bytes a value), b1, b2,
    scale, shift read once, out written once. Backward: 12 M C F FLOPs (o
    recomputed, then u, dh, dx, dW1, dW2); x, dy, W1, W2, b1, b2, scale read
    once, dx and dW1, dW2, db1, db2, dscale, dshift (fp32) written once.
    ``es`` 4: fp32 operands, whose products the general kernels issue as
    three tf32 ones, at the dense TF32 rate."""
    m = b * l
    if not backward:
        return bound_ms(4.0 * m * c * f, 2 * m * c * es + 2 * c * f * es + (f + c + 2 * b * c) * 4,
                        tf32x3=es == 4)
    return bound_ms(12.0 * m * c * f, 3 * m * c * es + 2 * c * f * es + 2 * c * f * 4
                    + (f + c + b * c) * 4 + (f + c + 2 * b * c) * 4, tf32x3=es == 4)


def phase_cln_kernels(pt, mlp_op, bound_ms, card):
    """The fused tail's forward and backward kernels against their plain
    versions at every ScOT-B and ScOT-L batch-32 stage they serve."""
    gen = torch.Generator().manual_seed(7)
    eps = 1e-5
    results = {"fwd": [], "bwd": []}
    for model_name in ("B", "L", "T"):
        cfg = pt.make_config(model_name, image_size=128, num_channels=4, num_out_channels=4)
        for tag, b, l, c, f in cln_shapes(cfg, BATCH, mlp_op):
            x, w1, b1, w2, b2, scale, shift = cln_case(b, l, c, f, gen)
            dy = torch.randn(b, l, c, generator=gen).to("cuda", torch.bfloat16)
            shape = f"{tag}: B={b} L={l} C={c} F={f}"
            fargs = (x, w1, b1, w2, b2, scale, shift, eps)
            out = mlp_op.mlp_cln(*fargs)
            ref = mlp_op.mlp_cln_plain(*fargs)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            ok = bool(torch.isfinite(out.float()).all()) and bool(
                (err <= MLP_TOL + MLP_TOL * ref.float().abs()).all())
            lib_in = cln_library_inputs(x, w1, b1, w2, b2, scale, shift)
            bms, by = cln_bound(b, l, c, f, bound_ms)
            row = {"phase": "cln_kernel", "kernel": "mlp_cln_fwd", "model": model_name,
                   "shape": shape, "max_abs_err": float(err.max()),
                   "tol": f"allclose atol=rtol={MLP_TOL}", "ok": ok,
                   "kernel_ms": cuda_ms(lambda: mlp_op.mlp_cln(*fargs)),
                   "plain_ms": cuda_ms(lambda: mlp_op.mlp_cln_plain(*fargs)),
                   "library_ms": cuda_ms(lambda: cln_library_call(*lib_in, eps)),
                   "kernel_device_ms": device_ms(lambda: mlp_op.mlp_cln(*fargs)),
                   "library_device_ms": device_ms(lambda: cln_library_call(*lib_in, eps)),
                   "bound_ms": bms, "bound_by": by, "alu_floor_ms": alu_floor_ms(b * l, f, "fwd"),
                   "card": card}
            emit(row)
            results["fwd"].append(row)
            if not ok:
                raise SystemExit(f"mlp_cln kernel disagrees at {shape}")
            bargs = (x, w1, b1, w2, b2, scale, eps, dy)
            out = mlp_op.mlp_cln_bwd(*bargs)
            again = mlp_op.mlp_cln_bwd(*bargs)
            ref = mlp_op.mlp_cln_bwd_plain(*bargs)
            torch.cuda.synchronize()
            errs = compare(("dx", "dw1", "db1", "dw2", "db2", "dscale", "dshift"), out, ref)
            ok = backward_ok(errs, out, ref, again, MLP_TOL)
            leaves = [a.detach().requires_grad_() for a in lib_in]
            lib_out = cln_library_call(*leaves, eps)
            bms, by = cln_bound(b, l, c, f, bound_ms, backward=True)
            row = {"phase": "cln_kernel", "kernel": "mlp_cln_bwd", "model": model_name,
                   "shape": shape, "splits": mlp_op.bwd_splits(b * l, c, f),
                   "errors": errs, "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                   "tol": f"dx allclose atol=rtol={MLP_TOL}; the weight, bias, scale and "
                          f"shift gradients rel L2 <= {SUM_REL_TOL}; second call "
                          f"bit-identical", "ok": ok,
                   "kernel_ms": cuda_ms(lambda: mlp_op.mlp_cln_bwd(*bargs)),
                   "plain_ms": cuda_ms(lambda: mlp_op.mlp_cln_bwd_plain(*bargs)),
                   "library_ms": cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, dy,
                                                                     retain_graph=True)),
                   "kernel_device_ms": device_ms(lambda: mlp_op.mlp_cln_bwd(*bargs)),
                   "library_device_ms": device_ms(lambda: torch.autograd.grad(
                       lib_out, leaves, dy, retain_graph=True)),
                   "bound_ms": bms, "bound_by": by,
                   "alu_floor_ms": alu_floor_ms(b * l, f, "bwd"), "card": card}
            emit(row)
            results["bwd"].append(row)
            if not ok:
                raise SystemExit(f"mlp_cln_bwd kernel disagrees at {shape}")
            del x, dy, out, again, ref, lib_out, leaves, lib_in
    return results


def op_case(attn_mod, n, t, heads, d, nw, window, res, shift, gen):
    """Separate (N, T, H, D) bf16 q, k, v and output cotangent, the (H, T, T)
    position bias, the doubled (nW, T, T) shift mask (zeros, nW = 1, when
    unshifted) and the logit scales, on the card."""
    dev = "cuda"
    q, k, v, do = (torch.randn(n, t, heads, d, generator=gen).to(dev, torch.bfloat16)
                   for _ in range(4))
    bias = (16.0 * torch.sigmoid(torch.randn(heads, t, t, generator=gen))).to(dev)
    if nw > 1:
        mask = 2.0 * torch.from_numpy(attn_mod.shifted_window_mask(res, res, window, shift)).to(dev)
    else:
        mask = torch.zeros(1, t, t, device=dev)
    scale = torch.exp(torch.log(torch.tensor(10.0)) + 0.2 * torch.randn(heads, generator=gen)).to(dev)
    return q, k, v, do, bias, mask, scale


def to_layout(x, layout, pack):
    """(N, T, H, D) into one of the op's layouts; ``pack`` heads packed per
    row for nhdt_packed."""
    if layout == "nthd":
        return x
    if layout == "nhtd":
        return x.permute(0, 2, 1, 3).contiguous()
    if layout == "nhdt":
        return x.permute(0, 2, 3, 1).contiguous()
    n, t, h, d = x.shape
    return (x.reshape(n, t, h // pack, pack, d).permute(0, 2, 4, 3, 1)
            .reshape(n, h // pack, d, pack * t).contiguous())


def phase_fused_attention(pt, wa, attn_mod, bound_ms, card):
    """The separate-q/k/v op ``poseidon_tpu_torch.ops.fused_window_attention``.
    First its path: the counts set to 0, then forward and backward through
    the op (autograd) at every ``attention_cases`` shape in the nthd layout and at ScOT-B stage 2 in each other layout (head packing
    P = 4 there, as the JAX op packs), outputs against the plain version, the
    counts read. Then each kernel against its plain version at each nthd
    shape, with times."""
    gen = torch.Generator().manual_seed(8)
    cases = []
    for model_name, tag, *geo in attention_cases(pt):
        cases.append((model_name, tag, "nthd", geo))
        if model_name == "B" and tag == "stage2":
            cases += [(model_name, tag, lay, geo) for lay in ("nhtd", "nhdt", "nhdt_packed")]
    reset_counts()
    path_rows = []
    for model_name, tag, layout, (n, t, heads, d, nw, window, res, shift) in cases:
        q, k, v, do, bias, mask, scale = op_case(attn_mod, n, t, heads, d, nw, window, res,
                                                 shift, gen)
        pack = 4 if layout == "nhdt_packed" else 1
        leaves = [to_layout(a, layout, pack).detach().requires_grad_() for a in (q, k, v)]
        leaves += [a.clone().requires_grad_() for a in (bias, mask, scale)]
        out = pt.ops.fused_window_attention(*leaves, layout=layout,
                                            windows_per_image=(res // window) ** 2)
        out.backward(to_layout(do, layout, pack))
        ref = to_layout(wa.attention_plain(q, k, v, (bias[None] + mask[:, None]).contiguous(),
                                           scale), layout, pack)
        torch.cuda.synchronize()
        err = (out.detach().float() - ref.float()).abs()
        ok = (out.shape == leaves[0].shape and bool(torch.isfinite(out.float()).all())
              and bool((err <= ATTN_TOL + ATTN_TOL * ref.float().abs()).all())
              and all(bool(torch.isfinite(a.grad.float()).all()) for a in leaves))
        path_rows.append({"model": model_name, "shape": tag, "layout": layout,
                          "max_abs_err": float(err.max()), "ok": ok})
        if not ok:
            raise SystemExit(f"fused_window_attention op disagrees at {model_name} {tag} {layout}")
        del q, k, v, do, leaves, out, ref
    counts = read_counts()
    want = launches(fused_window_attention_fwd=len(cases), fused_window_attention_bwd=len(cases))
    ok = counts == want
    emit({"phase": "fused_attention_path", "what": "fused_window_attention forward + backward "
          "(autograd) at every ScOT-B, ScOT-L and ScOT-T b32 attention shape and T=49 (nthd) "
          "and ScOT-B stage 2 in nhtd, nhdt, nhdt_packed", "cases": path_rows, "launches": counts, "ok": ok,
          "tol": f"output allclose atol=rtol={ATTN_TOL} vs the plain version", "card": card})
    if not ok:
        raise SystemExit("fused_window_attention path launched other kernels than expected")

    results = {"fwd": [], "bwd": []}
    for model_name, tag, layout, (n, t, heads, d, nw, window, res, shift) in cases:
        if layout != "nthd":
            continue
        q, k, v, do, bias, mask, scale = op_case(attn_mod, n, t, heads, d, nw, window, res,
                                                 shift, gen)
        bm = (bias[None] + mask[:, None]).contiguous()
        shape = f"{tag}: windows={n} T={t} H={heads} D={d} nW={nw}"
        out = wa._forward_sep(q, k, v, bm, scale)
        ref = wa.attention_plain(q, k, v, bm, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        ok = bool(torch.isfinite(out.float()).all()) and bool(
            (err <= ATTN_TOL + ATTN_TOL * ref.float().abs()).all())
        bms, by = attention_bound(n, t, heads, d, nw, bound_ms)
        row = {"phase": "fused_attention_kernel", "kernel": "fused_window_attention_fwd",
               "model": model_name, "shape": shape, "max_abs_err": float(err.max()),
               "tol": f"allclose atol=rtol={ATTN_TOL}", "ok": ok,
               "kernel_ms": cuda_ms(lambda: wa._forward_sep(q, k, v, bm, scale)),
               "plain_ms": cuda_ms(lambda: wa.attention_plain(q, k, v, bm, scale)),
               "library_ms": cuda_ms(attention_library_call(q, k, v, bm, scale)),
               "kernel_device_ms": device_ms(lambda: wa._forward_sep(q, k, v, bm, scale)),
               "library_device_ms": device_ms(attention_library_call(q, k, v, bm, scale)),
               "bound_ms": bms, "bound_by": by, "card": card}
        emit(row)
        results["fwd"].append(row)
        if not ok:
            raise SystemExit(f"fused_window_attention kernel disagrees at {shape}")
        args = (q, k, v, bm, scale, do)
        out = wa.fused_window_attention_bwd(*args)
        again = wa.fused_window_attention_bwd(*args)
        ref = wa.attention_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = compare(("dq", "dk", "dv", "dbm", "dscale"), out, ref)
        ok = backward_ok(errs, out, ref, again, ATTN_TOL, close=3)
        bms, by = attention_bwd_bound(n, t, heads, d, nw, bound_ms)
        row = {"phase": "fused_attention_kernel", "kernel": "fused_window_attention_bwd",
               "model": model_name, "shape": shape, "groups": wa.bwd_groups(n, nw, heads, t),
               "errors": errs, "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
               "tol": f"dq, dk, dv allclose atol=rtol={ATTN_TOL}; dbm, dscale rel L2 <= "
                      f"{SUM_REL_TOL}; second call bit-identical", "ok": ok,
               "kernel_ms": cuda_ms(lambda: wa.fused_window_attention_bwd(*args)),
               "plain_ms": cuda_ms(lambda: wa.attention_bwd_plain(*args)),
               "library_ms": cuda_ms(attention_library_bwd(*args)),
               "kernel_device_ms": device_ms(lambda: wa.fused_window_attention_bwd(*args)),
               "library_device_ms": device_ms(attention_library_bwd(*args)),
               "bound_ms": bms, "bound_by": by, "card": card}
        emit(row)
        results["bwd"].append(row)
        if not ok:
            raise SystemExit(f"fused_window_attention_bwd kernel disagrees at {shape}")
        del q, k, v, do, bm, out, again, ref, args
    return results, counts


# ---------------------------------------------------------------------------
# The general kernels: fp32 operands, and the shapes the wgmma kernels refuse
# ---------------------------------------------------------------------------

FP32_REL_TOL = 1e-4   # fp32 kernel vs fp32 plain version (TF32 off): relative L2, sum order only
ODD = {"num_heads": (2, 4, 8, 16), "mlp_ratio": 3.0}  # ScOT-T with D = 24 and F = 3C


def general_attention_cases(pt):
    """(model, tag, n_windows, T, heads, D, nW, window, res, shift, dtype) of
    the calls the general attention kernel serves: every attention block
    kind of ScOT-B in fp32, of ScOT-T with heads (2, 4, 8, 16) (D = 24) in
    bf16, and a 24x24 window (T = 576, D = 32, shifted, on a 48x48 token
    map) in bf16 and fp32, all at batch 32."""
    cfg_b = pt.make_config("B", image_size=128, num_channels=4, num_out_channels=4)
    cfg_odd = pt.make_config("T", image_size=128, num_channels=4, num_out_channels=4, **ODD)
    out = [("B-fp32", *geo, torch.float32) for geo in attention_shapes(cfg_b, BATCH)]
    out += [("T-odd", *geo, torch.bfloat16) for geo in attention_shapes(cfg_odd, BATCH)]
    out += [("W24", "T576_shifted", BATCH * 4, 576, 3, 32, 4, 24, 48, 12, dt)
            for dt in (torch.bfloat16, torch.float32)]
    return out


def general_mlp_cases(pt, mlp_op):
    """(model, tag, M, C, F, dtype) of the calls the general MLP kernel
    serves on the main paths: ScOT-B, ScOT-T and ScOT-L stages 0-1 in fp32
    (ScOT-L stage 1: C = 384, the first output width past one warpgroup's
    192 columns), and ScOT-T's with mlp_ratio 3 (F = 144 and 288) in bf16,
    batch 32."""
    out = []
    for model_name, size, over, dt in (("B-fp32", "B", {}, torch.float32),
                                       ("T-fp32", "T", {}, torch.float32),
                                       ("L-fp32", "L", {}, torch.float32),
                                       ("T-odd", "T", ODD, torch.bfloat16)):
        cfg = pt.make_config(size, image_size=128, num_channels=4, num_out_channels=4, **over)
        out += [(model_name, *shape, dt) for shape in mlp_shapes(cfg, BATCH, mlp_op)]
    return out


def general_ok(errs, out, ref, fp32, tol, again=None):
    """fp32: every output within FP32_REL_TOL relative L2; bf16: the first
    output allclose atol = rtol = tol and the summed ones by relative L2 as
    the wgmma phases; all finite; ``again`` (a second backward call)
    bit-identical."""
    finite = all(bool(torch.isfinite(o.float()).all()) for o in out)
    same = again is None or all(torch.equal(x, y) for x, y in zip(out, again))
    if fp32:
        close = all(e["rel_l2"] <= FP32_REL_TOL for e in errs.values())
    else:
        o, r = out[0].float(), ref[0].float()
        close = (bool(((o - r).abs() <= tol + tol * r.abs()).all())
                 and all(e["rel_l2"] <= SUM_REL_TOL for e in list(errs.values())[1:]))
    return finite and same and close


def general_tol(fp32, tol, sums):
    if fp32:
        return f"every output rel L2 <= {FP32_REL_TOL} vs the fp32 plain version (TF32 off)"
    return f"{sums[0]} allclose atol=rtol={tol}" + (
        f"; {', '.join(sums[1:])} rel L2 <= {SUM_REL_TOL}" if len(sums) > 1 else "")


def general_row(phase, card, kernel, model_name, shape, errs, ok, tol, timed, lib, bms_by,
                **extra):
    """One kernel's row of a general kernels' phase: its errors and gate, the
    kernel's time (events and device time, by kernel too), the plain
    version's (``timed``) and the library call's, and the bound; emitted,
    and the run ended where it disagrees."""
    dev, by_kernel = device_ms(timed[0], by_kernel=True)
    r = {"phase": phase, "kernel": kernel, "model": model_name, "shape": shape,
         "errors": errs, "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
         "tol": tol, "ok": ok, "kernel_ms": cuda_ms(timed[0]), "plain_ms": cuda_ms(timed[1]),
         "library_ms": cuda_ms(lib), "kernel_device_ms": dev, "device_ms_by_kernel": by_kernel,
         "library_device_ms": device_ms(lib), "bound_ms": bms_by[0], "bound_by": bms_by[1],
         **extra, "card": card}
    emit(r)
    if not ok:
        raise SystemExit(f"{kernel} disagrees at {model_name} {shape}")
    return r


def phase_general_kernels(pt, wa, mlp_op, attn_mod, bound_ms, card):
    """The general kernels against their plain versions at the shapes of
    ``general_attention_cases`` and ``general_mlp_cases``: forward and
    backward, two backward calls compared bit for bit, kernel (events and
    device time), plain and library times (SDPA, or F.linear / F.gelu /
    F.linear, in the operands' dtype, TF32 off), and the bound (fp32 at
    three tf32 products a product on the tensor cores)."""
    gen = torch.Generator().manual_seed(11)
    results = {"attention_fwd": [], "attention_bwd": [], "mlp_fwd": [], "mlp_bwd": []}

    def row(*args, **extra):
        return general_row("general_kernel", card, *args, **extra)

    for model_name, tag, n, t, heads, d, nw, window, res, shift, dt in general_attention_cases(pt):
        fp32, es = dt == torch.float32, 4 if dt == torch.float32 else 2
        qkv, qb, bm, scale = attention_case(attn_mod, n, t, heads, d, nw, window, res, shift,
                                            gen, dt)
        do = torch.randn(n, t, heads * d, generator=gen).to("cuda", dt)
        shape = f"{tag} {dtype_name(dt)}: windows={n} T={t} H={heads} D={d} nW={nw}"
        kind = wa.attention_kernel_for(dt, t, d)
        before = wa.window_attention.launches_general
        out = wa.window_attention(qkv, qb, bm, scale, heads)
        ref = wa.window_attention_plain(qkv, qb, bm, scale, heads)
        torch.cuda.synchronize()
        errs = compare(("out",), (out,), (ref,))
        ok = (kind == "general" and wa.window_attention.launches_general == before + 1
              and general_ok(errs, (out,), (ref,), fp32, ATTN_TOL))
        q, k, v = split_qkv(qkv, qb, heads)
        results["attention_fwd"].append(row(
            "window_attention_general_fwd", model_name, shape, errs, ok,
            general_tol(fp32, ATTN_TOL, ("out",)),
            (lambda: wa.window_attention(qkv, qb, bm, scale, heads),
             lambda: wa.window_attention_plain(qkv, qb, bm, scale, heads)),
            attention_library_call(q, k, v, bm, scale),
            attention_bound(n, t, heads, d, nw, bound_ms, es)))
        del out, ref
        args = (qkv, qb, bm, scale, heads, do)
        out = wa.window_attention_bwd(*args)
        again = wa.window_attention_bwd(*args)
        ref = wa.window_attention_bwd_plain(*args)
        torch.cuda.synchronize()
        names = ("dqkv", "dqb", "dbm", "dscale")
        errs = compare(names, out, ref)
        results["attention_bwd"].append(row(
            "window_attention_general_bwd", model_name, shape, errs,
            general_ok(errs, out, ref, fp32, ATTN_TOL, again),
            general_tol(fp32, ATTN_TOL, names) + "; second call bit-identical",
            (lambda: wa.window_attention_bwd(*args), lambda: wa.window_attention_bwd_plain(*args)),
            attention_library_bwd(q, k, v, bm, scale, do),
            attention_bwd_bound(n, t, heads, d, nw, bound_ms, es)))
        del qkv, do, out, again, ref, q, k, v
    for model_name, tag, m, c, f, dt in general_mlp_cases(pt, mlp_op):
        fp32, es = dt == torch.float32, 4 if dt == torch.float32 else 2
        x, w1, b1, w2, b2 = mlp_case(m, c, f, gen, dt)
        dy = torch.randn(m, c, generator=gen).to("cuda", dt)
        shape = f"{tag} {dtype_name(dt)}: M={m} C={c} F={f}"
        b1l, b2l = b1.to(dt), b2.to(dt)
        before = mlp_op.mlp.launches_general
        out = mlp_op.mlp(x, w1, b1, w2, b2)
        ref = mlp_op.mlp_plain(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        errs = compare(("out",), (out,), (ref,))
        ok = (mlp_op.mlp_kernel_for(c, f, dt) == "general"
              and mlp_op.mlp.launches_general == before + 1
              and general_ok(errs, (out,), (ref,), fp32, MLP_TOL))
        nbytes = 2 * m * c * es + 2 * c * f * es + (f + c) * 4
        results["mlp_fwd"].append(row(
            "mlp_general_fwd", model_name, shape, errs, ok, general_tol(fp32, MLP_TOL, ("out",)),
            (lambda: mlp_op.mlp(x, w1, b1, w2, b2), lambda: mlp_op.mlp_plain(x, w1, b1, w2, b2)),
            lambda: F.linear(F.gelu(F.linear(x, w1, b1l)), w2, b2l),
            bound_ms(4.0 * m * c * f, nbytes, tf32x3=fp32)))
        del out, ref
        args = (x, w1, b1, w2, dy)
        out = mlp_op.mlp_bwd(*args)
        again = mlp_op.mlp_bwd(*args)
        ref = mlp_op.mlp_bwd_plain(*args)
        torch.cuda.synchronize()
        names = ("dx", "dw1", "db1", "dw2", "db2")
        errs = compare(names, out, ref)
        leaves = [a.detach().requires_grad_() for a in (x, w1, b1l, w2, b2l)]
        lib_out = F.linear(F.gelu(F.linear(leaves[0], leaves[1], leaves[2])), leaves[3], leaves[4])
        results["mlp_bwd"].append(row(
            "mlp_general_bwd", model_name, shape, errs,
            general_ok(errs, out, ref, fp32, MLP_TOL, again),
            general_tol(fp32, MLP_TOL, names) + "; second call bit-identical",
            (lambda: mlp_op.mlp_bwd(*args), lambda: mlp_op.mlp_bwd_plain(*args)),
            lambda: torch.autograd.grad(lib_out, leaves, dy, retain_graph=True),
            mlp_bwd_bound(m, c, f, bound_ms, es),
            splits=mlp_op.general_bwd_splits(m, c, f)))
        del x, dy, out, again, ref, lib_out, leaves
    return results



def general_cln_cases(pt, mlp_op):
    """(model, tag, B, L, C, F, dtype) of the calls the general tail kernels
    serve on the main paths under ``fused_block_tail``: ScOT-B, ScOT-L and
    ScOT-T stages 0-1 in fp32 (ScOT-L stage 1: C = 384, past one
    warpgroup's 192 columns, so the norm runs in a row kernel after the
    MLP's partials), and ScOT-T's with mlp_ratio 3 (F = 144 and 288) in
    bf16, batch 32."""
    out = []
    for model_name, size, over, dt in (("B-fp32", "B", {}, torch.float32),
                                       ("L-fp32", "L", {}, torch.float32),
                                       ("T-fp32", "T", {}, torch.float32),
                                       ("T-odd", "T", ODD, torch.bfloat16)):
        cfg = pt.make_config(size, image_size=128, num_channels=4, num_out_channels=4, **over)
        out += [(model_name, *shape, dt) for shape in cln_shapes(cfg, BATCH, mlp_op)]
    return out


def phase_general_cln_kernels(pt, mlp_op, bound_ms, card):
    """The general tail kernels (``csrc/mlp_cln_general.cu``) against their
    plain versions at the shapes of ``general_cln_cases``: forward and
    backward, two backward calls compared bit for bit; fp32 by relative L2
    <= FP32_REL_TOL on every output, bf16 by the gates of the fused-tail
    phase; kernel (events and device time), plain and library times
    (``cln_library_call`` and its autograd backward, in the operands'
    dtype, TF32 off), and the bound (fp32 at three tf32 products a
    product)."""
    gen = torch.Generator().manual_seed(13)
    eps = 1e-5
    results = {"fwd": [], "bwd": []}
    for model_name, tag, b, l, c, f, dt in general_cln_cases(pt, mlp_op):
        fp32, es = dt == torch.float32, 4 if dt == torch.float32 else 2
        x, w1, b1, w2, b2, scale, shift = cln_case(b, l, c, f, gen, dt)
        dy = torch.randn(b, l, c, generator=gen).to("cuda", dt)
        shape = f"{tag} {dtype_name(dt)}: B={b} L={l} C={c} F={f}"
        fargs = (x, w1, b1, w2, b2, scale, shift, eps)
        before = mlp_op.mlp_cln.launches_general
        out = mlp_op.mlp_cln(*fargs)
        ref = mlp_op.mlp_cln_plain(*fargs)
        torch.cuda.synchronize()
        errs = compare(("out",), (out,), (ref,))
        ok = (mlp_op.mlp_kernel_for(c, f, dt) == "general"
              and mlp_op.mlp_cln.launches_general == before + 1
              and general_ok(errs, (out,), (ref,), fp32, MLP_TOL))
        lib_in = cln_library_inputs(x, w1, b1, w2, b2, scale, shift)
        results["fwd"].append(general_row(
            "general_cln_kernel", card, "mlp_cln_general_fwd", model_name, shape, errs, ok,
            general_tol(fp32, MLP_TOL, ("out",)),
            (lambda: mlp_op.mlp_cln(*fargs), lambda: mlp_op.mlp_cln_plain(*fargs)),
            lambda: cln_library_call(*lib_in, eps), cln_bound(b, l, c, f, bound_ms, es=es)))
        del out, ref
        bargs = (x, w1, b1, w2, b2, scale, eps, dy)
        before = mlp_op.mlp_cln_bwd.launches_general
        out = mlp_op.mlp_cln_bwd(*bargs)
        again = mlp_op.mlp_cln_bwd(*bargs)
        ref = mlp_op.mlp_cln_bwd_plain(*bargs)
        torch.cuda.synchronize()
        names = ("dx", "dw1", "db1", "dw2", "db2", "dscale", "dshift")
        errs = compare(names, out, ref)
        ok = (mlp_op.mlp_cln_bwd.launches_general == before + 2
              and general_ok(errs, out, ref, fp32, MLP_TOL, again))
        leaves = [a.detach().requires_grad_() for a in lib_in]
        lib_out = cln_library_call(*leaves, eps)
        results["bwd"].append(general_row(
            "general_cln_kernel", card, "mlp_cln_general_bwd", model_name, shape, errs, ok,
            general_tol(fp32, MLP_TOL, names) + "; second call bit-identical",
            (lambda: mlp_op.mlp_cln_bwd(*bargs), lambda: mlp_op.mlp_cln_bwd_plain(*bargs)),
            lambda: torch.autograd.grad(lib_out, leaves, dy, retain_graph=True),
            cln_bound(b, l, c, f, bound_ms, backward=True, es=es),
            splits=mlp_op.general_bwd_splits(b * l, c, f)))
        del x, dy, out, again, ref, lib_out, leaves, lib_in
    return results


# ---------------------------------------------------------------------------
# Model and rollout
# ---------------------------------------------------------------------------

def launches(**nonzero):
    """The expected counts of a run: every kernel 0 but those named."""
    from poseidon_tpu_torch.ops import COUNTERS

    return {name: nonzero.get(name, 0) for name, _, _ in COUNTERS}


def reset_counts():
    from poseidon_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()


def read_counts():
    from poseidon_tpu_torch.ops import launch_counts

    return launch_counts()


@torch.no_grad()
def perturb_attention(model, attention_cls, gen, tail=False):
    """Make the model's output depend on every head's attention pattern.

    At init the CPB bias is about 8 everywhere, every logit scale is 10 and
    the q/v biases are 0, so a kernel that read bm, the scale or the q-bias
    of the wrong head or window would still agree with the plain path. And
    the conditional norms of the embedding and after each attention scale by
    about 0.01, so the tokens are nearly alike and the output hardly depends
    on any attention pattern. So: the CPB MLP, logit scales and q/v biases
    are redrawn from ``gen``, and those norms' scales set to about 1; with
    ``tail``, the conditional norms after each MLP too, so that the fused
    block tail matters to the output."""
    def draw(p, std):
        p.copy_((std * torch.randn(p.shape, generator=gen)).to(p.device))

    model.embeddings.norm.weight.bias.fill_(1.0)
    for mod in model.modules():
        for name in ("layernorm_before",) + (("layernorm_after",) if tail else ()):
            norm = getattr(mod, name, None)
            if norm is not None:
                norm.weight.bias.fill_(1.0)
        if isinstance(mod, attention_cls):
            s = mod.self
            cpb = s.continuous_position_bias_mlp
            draw(cpb[0].weight, 1.0)
            draw(cpb[0].bias, 1.0)
            draw(cpb[2].weight, 2.0 / math.sqrt(cpb[2].in_features))
            s.logit_scale.add_((0.5 * torch.randn(s.logit_scale.shape, generator=gen))
                               .to(s.logit_scale.device))
            if mod.qkv_bias:
                draw(s.query.bias, 0.05)
                draw(s.value.bias, 0.05)


def block_launches(model, wa, mlp_op, fused_tail=False, backward=False):
    """The kernel launches a forward (with ``backward``, a forward and its
    backward) of the model should make: per Swin block the attention kernel
    that ``attention_kernel_for`` picks, and the MLP kernel that
    ``use_mlp_kernel`` and ``mlp_kernel_for`` pick, or the fused tail where
    ``use_fused_tail`` takes the block (its Hopper or its general kernels,
    as ``mlp_kernel_for`` picks)."""
    from poseidon_tpu_torch.models.scot import SwinBlock
    want = launches()
    for blk in (m for m in model.modules() if isinstance(m, SwinBlock)):
        attn = blk.attention
        kind = wa.attention_kernel_for(model.dtype, attn.window_size ** 2,
                                       attn.dim // attn.num_heads)
        names = ["window_attention_general" if kind == "general" else "window_attention"]
        fc = blk.intermediate.dense
        c, f, l = fc.in_features, fc.out_features, blk.resolution ** 2
        if fused_tail and mlp_op.use_fused_tail(c, l, f):
            names.append("mlp_cln" if mlp_op.mlp_kernel_for(c, f, model.dtype) == "wgmma"
                         else "mlp_cln_general")
        elif mlp_op.use_mlp_kernel(c, l, f):
            names.append("fused_mlp" if mlp_op.mlp_kernel_for(c, f, model.dtype) == "wgmma"
                         else "mlp_general")
        for name in names:
            want[name + "_fwd"] += 1
            if backward:
                want[name + "_bwd"] += 1
    return want


def swin_blocks(model):
    from poseidon_tpu_torch.models.scot import SwinBlock
    return sum(1 for m in model.modules() if isinstance(m, SwinBlock))


def dtype_name(dtype):
    return "fp32" if dtype == torch.float32 else "bf16"


def phase_model(pt, wa, mlp_op, attn_mod, card, fused_tail=False, size="B",
                dtype=torch.bfloat16, overrides=None, tol=MODEL_REL_TOL, name=None):
    """The ScOT-B (or ``size``) forward, kernel path against plain path;
    with ``fused_tail``, under ``fused_block_tail=True`` (phase
    "fused_tail_model", the MLP + norm + residual kernel at stages 0-1 in
    place of the MLP kernel), the post-MLP norm scales set to about 1 as
    well. Phase "model_T" is ScOT-T's (D = 16 at every stage); ``dtype``,
    config ``overrides``, the tolerance and the phase ``name`` serve the
    general kernels' model phases."""
    cfg = pt.make_config(size, image_size=128, num_channels=4, num_out_channels=4,
                         channel_slice_list=(0, 1, 3, 4), use_conditioning=True,
                         attention_impl="pallas", fused_block_tail=fused_tail,
                         **(overrides or {}))
    t0 = time.perf_counter()
    model = pt.build_model(cfg, device="cuda", dtype=dtype, seed=0)
    perturb_attention(model, attn_mod.WindowAttention, torch.Generator().manual_seed(3),
                      tail=fused_tail)
    plain = pt.ScOT(cfg.replace(attention_impl="xla"), dtype=dtype)
    plain.load_state_dict(model.state_dict(), strict=True)
    plain = plain.to("cuda").eval()
    build_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(BATCH, 4, 128, 128, generator=gen).to("cuda")
    t = torch.full((BATCH,), 0.5, device="cuda")

    with torch.no_grad():
        y_plain = plain(x, t)
        torch.cuda.synchronize()
        reset_counts()
        y = model(x, t)
        torch.cuda.synchronize()
        counts = read_counts()
        fwd_ms = host_ms(lambda: model(x, t), iters=5)
        plain_fwd_ms = host_ms(lambda: plain(x, t), iters=5)
    rel = float((y.float() - y_plain.float()).norm() / y_plain.float().norm())
    want = block_launches(model, wa, mlp_op, fused_tail)
    ok = (tuple(y.shape) == (BATCH, 4, 128, 128) and bool(torch.isfinite(y).all())
          and rel <= tol and counts == want)
    suffix = "" if size == "B" else f"_{size}"
    name = name or ("fused_tail_model" if fused_tail else "model" + suffix)
    emit({"phase": name,
          "model": f"ScOT-{size} 128x128 c4 {dtype_name(dtype)} conditioned"
                   + (", fused_block_tail" if fused_tail else "")
                   + (f", {overrides}" if overrides else ""), "batch": BATCH,
          "weights": "seed 0 init; CPB MLP, logit scales, q/v biases redrawn (seed 3); "
                     "embedding and post-attention norm scales 1"
                     + ("; post-MLP norm scales 1" if fused_tail else ""),
          "params": sum(p.numel() for p in model.parameters()), "build_s": build_s,
          "rel_l2_vs_plain_path": rel, "tol": tol, "launches_expected": want,
          "out_rms": float(y.float().pow(2).mean().sqrt()),
          "forward_ms": fwd_ms, "samples_per_s": BATCH / (fwd_ms / 1e3),
          "plain_path_forward_ms": plain_fwd_ms, "launches_per_forward": counts,
          "ok": ok, "card": card})
    if not ok:
        raise SystemExit(f"{name} phase failed (ScOT-{size})")
    return model, x, t, counts, fwd_ms


def phase_profile(model, x, t, forward_ms, card):
    """Where one kernel-path forward spends device time (see
    ``device_time_profile``)."""
    def forward():
        with torch.no_grad():
            model(x, t)

    emit({"phase": "profile", "what": "one kernel-path ScOT-B b32 forward",
          "forward_ms": forward_ms, **device_time_profile(forward, forward_ms), "card": card})


def plain_twin(pt, model):
    """The plain path ("xla") on the model's weights, on the card."""
    plain = pt.ScOT(model.config.replace(attention_impl="xla"), dtype=model.dtype)
    plain.load_state_dict(model.state_dict(), strict=True)
    return plain.to("cuda")


def phase_rollout(pt, model, x, t, per_forward, card, name="rollout", tol=None):
    """autoregressive_rollout with ar_steps=4, launches counted; with ``tol``,
    held to the plain path's rollout on the same weights (relative L2)."""
    steps = 4

    def rollout(m):
        return pt.autoregressive_rollout(m, x, t, ar_steps=steps, num_out_channels=4,
                                         device="cuda")

    with torch.no_grad():
        reset_counts()
        y = rollout(model)
        torch.cuda.synchronize()
        counts = read_counts()
        roll_ms = host_ms(lambda: rollout(model), iters=3, warmup=1)
        rel = None
        if tol is not None:
            y_plain = rollout(plain_twin(pt, model).eval())
            rel = float((y.float() - y_plain.float()).norm() / y_plain.float().norm())
    ok = (tuple(y.shape) == (BATCH, 4, 128, 128) and bool(torch.isfinite(y).all())
          and counts == {k: steps * v for k, v in per_forward.items()}
          and (tol is None or rel <= tol))
    emit({"phase": name, "ar_steps": steps, "batch": BATCH, "rollout_ms": roll_ms,
          "final_rms": float(y.float().pow(2).mean().sqrt()), "launches": counts,
          **({"rel_l2_vs_plain_path": rel, "tol": tol} if tol is not None else {}),
          "ok": ok, "card": card})
    if not ok:
        raise SystemExit(f"{name} phase failed")
    return counts


def train_batch():
    gen = torch.Generator().manual_seed(5)
    mask = torch.zeros(BATCH, 4, dtype=torch.bool)
    mask[:, 3] = True   # as bench.py: the last channel taken from the labels
    batch = {"pixel_values": torch.randn(BATCH, 4, 128, 128, generator=gen),
             "time": torch.full((BATCH,), 0.5),
             "labels": torch.randn(BATCH, 4, 128, 128, generator=gen), "pixel_mask": mask}
    return {k: v.to("cuda") for k, v in batch.items()}


def loss_and_grads(pt, model, batch):
    """The train step's loss and gradients, without the update."""
    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = pt.forward_with_loss(model, batch["pixel_values"], batch["time"],
                                   batch["labels"], batch["pixel_mask"])
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


# Per Swin block, the parameters whose gradients the kernels' backward
# carries: a zero one means the block trained as if they were frozen.
BLOCK_GRADS = ("attention.self.query.weight", "attention.self.key.weight",
               "attention.self.value.weight", "attention.self.logit_scale",
               "attention.self.continuous_position_bias_mlp.0.weight",
               "attention.self.continuous_position_bias_mlp.2.weight",
               "intermediate.dense.weight", "output.dense.weight")


# Under the fused block tail, the post-MLP norm's weights too: in the fused
# blocks their gradients come out of the tail's backward kernel.
TAIL_GRADS = BLOCK_GRADS + ("layernorm_after.weight.weight", "layernorm_after.bias.weight")


def grad_breakdown(g, ref):
    """Relative L2 of the gradients ``g`` against ``ref`` (dicts by
    parameter name): the whole, and by parameter kind (the name with its
    stage and block indices starred) and by leaf, the eight largest shares
    of the squared difference each."""
    kinds, leaves = {}, []
    for n, r in ref.items():
        if r is None or g[n] is None:
            continue
        d = float((g[n].float() - r.float()).square().sum())
        nr = float(r.float().square().sum())
        leaves.append((n, d, nr))
        acc = kinds.setdefault(re.sub(r"\.\d+\.", ".*.", n), [0.0, 0.0])
        acc[0] += d
        acc[1] += nr
    tot_d, tot_r = sum(v[1] for v in leaves), sum(v[2] for v in leaves)

    def top(items):
        items = sorted(items, key=lambda v: -v[1])[:8]
        return [{"name": n, "rel_l2": math.sqrt(d / nr) if nr else None,
                 "share": d / tot_d if tot_d else 0.0} for n, d, nr in items]

    return {"rel_l2": math.sqrt(tot_d / tot_r),
            "by_kind": top([(k, d, nr) for k, (d, nr) in kinds.items()]),
            "by_leaf": top(leaves)}


def tail_grad_witness(pt, mlp_op, model, batch, g_plain, g_kernel):
    """What the fused-tail model's gradient difference from the plain path
    is made of. The kernel path's difference by parameter kind and leaf,
    and two more paths on the same weights and batch, each against the
    plain path and against the kernel path: ``tail_plain_twins``, the same
    model with the tail's plain versions (``mlp_cln_plain``,
    ``mlp_cln_bwd_plain``: the kernels' formula and rounding points in
    PyTorch, the backward's norm gradient analytic) in place of its
    kernels; ``unfused_kernels``, the model without the fused tail (the
    general MLP kernel, then the norm under autograd)."""
    out = {"kernel_vs_plain": grad_breakdown(g_kernel, g_plain)}
    fwd, bwd = mlp_op._forward_cln, mlp_op.mlp_cln_bwd
    mlp_op._forward_cln, mlp_op.mlp_cln_bwd = mlp_op.mlp_cln_plain, mlp_op.mlp_cln_bwd_plain
    try:
        _, g_twin = loss_and_grads(pt, model, batch)
    finally:
        mlp_op._forward_cln, mlp_op.mlp_cln_bwd = fwd, bwd
    unfused = pt.ScOT(model.config.replace(fused_block_tail=False), dtype=model.dtype)
    unfused.load_state_dict(model.state_dict(), strict=True)
    _, g_unfused = loss_and_grads(pt, unfused.to(next(model.parameters()).device), batch)
    for name, g in (("tail_plain_twins", g_twin), ("unfused_kernels", g_unfused)):
        out[name] = {"vs_plain": grad_breakdown(g, g_plain),
                     "vs_kernel_path_rel_l2": grad_breakdown(g, g_kernel)["rel_l2"]}
    del unfused, g_twin, g_unfused
    return out


def phase_train(pt, wa, mlp_op, model, card, fused_tail=False, size="B", tol=GRAD_REL_TOL,
                name=None, witness=False):
    """The ScOT-B (or the model's size) train step on the card: gradients of the kernel path
    against the plain path on the same weights and batch, launches per
    step, then TRAIN_STEPS steps on that batch (lr 1e-4, weight decay 1e-6,
    cosine over 10,000 steps, clip 5.0, as bench.py) and the step's time.
    With ``fused_tail`` the model is the fused-tail one (phase
    "fused_tail_train"); ``tol`` and the phase ``name`` serve the general
    kernels' model phases; ``witness`` adds ``tail_grad_witness``."""
    block_grads = TAIL_GRADS if fused_tail else BLOCK_GRADS
    batch = train_batch()
    plain = pt.ScOT(model.config.replace(attention_impl="xla"), dtype=model.dtype)
    plain.load_state_dict(model.state_dict(), strict=True)
    plain = plain.to("cuda")
    loss_plain, g_plain = loss_and_grads(pt, plain, batch)
    vec_plain = torch.cat([g.float().flatten() for g in g_plain.values()])
    del plain
    reset_counts()
    loss_kernel, g_kernel = loss_and_grads(pt, model, batch)
    torch.cuda.synchronize()
    grad_counts = read_counts()
    bad = [n for n, g in g_kernel.items() if g is None or not bool(torch.isfinite(g).all())]
    zero = [n for n, g in g_kernel.items()
            if n.endswith(block_grads) and g is not None and float(g.abs().max()) == 0.0]
    blocks_checked = sum(1 for n in g_kernel if n.endswith(block_grads[0]))
    vec_kernel = torch.cat([g.float().flatten() for g in g_kernel.values()])
    rel = float((vec_kernel - vec_plain).norm() / vec_plain.norm())
    del vec_kernel, vec_plain
    witnesses = (tail_grad_witness(pt, mlp_op, model, batch, g_plain, g_kernel)
                 if witness else None)
    del g_plain, g_kernel
    model.zero_grad(set_to_none=True)

    opt, sched = pt.build_optimizer(model, learning_rate=1e-4, total_steps=10_000,
                                    weight_decay=1e-6, lr_scheduler_type="cosine",
                                    warmup_ratio=0.0)

    def step():
        return pt.train_step(model, opt, sched, batch, max_grad_norm=5.0)

    losses, norms = [], []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        if i == 0:
            reset_counts()
        out = step()
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
        if i == 0:
            step_counts = read_counts()
    steps_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    step_ms = host_ms(step, iters=5)
    peak = torch.cuda.max_memory_allocated()
    want = block_launches(model, wa, mlp_op, fused_tail, backward=True)
    ok = (not bad and not zero and blocks_checked == swin_blocks(model) and rel <= tol
          and math.isfinite(loss_kernel) and abs(loss_kernel - loss_plain) <= tol * abs(loss_plain)
          and grad_counts == want and step_counts == want
          and all(math.isfinite(v) for v in losses) and losses[-1] < losses[0])
    suffix = "" if size == "B" else f"_{size}"
    name = name or ("fused_tail_train" if fused_tail else "train" + suffix)
    emit({"phase": name,
          "model": f"ScOT-{size} 128x128 c4 {dtype_name(model.dtype)} conditioned, fp32 "
                   f"parameters" + (", fused_block_tail" if fused_tail else ""),
          "batch": BATCH, "weights": "those of the model phase",
          "loss_kernel_path": loss_kernel, "loss_plain_path": loss_plain,
          "grad_rel_l2_vs_plain_path": rel, "tol": tol,
          "params_without_finite_grad": bad, "block_grads_checked": list(block_grads),
          "block_params_with_zero_grad": zero,
          "blocks_checked": blocks_checked, "launches_per_grad": grad_counts,
          "launches_per_step": step_counts,
          "optimizer": "AdamW 4-group, lr 1e-4 cosine/10000, wd 1e-6, clip 5.0",
          "losses": losses, "grad_norms": norms, "steps_seconds": steps_s,
          "train_step_ms": step_ms,
          "samples_per_s": BATCH / (step_ms / 1e3), "peak_memory_gib": peak / 2 ** 30,
          **({"grad_witness": witnesses} if witness else {}), "ok": ok, "card": card})
    if not ok:
        raise SystemExit(f"{name} phase failed (ScOT-{size})")
    return step, step_counts, step_ms


def device_time_profile(fn, wall_ref_ms):
    """torch.profiler over one call of ``fn``: device busy time (sum of the
    device-side kernel and copy times), busy time by group, top kernels, and
    the idle share against ``wall_ref_ms`` (the unprofiled time: the
    profiler's own host work stretches the profiled wall time). Device
    activity only: recording the host's ops as well multiplies the
    profiler's own processing time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    # Device-side events only (kernels, memcpy/memset): the spans that user
    # annotations (the optimizer's "Optimizer.step#AdamW.step") leave on the
    # device timeline carry the same time again.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    groups = {}
    for e in kernels:
        name = e.key.lower()
        if any(k in name for k in ("window_attention_fwd_kernel", "attn_bwd_")):
            g = "port attention kernels"
        elif "attn_general_" in name:
            g = "port general attention kernels"
        elif "clnepi" in name or "mlp_cln_general" in name:
            g = "port general tail kernels"
        elif "mlp_general_" in name:
            g = "port general MLP kernels"
        elif any(k in name for k in ("mlp_fwd_kernel", "mlp_bwd_", "mlp_cln_")):
            g = "port MLP kernels"
        elif "multi_tensor_apply" in name:
            g = "optimizer (multi-tensor AdamW)"
        elif any(k in name for k in ("gemm", "xmma", "cutlass", "sm90", "cublas")):
            g = "library GEMMs"
        elif "conv" in name or "cudnn" in name:
            g = "convolutions"
        else:
            g = "elementwise, reductions, copies"
        groups[g] = groups.get(g, 0.0) + dev_us(e) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    return {"profiled_wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ref_ms),
            "device_idle_share_of_profiled_wall": max(0.0, 1.0 - busy / wall),
            "device_kernels": sum(e.count for e in kernels), "busy_ms_by_group": groups,
            "top_device": [{"name": e.key[:80], "count": e.count, "ms": dev_us(e) / 1e3}
                           for e in top]}


def phase_train_profile(step, step_ms, card, fused_tail=False):
    emit({"phase": "fused_tail_train_profile" if fused_tail else "train_profile",
          "what": "one ScOT-B b32 train step, kernel path"
                  + (", fused_block_tail" if fused_tail else ""),
          "train_step_ms": step_ms, **device_time_profile(step, step_ms), "card": card})


GENERAL_ATTN_GROUP = "port general attention kernels"
GENERAL_MLP_GROUP = "port general MLP kernels"
# The general tail's own kernels (its forward kernel under the norm's
# epilogue, its row kernels, its reduce); its weight prologues and its
# backward's MLP stage run the general MLP's kernels (GENERAL_MLP_GROUP).
GENERAL_TAIL_GROUP = "port general tail kernels"


def phase_fp32_b(pt, wa, mlp_op, attn_mod, card, fused_tail=False):
    """ScOT-B b32 in fp32, the compute dtype of the inference CLI and the
    default of ``build_model`` and ``from_pretrained``: every attention call
    on the general kernels (64 a forward, 64 / 64 a step) and every MLP call
    on the general MLP kernels (32 a forward, 32 / 32 a step); with
    ``fused_tail`` (``fused_block_tail=True``, phases "*_tail"), every
    stage 0-1 block's MLP, norm and residual on the general tail kernels
    instead (32 a forward, 32 / 32 a step, no MLP launch), and a rollout
    (ar_steps=4). The forward (phase "model_B_fp32") and the train step
    ("train_B_fp32") against the plain path on the same weights (relative
    L2 <= FP32_REL_TOL; the rollout too), then one profiled forward and
    step: device busy, idle share, and the general attention, MLP and tail
    kernels' device time. Returns (forward, rollout, step) launch counts."""
    tail = "_tail" if fused_tail else ""
    model, x, t, fwd_counts, fwd_ms = phase_model(
        pt, wa, mlp_op, attn_mod, card, fused_tail=fused_tail, size="B", dtype=torch.float32,
        tol=FP32_REL_TOL, name="model_B_fp32" + tail)

    def forward():
        with torch.no_grad():
            model(x, t)

    def groups(prof):
        by = prof["busy_ms_by_group"]
        return {"general_attention_device_ms": by.get(GENERAL_ATTN_GROUP, 0.0),
                "general_mlp_device_ms": by.get(GENERAL_MLP_GROUP, 0.0),
                "general_tail_device_ms": by.get(GENERAL_TAIL_GROUP, 0.0)}

    def mlp_ok(counts, n):
        """The stage 0-1 blocks' MLP launches (``n`` each way) on the
        general MLP kernels, or under the tail on the general tail kernels
        and none on an MLP kernel."""
        got = [counts[k] for k in ("mlp_general_fwd", "mlp_general_bwd", "mlp_cln_general_fwd",
                                   "mlp_cln_general_bwd", "fused_mlp_fwd", "fused_mlp_bwd")]
        return got == ([0, 0] + n + [0, 0] if fused_tail else n + [0, 0, 0, 0])

    prof = device_time_profile(forward, fwd_ms)
    dev = groups(prof)
    own = dev["general_tail_device_ms" if fused_tail else "general_mlp_device_ms"]
    ok = (fwd_counts["window_attention_general_fwd"] == 64
          and dev["general_attention_device_ms"] > 0 and mlp_ok(fwd_counts, [32, 0]) and own > 0)
    emit({"phase": f"model_B_fp32{tail}_profile",
          "what": "one ScOT-B fp32 b32 forward, kernel path"
                  + (", fused_block_tail" if fused_tail else ""),
          "forward_ms": fwd_ms, **dev,
          "general_attention_launches": fwd_counts["window_attention_general_fwd"],
          "general_mlp_launches": fwd_counts["mlp_general_fwd"],
          "general_tail_launches": fwd_counts["mlp_cln_general_fwd"],
          **prof, "ok": ok, "card": card})
    if not ok:
        raise SystemExit(f"model_B_fp32{tail}_profile phase failed")
    rollout_counts = (phase_rollout(pt, model, x, t, fwd_counts, card,
                                    name="rollout_B_fp32_tail", tol=FP32_REL_TOL)
                      if fused_tail else None)
    step, step_counts, step_ms = phase_train(pt, wa, mlp_op, model, card, fused_tail=fused_tail,
                                             size="B", tol=FP32_REL_TOL,
                                             name="train_B_fp32" + tail, witness=fused_tail)
    prof = device_time_profile(step, step_ms)
    dev = groups(prof)
    own = dev["general_tail_device_ms" if fused_tail else "general_mlp_device_ms"]
    got = (step_counts["window_attention_general_fwd"],
           step_counts["window_attention_general_bwd"])
    ok = (got == (64, 64) and dev["general_attention_device_ms"] > 0
          and mlp_ok(step_counts, [32, 32]) and own > 0)
    emit({"phase": f"train_B_fp32{tail}_profile",
          "what": "one ScOT-B fp32 b32 train step, kernel path"
                  + (", fused_block_tail" if fused_tail else ""),
          "train_step_ms": step_ms, **dev,
          "general_attention_launches_fwd_bwd": list(got),
          "general_mlp_launches_fwd_bwd": [step_counts["mlp_general_fwd"],
                                           step_counts["mlp_general_bwd"]],
          "general_tail_launches_fwd_bwd": [step_counts["mlp_cln_general_fwd"],
                                            step_counts["mlp_cln_general_bwd"]],
          **prof, "ok": ok, "card": card})
    if not ok:
        raise SystemExit(f"train_B_fp32{tail}_profile phase failed")
    del model, step
    return fwd_counts, rollout_counts, step_counts


def phase_tail_vs_unfused(model, tail_model, x, t, step, tail_step, card):
    """The unfused and the fused-tail ScOT-B b32 forward and train step in
    turns (unfused, fused, fused, unfused), the median of five timed calls
    each."""
    def forward(m):
        def fn():
            with torch.no_grad():
                m(x, t)
        return fn

    out = {"phase": "fused_tail_vs_unfused", "card": card}
    for what, a, b in (("forward", forward(model.eval()), forward(tail_model.eval())),
                       ("train_step", step, tail_step)):
        times = [host_ms(fn, iters=5) for fn in (a, b, b, a)]
        unfused, fused = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        out[what] = {"unfused_ms": [times[0], times[3]], "fused_tail_ms": [times[1], times[2]],
                     "unfused_samples_per_s": BATCH / (unfused / 1e3),
                     "fused_tail_samples_per_s": BATCH / (fused / 1e3),
                     "faster": "fused_tail" if fused < unfused else "unfused"}
    emit(out)


# ---------------------------------------------------------------------------
# The Trainer on a synthetic CE-Gauss file
# ---------------------------------------------------------------------------

TRAIN_TRAJ = 4  # x 36 (t1, t2) pairs = 144 samples: 4 steps an epoch at batch 32


def write_ce_gauss(path, train_traj=TRAIN_TRAJ, train_times=range(0, 15, 2),
                   val_times=(0, 2), test_times=()):
    """A sparse synthetic CE-Gauss file in the dataset's schema: ``data``
    (10000, 21, 4, 128, 128) f32, and only the frames the splits read are
    written (by default, the Trainer phase's: train trajectories [0,
    TRAIN_TRAJ) at times 0-14 step 2; val, its 120 trajectories at times 0
    and 2; the test split's 240 at ``test_times``). Each trajectory is a
    blocky random field that decays in time, so that the operator is
    learnable. An HDF5 file in (1, 1, 4, 128, 128) chunks where h5py is
    installed, else the data layer's other format
    (``data/base.py::open_data_file``): a directory holding ``data.npy``, a
    sparse memory-mapped file. Returns (format, bytes written)."""
    try:
        import h5py
    except ImportError:
        h5py = None
    rng = np.random.default_rng(0)
    n_max, n_val, n_test = 10000, 120, 240
    val0 = n_max - n_val - n_test
    shape = (n_max, 21, 4, 128, 128)

    def fill(d):
        written = 0
        for traj, times in ([(i, train_times) for i in range(train_traj)]
                            + [(i, val_times) for i in range(val0, val0 + n_val)]
                            + [(i, test_times) for i in range(n_max - n_test, n_max)]):
            base = np.kron(rng.normal(size=(4, 16, 16)), np.ones((8, 8))).astype(np.float32)
            base[0] += 1.5   # density and pressure around their dataset means
            base[3] += 2.5
            for tt in times:
                d[traj, tt] = base * np.float32(np.exp(-0.03 * tt))
                written += base.nbytes
        return written

    if h5py is not None:
        with h5py.File(path, "w") as f:
            return "hdf5", fill(f.create_dataset("data", shape=shape, dtype="f4",
                                                 chunks=(1, 1, 4, 128, 128)))
    return "npy", _write_npy_dir(path, {"data": shape}, lambda arrays: fill(arrays["data"]))


def _write_npy_dir(path, shapes, fill):
    """A directory of sparse memory-mapped ``<key>.npy`` files of the given
    shapes (the data layer reads it as an HDF5 file), filled by
    ``fill(arrays)``; returns what ``fill`` returns."""
    os.makedirs(path)
    arrays = {k: np.lib.format.open_memmap(os.path.join(path, f"{k}.npy"), mode="w+",
                                           dtype=np.float32, shape=shape)
              for k, shape in shapes.items()}
    out = fill(arrays)
    for a in arrays.values():
        a.flush()
    del arrays
    return out


def trace_busy(trace_dir):
    """Device busy time (ms) and the span of the profiled window (ms) of the
    Chrome trace the Trainer's profiler wrote: kernels, copies and sets on
    the device, against the first to the last event."""
    import glob
    path = sorted(glob.glob(os.path.join(trace_dir, "*.json")))[-1]
    with open(path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    busy = sum(e["dur"] for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")) / 1e3
    span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    return busy, span


def nondeterministic_grads(pt, model):
    """The parameters whose gradients differ between two identical backward
    passes (same weights, batch and masks), largest difference first: the
    ops behind them are not deterministic on this card."""
    batch = train_batch()
    grads = []
    model.train()
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        pt.forward_with_loss(model, batch["pixel_values"], batch["time"], batch["labels"],
                             batch["pixel_mask"])[0].backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    model.zero_grad(set_to_none=True)
    diff = {n: float((grads[0][n] - grads[1][n]).abs().max()) for n in grads[0]}
    return {n: d for n, d in sorted(diff.items(), key=lambda kv: -kv[1]) if d > 0}


def phase_trainer(pt, wa, mlp_op, card, bare_step_ms):
    """The port's Trainer on the card: ScOT-B (bf16 compute, fp32
    parameters, attention_impl "pallas") on a synthetic CE-Gauss file
    (``write_ce_gauss``) through ``get_dataset`` and the threaded loader; ``train`` for two
    epochs of four steps at batch 32 with mid-epoch checkpoints
    (``save_steps=2``) and a torch.profiler window over global steps 1-2;
    ``evaluate`` on the val split (120 samples, the last batch padded) with
    ChannelGroupMetrics; ``predict`` after ``set_ar_steps(2)``; the bare
    train step on a fixed batch and on the loader's, in turns, around one
    epoch of a Trainer without mid-epoch checkpoints; then a second
    Trainer resumed from the mid-epoch checkpoint of epoch 1, whose step
    losses and final weights are held to the uninterrupted run's bit for bit
    (cuDNN deterministic for the phase). Where they differ, two identical
    backward passes name the parameters whose gradients the card computes
    nondeterministically; the phase then passes only if such parameters
    exist and the step losses agree to 1e-5 relative."""
    import shutil
    import tempfile

    from poseidon_tpu_torch.data.loader import DataLoader

    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        t0 = time.perf_counter()
        data_format, data_bytes = write_ce_gauss(os.path.join(root, "CE-Gauss.nc"))
        data_s = time.perf_counter() - t0
        name = "fluids.compressible.Gaussians"
        train = pt.get_dataset(name, which="train", num_trajectories=TRAIN_TRAJ, data_path=root)
        val = pt.get_dataset(name, which="val", num_trajectories=TRAIN_TRAJ, data_path=root,
                             max_num_time_steps=1, fix_input_to_time_step=0)
        cfg = pt.make_config("B", image_size=128, num_channels=4, num_out_channels=4,
                             channel_slice_list=tuple(train.channel_slice_list),
                             use_conditioning=True, attention_impl="pallas")
        metrics = pt.ChannelGroupMetrics(train.channel_slice_list,
                                         train.printable_channel_description)

        def trainer(out, **kw):
            model = pt.build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
            args = pt.TrainingArguments(**{
                "output_dir": os.path.join(root, out), "train_batch_size": BATCH,
                "eval_batch_size": BATCH, "num_train_epochs": 2, "learning_rate": 1e-4,
                "weight_decay": 1e-6, "max_grad_norm": 5.0, "logging_steps": 1,
                "save_steps": 2, "save_total_limit": 10, "num_workers": 8, **kw})
            return pt.Trainer(model, args, train_dataset=train, compute_metrics=metrics,
                              device="cuda")

        def step_log(out):
            with open(os.path.join(root, out, "logs.jsonl")) as fh:
                return {r["step"]: r for r in map(json.loads, fh) if "step" in r}

        # The loader alone: one epoch of batches from the file, no device.
        loader = DataLoader(train, BATCH, shuffle=True, seed=0, num_workers=8)
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in loader.epoch(0))
        loader_ms = (time.perf_counter() - t0) * 1e3 / max(n_batches, 1)

        full = trainer("full", profile_step_start=1, profile_step_stop=3)
        reset_counts()
        t0 = time.perf_counter()
        history = full.train()
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        counts = read_counts()
        steps = full.step
        per_step = block_launches(full.model, wa, mlp_op, backward=True)
        counts_ok = counts == {k: steps * v for k, v in per_step.items()}
        busy_ms, span_ms = trace_busy(os.path.join(root, "full", "profile"))
        t0 = time.perf_counter()
        full.save_checkpoint(os.path.join(root, "scratch"), 9, 0.0)
        ckpt_s = time.perf_counter() - t0
        final = {k: v.clone() for k, v in full.model.state_dict().items()}
        epoch1_s = history[-1]["train_time_s"]

        t0 = time.perf_counter()
        ev = full.evaluate(val)
        eval_s = time.perf_counter() - t0
        full.set_ar_steps(2)
        t0 = time.perf_counter()
        pred = full.predict(val)
        predict_s = time.perf_counter() - t0
        full.close()

        # What the Trainer adds to the bare step: four bare train steps on
        # one fixed device batch and four on the loader's batches through the
        # Trainer's host-to-device prefetch, in turns (fixed, loader, loader,
        # fixed), each ending in a synchronize.
        fixed = train_batch()

        def bare_fixed():
            for _ in range(4):
                pt.train_step(full.model, full.optimizer, full.scheduler, fixed, max_grad_norm=5.0)
            return 4

        def bare_loader(epoch):
            n = 0
            for _, dev in full._device_prefetch(loader.epoch(epoch)):
                pt.train_step(full.model, full.optimizer, full.scheduler, dev, max_grad_norm=5.0)
                n += 1
            return n

        def trainer_epoch():
            # One epoch of a Trainer without mid-epoch checkpoints: its
            # train_time_s (loader, steps and step logs; the checkpoint
            # after the epoch is outside it) over its steps.
            timed = trainer("timed", num_train_epochs=1, save_steps=None)
            hist = timed.train()
            timed.close()
            return hist[0]["train_time_s"] * 1e3 / timed.step

        turns = []
        for run in (bare_fixed, lambda: bare_loader(2), lambda: bare_loader(3), bare_fixed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = run()
            torch.cuda.synchronize()
            turns.append((time.perf_counter() - t0) * 1e3 / n)
            if len(turns) == 2:
                trainer_step_ms = trainer_epoch()

        # Resume: the output directory of a run stopped after epoch 1's
        # mid-epoch checkpoint.
        os.makedirs(os.path.join(root, "resumed"))
        shutil.copytree(os.path.join(root, "full", "checkpoint-1-step2"),
                        os.path.join(root, "resumed", "checkpoint-1-step2"))
        resumed = trainer("resumed", resume_from_checkpoint=True)
        resumed.train()
        resumed.close()
        want, got = step_log("full"), step_log("resumed")
        loss_diff = {s: abs(got[s]["loss"] - want[s]["loss"]) for s in got}
        weight_diff = {k: float((v.float() - final[k].float()).abs().max())
                       for k, v in resumed.model.state_dict().items()}
        worst = max(weight_diff, key=weight_diff.get)
        bitwise = (sorted(got) == [7, 8]
                   and all(got[s]["loss"] == want[s]["loss"]
                           and got[s]["grad_norm"] == want[s]["grad_norm"] for s in got)
                   and all(torch.equal(v, final[k])
                           for k, v in resumed.model.state_dict().items()))
        nondet = {} if bitwise else nondeterministic_grads(pt, resumed.model)
        resume_ok = bitwise or (sorted(got) == [7, 8] and bool(nondet) and all(
            loss_diff[s] <= 1e-5 * abs(want[s]["loss"]) for s in got))
        pred_shape = list(pred.predictions.shape)
        ok = (counts_ok and steps == 8 and all(math.isfinite(r["loss"]) for r in want.values())
              and pred_shape == [len(val), 4, 128, 128]
              and all(math.isfinite(v) for v in ev.values())
              and math.isfinite(pred.metrics["loss"]) and resume_ok)
        step_s = epoch1_s / 4
        emit({"phase": "trainer", "model": "ScOT-B 128x128 c4 bf16 conditioned, fp32 parameters",
              "data": f"synthetic CE-Gauss (fluids.compressible.Gaussians), train "
                      f"{len(train)} samples ({TRAIN_TRAJ} trajectories), val {len(val)}",
              "data_format": data_format, "data_write_s": data_s,
              "data_bytes_written": data_bytes, "batch": BATCH,
              "steps": steps, "train_wall_s": train_wall,
              "epoch_train_time_s": [h["train_time_s"] for h in history],
              "steps_per_s_epoch1": 1.0 / step_s, "samples_per_s_epoch1": BATCH / step_s,
              "step_ms_epoch1": step_s * 1e3,
              "note_epoch1": "epoch 1: 4 steps, loader and one mid-epoch checkpoint included",
              "checkpoint_write_s": ckpt_s,
              "steps_per_s_epoch1_without_checkpoint": 4 / max(epoch1_s - ckpt_s, 1e-9),
              "bare_train_step_ms": bare_step_ms, "loader_ms_per_batch": loader_ms,
              "bare_step_ms_fixed_batch": [turns[0], turns[3]],
              "bare_step_ms_loader_batches": [turns[1], turns[2]],
              "trainer_step_ms_no_checkpoint": trainer_step_ms,
              "profiled_steps": [1, 2], "device_busy_ms_profiled": busy_ms,
              "profiled_span_ms": span_ms,
              "device_idle_share_of_profiled_span": max(0.0, 1.0 - busy_ms / span_ms),
              "device_idle_share_vs_epoch1_step": max(0.0, 1.0 - busy_ms / 2 / (step_s * 1e3)),
              "launches_per_step": {k: v / steps for k, v in counts.items() if v},
              "launches_ok": counts_ok, "train_losses": [want[s]["loss"] for s in sorted(want)],
              "eval": ev, "eval_s": eval_s, "predict_ar_steps": 2, "predict_shape": pred_shape,
              "predict_metrics": {k: v for k, v in pred.metrics.items() if "/" not in k},
              "predict_s": predict_s,
              "resume": {"from": "checkpoint-1-step2", "steps_compared": sorted(got),
                         "bitwise": bitwise, "cudnn_deterministic": True,
                         "max_loss_diff": max(loss_diff.values()) if loss_diff else None,
                         "max_weight_diff": weight_diff[worst], "worst_weight": worst,
                         "nondeterministic_grads": dict(list(nondet.items())[:8]),
                         "ok": resume_ok},
              "ok": ok, "card": card})
        if not ok:
            raise SystemExit("trainer phase failed")
        return counts, steps
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det


# ---------------------------------------------------------------------------
# Gradient checkpointing, the command lines, intermediates
# ---------------------------------------------------------------------------

REMAT_MODES = (False, True, "save_all", "save_dots")
REMAT_RATES = {"hidden_dropout_prob": 0.1, "drop_path_rate": 0.1}
REMAT_REL_TOL = 1e-6   # relative L2 of the whole gradient, each mode vs no checkpointing
CLI_TRAIN_TRAJ = 32    # x 3 (t1, t2) pairs at times 0 and 2 = 96 samples: 3 steps an epoch
CLI_FINETUNE_TRAJ = 64  # Poisson-Gauss samples: 2 steps at batch 32
CLI_REL_TOL = 1e-4     # eval metrics, general kernels vs plain path (fp32)
INTERMEDIATES_BATCH = 8
EMBED_RECOVERY = {"embeddings.patch_embeddings.projection.weight",
                  "patch_recovery.projection.weight", "patch_recovery.projection.bias",
                  "patch_recovery.mixup.weight"}


def phase_remat(pt, wa, mlp_op, model, card):
    """Gradient checkpointing on the card: ScOT-B bf16 b32 with hidden
    dropout and drop-path 0.1 (masks from a CUDA generator) on the weights
    of the model phase. Under each ``remat`` mode the loss and gradients of
    one step and the generator's end state, against the step without
    checkpointing (same weights, batch and generator seed): loss equal,
    gradient relative L2 <= REMAT_REL_TOL, generator state equal; launches
    (True and "save_dots" run every block's forward kernels twice); then a
    full train step (AdamW) per mode, timed in two rounds (modes in order,
    then reversed), with its peak memory. The peak under True must be below
    the peak without checkpointing."""
    cfg = model.config.replace(**REMAT_RATES)
    m = pt.ScOT(cfg, dtype=torch.bfloat16)
    m.load_state_dict(model.state_dict(), strict=True)
    m = m.to("cuda").train()
    batch = train_batch()
    torch.cuda.synchronize()
    live_gib = torch.cuda.memory_allocated() / 2 ** 30

    def grads(mode):
        m.remat = mode
        m.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(11)
        reset_counts()
        loss, _ = pt.forward_with_loss(m, batch["pixel_values"], batch["time"], batch["labels"],
                                       batch["pixel_mask"], generator=gen)
        loss.backward()
        torch.cuda.synchronize()
        counts = read_counts()
        vec = torch.cat([p.grad.float().flatten() for p in m.parameters()])
        return float(loss.detach()), vec, gen.get_state(), counts

    loss0, vec0, state0, _ = grads(False)
    per_step = block_launches(m, wa, mlp_op, backward=True)
    rows, ok = {}, True
    for mode in REMAT_MODES:
        loss, vec, state, counts = grads(mode)
        want = dict(per_step)
        if mode in (True, "save_dots"):
            for name in want:
                if name.endswith("_fwd"):
                    want[name] *= 2
        rel = float((vec - vec0).norm() / vec0.norm())
        row = {"loss": loss, "loss_equal": loss == loss0, "grad_rel_l2": rel,
               "grads_bit_identical": bool(torch.equal(vec, vec0)),
               "generator_state_equal": bool(torch.equal(state, state0)),
               "launches": counts, "launches_expected": want}
        row["ok"] = (row["loss_equal"] and rel <= REMAT_REL_TOL and row["generator_state_equal"]
                     and counts == want and math.isfinite(loss))
        ok = ok and row["ok"]
        rows[str(mode)] = row
        del vec
    del vec0
    m.zero_grad(set_to_none=True)
    opt, sched = pt.build_optimizer(m, learning_rate=1e-4, total_steps=10_000, weight_decay=1e-6,
                                    lr_scheduler_type="cosine", warmup_ratio=0.0)
    for order in (REMAT_MODES, REMAT_MODES[::-1]):
        for mode in order:
            m.remat = mode
            gen = torch.Generator(device="cuda").manual_seed(12)

            def step():
                return pt.train_step(m, opt, sched, batch, max_grad_norm=5.0, generator=gen)

            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = host_ms(step, iters=3, warmup=1)
            row = rows[str(mode)]
            row.setdefault("train_step_ms", []).append(ms)
            row["peak_memory_gib"] = max(row.get("peak_memory_gib", 0.0),
                                         torch.cuda.max_memory_allocated() / 2 ** 30)
    remat_counts = rows["True"]["launches"]
    ok = ok and rows["True"]["peak_memory_gib"] < rows["False"]["peak_memory_gib"]
    emit({"phase": "remat", "model": "ScOT-B 128x128 c4 bf16 conditioned, hidden dropout 0.1, "
                                     "drop-path 0.1", "batch": BATCH,
          "weights": "those of the model phase", "generator": "CUDA, seed 11 (timed: 12)",
          "tol": REMAT_REL_TOL, "modes": rows,
          "memory_allocated_before_gib": live_gib,
          "timing": "train step (forward, backward, clip, AdamW) host ms, median of 3 after 1 "
                    "warm-up, two rounds: modes in order, then reversed",
          "ok": ok, "card": card})
    if not ok:
        raise SystemExit("remat phase failed")
    del m, opt, sched
    torch.cuda.empty_cache()
    return remat_counts


def write_poisson_gauss(path, n_train):
    """A sparse Poisson-Gauss dataset in the ``.npy`` directory format:
    ``source`` and ``solution`` (20000, 128, 128) f32, rows written for the
    train split [0, n_train), val and test (the last 360): a blocky random
    source and a smoothed, scaled copy of it as the solution."""
    rng = np.random.default_rng(1)
    rows = list(range(n_train)) + list(range(20000 - 360, 20000))

    def fill(arrays):
        for i in rows:
            src = np.kron(rng.normal(size=(16, 16)), np.ones((8, 8))).astype(np.float32) * 4.7
            arrays["source"][i] = src
            arrays["solution"][i] = 0.005 * (src + np.roll(src, 3, 0) + np.roll(src, 3, 1))
        return len(rows)

    return _write_npy_dir(path, {"source": (20000, 128, 128), "solution": (20000, 128, 128)},
                          fill)


def write_ns_gauss(path, times):
    """A sparse NS-Gauss dataset in the ``.npy`` directory format:
    ``velocity`` (20000, 21, 2, 128, 128) f32, its test split (the last 240
    trajectories) written at ``times``: the input of ``eval_resolutions``,
    whose datasets downsample spectrally (the compressible ones do not)."""
    rng = np.random.default_rng(2)

    def fill(arrays):
        v = arrays["velocity"]
        for i in range(20000 - 240, 20000):
            base = np.kron(rng.normal(size=(2, 16, 16)), np.ones((8, 8))).astype(np.float32)
            for tt in times:
                v[i, tt] = base * np.float32(np.exp(-0.03 * tt))
        return 240 * len(times)

    return _write_npy_dir(path, {"velocity": (20000, 21, 2, 128, 128)}, fill)


def _kernels_ran(counts, names):
    return all(counts[n] > 0 for n in names)


WGMMA_PATH = ("window_attention_fwd", "window_attention_bwd", "fused_mlp_fwd", "fused_mlp_bwd")
GENERAL_FWD = ("window_attention_general_fwd", "mlp_general_fwd")


def phase_cli_train(pt, wa, mlp_op, card, root):
    """``python -m poseidon_tpu_torch.train`` in process (``main(argv)``,
    a JSON config): ScOT-B (``model_name`` "B"), bf16 compute,
    ``attention_impl`` "pallas", two epochs of three steps at batch 32 on
    a synthetic CE-Gauss file (times 0 and 2, ``--max_num_train_time_steps
    1 --train_time_step_size 2``), ``save_steps`` 2, evaluation each epoch.
    Checks the run directory (``logs.jsonl``, ``checkpoint-*``, ``best/``,
    ``model/``, ``config.json``), the launches (every step's and every
    evaluation forward's, exactly), finite epoch train losses, the second
    under the first. Then ``save_pretrained`` of
    the trained model, and the fine-tune onto a sparse Poisson-Gauss
    directory (1 channel in and out, no time): the surgery
    (``from_pretrained(config=...)``) replaces exactly the embedding and
    recovery tensors among the checkpoint's, and the plain norms the
    unconditioned model has in place of the conditional ones; every other
    tensor equals the export bit for bit before the first step; the CLI
    with ``--replace_embedding_recovery`` reports the same list and trains
    through the kernels; without the flag it fails on the channel
    mismatch. W&B is disabled: no run name is given."""
    import contextlib
    import io

    from poseidon_tpu_torch import hub
    from poseidon_tpu_torch import train as ptrain

    os.environ["WANDB_MODE"] = "disabled"
    os.environ.pop("WANDB_SWEEP_ID", None)
    data = os.path.join(root, "data")
    os.makedirs(data)
    t0 = time.perf_counter()
    write_ce_gauss(os.path.join(data, "CE-Gauss.nc"), train_traj=CLI_TRAIN_TRAJ,
                   train_times=(0, 2), val_times=(0, 2), test_times=(0, 2, 4))
    write_poisson_gauss(os.path.join(data, "Poisson-Gauss.nc"), CLI_FINETUNE_TRAJ)
    data_s = time.perf_counter() - t0
    ckpt = os.path.join(root, "ckpt")
    config = {"dataset": "fluids.compressible.Gaussians", "num_trajectories": CLI_TRAIN_TRAJ,
              "model_name": "B", "lr": 5e-4, "weight_decay": 1e-6, "lr_scheduler": "cosine",
              "warmup_ratio": 0.0, "num_epochs": 2, "batch_size": BATCH, "max_grad_norm": 5.0,
              "attention_impl": "pallas", "compute_dtype": "bfloat16", "save_steps": 2}
    argv = ["--config", json.dumps(config), "--json_config", "--data_path", data,
            "--checkpoint_path", ckpt, "--wandb_project_name", "smoke",
            "--max_num_train_time_steps", "1", "--train_time_step_size", "2"]
    reset_counts()
    t0 = time.perf_counter()
    trainer = ptrain.main(argv)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    counts = read_counts()
    run_dir = os.path.join(ckpt, "smoke", os.listdir(os.path.join(ckpt, "smoke"))[0])
    listing = sorted(os.listdir(run_dir))
    with open(os.path.join(run_dir, "logs.jsonl")) as fh:
        logs = [json.loads(line) for line in fh]
    epochs = [r for r in logs if "train_time_s" in r]
    epoch_losses = [r["train_loss"] for r in epochs]
    steps = trainer.step
    n_eval = len(epochs) * math.ceil(len(trainer.eval_dataset) / BATCH)
    per_step = block_launches(trainer.model, wa, mlp_op, backward=True)
    per_fwd = block_launches(trainer.model, wa, mlp_op)
    want = {k: steps * per_step[k] + n_eval * per_fwd[k] for k in per_step}
    layout_ok = (all(x in listing for x in ("logs.jsonl", "best", "model", "config.json"))
                 and any(x.startswith("checkpoint-") for x in listing))
    train_ok = (layout_ok and counts == want and _kernels_ran(counts, WGMMA_PATH)
                and steps == 2 * 3 and len(epoch_losses) == 2
                and all(math.isfinite(v) for v in epoch_losses)
                and epoch_losses[1] < epoch_losses[0])
    export = os.path.join(root, "export")
    t0 = time.perf_counter()
    hub.save_pretrained(trainer.model, export)
    export_s = time.perf_counter() - t0
    del trainer
    torch.cuda.empty_cache()

    # The fine-tune: the surgery as the CLI does it, checked before any step.
    ft_config = {"dataset": "elliptic.poisson.Gaussians", "num_trajectories": CLI_FINETUNE_TRAJ,
                 "model_name": "B", "lr": 5e-4, "lr_embedding_recovery": 1e-3,
                 "weight_decay": 1e-6, "num_epochs": 1, "batch_size": BATCH,
                 "max_grad_norm": 5.0, "attention_impl": "pallas", "compute_dtype": "bfloat16"}
    ft_ds = pt.get_dataset(ft_config["dataset"], which="train",
                           num_trajectories=CLI_FINETUNE_TRAJ, data_path=data)
    mcfg = ptrain.build_model_config({**ft_config, **pt.MODEL_MAP["B"]}, ft_ds,
                                     ptrain.is_time_involved(ft_ds))
    model, info = pt.from_pretrained(export, config=mcfg, ignore_mismatched_sizes=True,
                                     device="cuda", dtype=torch.bfloat16,
                                     output_loading_info=True)
    exported = hub.load_state_dict(export)
    replaced = set(info["replaced"])
    mismatched = {k for k in replaced if k in exported}
    absent = replaced - mismatched
    sd = model.state_dict()
    kept_equal = all(torch.equal(v.cpu(), exported[k]) for k, v in sd.items() if k not in replaced)
    surgery_ok = (mismatched == EMBED_RECOVERY and bool(absent)
                  and all(k not in exported and (".norm." in k or "layernorm" in k)
                          for k in absent)
                  and kept_equal and not mcfg.use_conditioning)
    del model, sd
    torch.cuda.empty_cache()
    ft_argv = ["--config", json.dumps(ft_config), "--json_config", "--data_path", data,
               "--checkpoint_path", os.path.join(root, "ft"), "--wandb_project_name", "smoke",
               "--finetune_from", export]
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        ft = ptrain.main(ft_argv + ["--replace_embedding_recovery"])
    torch.cuda.synchronize()
    ft_wall = time.perf_counter() - t0
    ft_counts = read_counts()
    printed = next((ln for ln in out.getvalue().splitlines() if ln.startswith("Re-initialized")),
                   "")
    printed_names = set(printed.split(": ", 1)[1].split(", ")) if ": " in printed else set()
    ft_logs = [json.loads(line) for line in open(os.path.join(ft.args.output_dir, "logs.jsonl"))]
    ft_losses = [r["train_loss"] for r in ft_logs if "train_time_s" in r]
    test_loss = ft_logs[-1].get("test/loss")
    ft_ok = (printed_names == replaced and ft.config.num_channels == 1
             and _kernels_ran(ft_counts, WGMMA_PATH) and ft.step == 2 and len(ft_losses) == 1
             and all(math.isfinite(v) for v in ft_losses)
             and test_loss is not None and math.isfinite(test_loss))
    del ft
    torch.cuda.empty_cache()
    try:
        ptrain.main(ft_argv)
        no_flag_error = None
    except ValueError as e:
        no_flag_error = str(e)
    no_flag_ok = no_flag_error is not None and "replace_embedding_recovery" in no_flag_error
    ok = train_ok and surgery_ok and ft_ok and no_flag_ok
    emit({"phase": "cli_train", "data": "synthetic CE-Gauss (train 32 trajectories at t 0, 2; "
                                        "val 120; test 240 at t 0, 2, 4) and Poisson-Gauss "
                                        "(64 train rows), sparse .npy directories",
          "data_write_s": data_s, "config": config, "run_dir_listing": listing,
          "steps": steps, "evaluation_forwards": n_eval, "launches": counts,
          "launches_expected": want, "epoch_train_loss": epoch_losses, "wall_s": train_wall,
          "train_time_s": [r["train_time_s"] for r in epochs],
          "train_steps_per_s": steps / sum(r["train_time_s"] for r in epochs),
          "eval_loss": [r.get("eval_loss") for r in epochs], "export_s": export_s,
          "finetune": {"config": ft_config, "replaced_mismatched": sorted(mismatched),
                       "replaced_absent_from_checkpoint": len(absent),
                       "absent_examples": sorted(absent)[:4],
                       "kept_tensors_equal_to_export": kept_equal,
                       "cli_reported_same_list": printed_names == replaced,
                       "launches": ft_counts, "epoch_train_loss": ft_losses,
                       "test_loss": test_loss,
                       "wall_s": ft_wall, "no_flag_error": no_flag_error},
          "ok": ok, "card": card})
    if not ok:
        raise SystemExit("cli_train phase failed")
    return run_dir, data, counts, ft_counts


def _csv_rows(path):
    import csv

    with open(path) as fh:
        return list(csv.DictReader(fh))


def phase_cli_inference(pt, card, run_dir, data, root):
    """``python -m poseidon_tpu_torch.inference`` in process on the trained
    run directory, fp32 (every attention and MLP call on the general
    kernels: 64 and 32 a forward, launches counted exactly): ``eval``
    direct and with ``--ar_steps 2`` on the CE-Gauss test split (240
    samples, t 0 -> 4), ``save_samples``, ``eval_accumulation_error``
    (steps at t 2 and 4) and ``eval_resolutions`` at 64 and 128 on an
    NS-Gauss test split (same channels; its dataset downsamples). The
    ``eval`` metrics are held to a plain-path run of the same mode (the run
    directory's weights under a config with ``attention_impl`` "xla") within
    relative CLI_REL_TOL; wall s and samples/s of ``eval``."""
    from poseidon_tpu_torch import inference as pinf

    write_ns_gauss(os.path.join(data, "NS-Gauss.nc"), (0, 4))
    plain_dir = os.path.join(root, "plain")
    os.makedirs(plain_dir)
    os.symlink(os.path.join(run_dir, "model"), os.path.join(plain_dir, "model"))
    with open(os.path.join(run_dir, "config.json")) as fh:
        cfg = json.load(fh)
    with open(os.path.join(plain_dir, "config.json"), "w") as fh:
        json.dump({**cfg, "attention_impl": "xla"}, fh)
    out = os.path.join(root, "inference")
    ce = "fluids.compressible.Gaussians"
    n_test = 240
    fwd = math.ceil(n_test / BATCH)

    def run(mode, file, *extra, model=run_dir, dataset=ce):
        argv = ["--mode", mode, "--model_path", model, "--data_path", data, "--dataset", dataset,
                "--file", os.path.join(out, file), "--initial_time", "0", "--final_time", "4",
                "--batch_size", str(BATCH), *extra]
        reset_counts()
        t0 = time.perf_counter()
        pinf.main(argv)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, read_counts()

    def general(n_forwards):
        return launches(window_attention_general_fwd=64 * n_forwards,
                        mlp_general_fwd=32 * n_forwards)

    rows = {}
    eval_s, c = run("eval", "eval.csv")
    rows["eval"] = {"wall_s": eval_s, "samples_per_s": n_test / eval_s, "launches": c,
                    "launches_ok": c == general(fwd)}
    plain_s, c = run("eval", "eval_plain.csv", model=plain_dir)
    rows["eval_plain_path"] = {"wall_s": plain_s, "launches": c, "launches_ok": c == launches()}
    got, want = _csv_rows(os.path.join(out, "eval.csv"))[0], \
        _csv_rows(os.path.join(out, "eval_plain.csv"))[0]
    metric_keys = [k for k in want if k not in ("model", "dataset", "initial_time",
                                                "final_time", "ar_steps")]
    rel = {k: abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-30)
           for k in metric_keys}
    rows["eval"]["metrics"] = {k: float(got[k]) for k in metric_keys}
    rows["eval"]["max_rel_vs_plain_path"] = max(rel.values())
    s, c = run("eval", "eval_ar.csv", "--ar_steps", "2")
    rows["eval_ar2"] = {"wall_s": s, "launches": c, "launches_ok": c == general(2 * fwd),
                        "loss": float(_csv_rows(os.path.join(out, "eval_ar.csv"))[0]["loss"])}
    s, c = run("save_samples", "samples", "--num_samples", "4", "--ar_steps", "2")
    shapes = {n: list(np.load(os.path.join(out, "samples", f"{n}.npy")).shape)
              for n in ("inputs", "predictions", "labels")}
    rows["save_samples"] = {"wall_s": s, "launches": c, "launches_ok": c == general(2 * fwd),
                            "shapes": shapes,
                            "shapes_ok": all(v == [4, 4, 128, 128] for v in shapes.values())}
    s, c = run("eval_accumulation_error", "accumulation.csv", "--time_step_size", "2")
    acc = _csv_rows(os.path.join(out, "accumulation.csv"))
    rows["eval_accumulation_error"] = {
        "wall_s": s, "launches": c, "launches_ok": c == general(2 * fwd),
        "rows": len(acc), "final_times": [int(r["final_time"]) for r in acc],
        "mean_relative_l1_error": [float(r["mean_relative_l1_error"]) for r in acc]}
    s, c = run("eval_resolutions", "resolutions.csv", "--resolutions", "64", "128",
               dataset="fluids.incompressible.Gaussians")
    res = _csv_rows(os.path.join(out, "resolutions.csv"))
    rows["eval_resolutions"] = {
        "wall_s": s, "launches": c, "launches_ok": c == general(2 * fwd),
        "resolutions": [int(r["resolution"]) for r in res],
        "loss": [float(r["loss"]) for r in res]}
    ok = (all(r.get("launches_ok", True) for r in rows.values())
          and rows["eval"]["max_rel_vs_plain_path"] <= CLI_REL_TOL
          and all(math.isfinite(v) for v in rows["eval"]["metrics"].values())
          and math.isfinite(rows["eval_ar2"]["loss"]) and rows["save_samples"]["shapes_ok"]
          and rows["eval_accumulation_error"]["final_times"] == [2, 4]
          and rows["eval_resolutions"]["resolutions"] == [64, 128]
          and all(math.isfinite(v) for v in rows["eval_resolutions"]["loss"]))
    emit({"phase": "cli_inference", "model": "the cli_train run directory, fp32 compute",
          "test_samples": n_test, "batch": BATCH, "tol": CLI_REL_TOL, "modes": rows,
          "ok": ok, "card": card})
    if not ok:
        raise SystemExit("cli_inference phase failed")
    return rows["eval"]["launches"]


def phase_intermediates(pt, attn_mod, card):
    """``forward_with_intermediates`` on ScOT-B fp32 at batch 8 (weights of
    the model phase's recipe): the prediction against the kernel-path
    forward (relative L2 <= FP32_REL_TOL), 8 hidden states of the stages'
    shapes, 64 attention tensors (N*nW, heads, T, T) whose rows sum to 1,
    no kernel launched during the call, and the model unchanged after it
    (its ``attention_impl``, the launches and the output of its next
    forward); then ``rollout_with_intermediates`` with 2 steps at batch 2,
    every tensor stacked on axis 1."""
    cfg = pt.make_config("B", image_size=128, num_channels=4, num_out_channels=4,
                         channel_slice_list=(0, 1, 3, 4), use_conditioning=True,
                         attention_impl="pallas")
    model = pt.build_model(cfg, device="cuda", dtype=torch.float32, seed=0)
    perturb_attention(model, attn_mod.WindowAttention, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(2)
    b = INTERMEDIATES_BATCH
    x = torch.randn(b, 4, 128, 128, generator=gen).to("cuda")
    t = torch.full((b,), 0.5, device="cuda")
    with torch.no_grad():
        reset_counts()
        ref = model(x, t)
        torch.cuda.synchronize()
        before = read_counts()
        reset_counts()
        t0 = time.perf_counter()
        pred, hs, att = pt.forward_with_intermediates(model, x, t)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        during = read_counts()
        reset_counts()
        again = model(x, t)
        torch.cuda.synchronize()
        after = read_counts()
    rel = float((pred - ref).norm() / ref.norm())
    want_hs = [(b, (32 >> i) ** 2, 96 << i) for i in range(4)]
    want_hs += want_hs[::-1]
    hs_shapes = [tuple(h.shape) for h in hs]
    att_shapes = sorted({tuple(a.shape) for a in att})
    n_att = len(att)
    row_err = max(float((a.sum(-1) - 1.0).abs().max()) for a in att)
    att_bytes = sum(a.numel() * a.element_size() for a in att)
    del hs, att
    torch.cuda.empty_cache()
    with torch.no_grad():
        r_pred, r_hs, r_att = pt.rollout_with_intermediates(model, x[:2], t[:2], 2)
    roll = {"predictions": list(r_pred.shape), "hidden_states": len(r_hs),
            "attentions": len(r_att), "hidden_state_0": list(r_hs[0].shape),
            "attention_0": list(r_att[0].shape)}
    roll_ok = (roll["predictions"] == [2, 2, 4, 128, 128] and len(r_hs) == 8 and len(r_att) == 64
               and all(h.shape[:2] == (2, 2) for h in r_hs)
               and all(a.shape[1] == 2 for a in r_att) and bool(torch.isfinite(r_pred).all()))
    del r_pred, r_hs, r_att
    ok = (rel <= FP32_REL_TOL and hs_shapes == want_hs and n_att == 64 and row_err <= 1e-5
          and during == launches() and before == after
          and before == launches(window_attention_general_fwd=64, mlp_general_fwd=32)
          and model.config.attention_impl == "pallas" and bool(torch.equal(again, ref))
          and roll_ok)
    emit({"phase": "intermediates", "model": "ScOT-B 128x128 c4 fp32 conditioned", "batch": b,
          "rel_l2_vs_kernel_path": rel, "tol": FP32_REL_TOL, "hidden_state_shapes": hs_shapes,
          "attentions": n_att, "attention_shapes": att_shapes, "max_row_sum_error": row_err,
          "attention_gib": att_bytes / 2 ** 30, "call_s": call_s,
          "launches_before": before, "launches_during": during, "launches_after": after,
          "rollout_with_intermediates": roll, "ok": ok, "card": card})
    if not ok:
        raise SystemExit("intermediates phase failed")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Data parallelism
# ---------------------------------------------------------------------------

DP_ROWS = 16          # global batch of the check runs: 8 a rank on two ranks
DP_STEPS = 3
DP_TIMED = 4          # steps timed (after the run's own) for steps/s
DP_LOSS_TOL = 5e-3    # per step, relative: bf16, another summation order
DP_NORM_TOL = 1e-3    # the grad norm of each step, relative
DP_PARAM_TOL = 1e-3   # relative L2 of all parameters after DP_STEPS
# Four cards only: (size, num_model_shards, rows a rank) of the throughput
# and memory cells.
DP_CELLS = (("B", 1, 32), ("B", 2, 32), ("L", 1, 8), ("L", 4, 8))


class DPData:
    """The data parallel phase's train set, made in memory from a seed and
    the same in every process: CE-Gauss-shaped samples (4 channels,
    128 x 128, blocky fields), the labels a decayed copy of the inputs whose
    scale differs from sample to sample (so that each rank's rows differ in
    label scale, which the loss's normalisers must see whole)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(7000 + i)
        x = np.kron(rng.normal(size=(4, 16, 16)), np.ones((8, 8))).astype(np.float32)
        t = np.float32(0.1 + 0.1 * (i % 8))
        return {"pixel_values": x, "labels": x * np.float32(np.exp(-t) * (1 + i % 3)),
                "time": t}


def dp_trainer(pt, size, out, rows_global, n, model_shards=1):
    """A Trainer of seeded ScOT-``size`` (bf16 compute, ``"pallas"``) on
    ``DPData(n)`` at the global batch ``rows_global``, on this process's
    card, with the process group's mesh when there is one."""
    cfg = pt.make_config(size, image_size=128, num_channels=4, num_out_channels=4,
                         channel_slice_list=(0, 1, 3, 4), use_conditioning=True,
                         attention_impl="pallas")
    device = torch.device("cuda", torch.cuda.current_device())
    model = pt.build_model(cfg, device=device, dtype=torch.bfloat16, seed=0)
    args = pt.TrainingArguments(
        output_dir=out, train_batch_size=rows_global, eval_batch_size=rows_global,
        num_train_epochs=1, learning_rate=1e-4, weight_decay=1e-6, max_grad_norm=5.0,
        logging_steps=1, save_total_limit=1, num_workers=4, num_model_shards=model_shards)
    return pt.Trainer(model, args, train_dataset=DPData(n), device=device)


def dp_timed(trainer, rows_global, profile):
    """Steps/s of ``DP_TIMED`` train steps on one fixed global batch (this
    rank's rows of it), after two warm-up steps; with ``profile``, also the
    device ms a step of the NCCL kernels and of all kernels over two steps
    (torch.profiler)."""
    from poseidon_tpu_torch.parallel.mesh import shard_batch

    ds = trainer.train_dataset
    batch = {k: np.stack([np.asarray(ds[i][k]) for i in range(rows_global)])
             for k in ("pixel_values", "labels", "time")}
    if trainer.mesh is not None:
        batch = shard_batch(batch, trainer.mesh)
    dev = {k: torch.from_numpy(v).to(trainer.device) for k, v in batch.items()}

    def step():
        trainer._train_step(dev, trainer.step)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_TIMED):
        step()
    torch.cuda.synchronize()
    out = {"steps_per_s": DP_TIMED / (time.perf_counter() - t0)}
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(2):
                step()
            torch.cuda.synchronize()
        kernels = [e for e in p.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        out["device_ms_per_step"] = sum(dev_us(e) for e in kernels) / 2e3
        out["nccl_ms_per_step"] = sum(dev_us(e) for e in kernels if "nccl" in e.key.lower()) / 2e3
    return out


def dp_local_hash(model):
    """SHA-256 of this rank's parameters as it holds them (FSDP: its
    shards), in name order."""
    import hashlib

    from torch.distributed.tensor import DTensor

    h = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        t = p.to_local() if isinstance(p, DTensor) else p
        h.update(name.encode())
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_run(pt, wa, mlp_op, out, model_shards, profile):
    """One check run: ``Trainer.train`` of seeded ScOT-B over ``DP_STEPS``
    steps at the global batch ``DP_ROWS`` (launches counted from just
    before to just after it), then timed steps."""
    trainer = dp_trainer(pt, "B", out, DP_ROWS, DP_ROWS * DP_STEPS, model_shards)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trainer.train()
    torch.cuda.synchronize()
    counts = read_counts()
    per_step = block_launches(trainer.model, wa, mlp_op, backward=True)
    res = {"launches": counts,
           "launches_ok": counts == {k: DP_STEPS * v for k, v in per_step.items()},
           "launches_per_step": {k: v // DP_STEPS for k, v in counts.items() if v},
           "param_hash": dp_local_hash(trainer.model),
           "model_index": trainer.mesh["model"].get_local_rank() if trainer.mesh else 0}
    if model_shards > 1:
        from poseidon_tpu_torch.parallel.mesh import assert_opt_state_sharded

        res["moments_sharded"] = assert_opt_state_sharded(trainer.optimizer, trainer.mesh)
    res.update(dp_timed(trainer, DP_ROWS, profile))
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def dp_cell(pt, size, model_shards, rows, world, profile):
    """A throughput and memory cell: ScOT-``size`` at ``rows`` a rank
    (global batch ``rows * world / model_shards``), peak memory a card over
    one train step, and the timed steps."""
    rows_global = rows * world // model_shards
    trainer = dp_trainer(pt, size, tempfile.mkdtemp(prefix="chip_smoke_cell_"), rows_global,
                         rows_global * (DP_TIMED + 4), model_shards)
    torch.cuda.reset_peak_memory_stats()
    res = dp_timed(trainer, rows_global, profile)
    res.update({"size": size, "model_shards": model_shards, "rows_a_rank": rows,
                "global_batch": rows_global, "world": world,
                "samples_per_s": res["steps_per_s"] * rows_global,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    del trainer
    torch.cuda.empty_cache()
    return res


def dp_worker(rank: int, world: int, root: str) -> None:
    """One rank of the data parallel phase (``chip_smoke.py --dp-worker
    rank world root``): joins the group (NCCL on a card of its own, else
    gloo) by the file store in ``root``, runs the spec's check runs and
    cells, and writes its results to ``root/rank<r>.json``."""
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import poseidon_tpu_torch as pt
    from poseidon_tpu_torch.ops import mlp as mlp_op, window_attention as wa

    with open(os.path.join(root, "spec.json")) as f:
        spec = json.load(f)
    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(spec["backend"], init_method=f"file://{root}/rendezvous",
                            rank=rank, world_size=world)
    profile = spec["backend"] == "nccl"
    try:
        out = {"rank": rank, "device": torch.cuda.current_device(),
               "runs": {name: dp_run(pt, wa, mlp_op, os.path.join(root, name), shards, profile)
                        for name, shards in spec["runs"]},
               "cells": [dp_cell(pt, *cell, world, profile) for cell in spec["cells"]]}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def dp_reference(pt, root):
    """The check run in this process: the same steps at the same global
    batch on one card; the step log, the final parameters (on the CPU) and
    the timed steps."""
    out = os.path.join(root, "one_process")
    trainer = dp_trainer(pt, "B", out, DP_ROWS, DP_ROWS * DP_STEPS)
    torch.cuda.reset_peak_memory_stats()
    trainer.train()
    params = {k: v.float().cpu() for k, v in trainer.model.state_dict().items()}
    res = dp_timed(trainer, DP_ROWS, profile=False)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del trainer
    torch.cuda.empty_cache()
    return dp_step_log(out), params, res


def dp_step_log(out):
    with open(os.path.join(out, "logs.jsonl")) as fh:
        return [r for r in map(json.loads, fh) if "step" in r]


def dp_rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def phase_data_parallel(pt, card):
    """The Trainer over a process group on the card(s): ``world`` worker
    processes of this script (``dp_worker``), with two or more cards one a
    card over NCCL, with one card two on it over gloo (DDP on CUDA tensors:
    NCCL refuses two ranks on one device). Check runs: DDP (and, with two
    cards or more, HSDP over a model axis of 2) take ``DP_STEPS`` steps of
    seeded ScOT-B bf16 at the global batch ``DP_ROWS``, held to the same
    steps in this process: every step's loss (``DP_LOSS_TOL``) and grad
    norm (``DP_NORM_TOL``), the parameters after the steps (relative L2
    ``DP_PARAM_TOL``, from the checkpoint process 0 wrote), the kernels'
    launches on every rank (64/64/32/32 a step), and the replicas'
    parameters bit-identical. With four cards, also ``DP_CELLS``, and their
    one-card baselines in this process. Prints
    steps/s, samples/s, peak memory a card and, with NCCL, the NCCL
    kernels' device ms a step. Any rank's failure fails the phase."""
    cards = torch.cuda.device_count()
    world = cards if cards >= 2 else 2
    backend = "nccl" if cards >= 2 else "gloo"
    runs = [("ddp", 1)] + ([("hsdp", 2)] if cards >= 2 and world % 2 == 0 else [])
    if len(runs) == 1:
        print("data_parallel: HSDP (FSDP over a model axis) needs two cards; not run",
              flush=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        t0 = time.perf_counter()
        ref_log, ref_params, ref_timed = dp_reference(pt, root)
        ref_s = time.perf_counter() - t0
        spec = {"backend": backend, "runs": runs,
                "cells": DP_CELLS if cards >= 4 else ()}
        # The cells' one-card baselines (the model axis 1, one process).
        one_cells = [dp_cell(pt, size, 1, rows, 1, False)
                     for size, rows in sorted({(c[0], c[2]) for c in spec["cells"]})]
        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        logs = [open(os.path.join(root, f"rank{r}.log"), "w") for r in range(world)]
        # One OpenMP thread a rank unless the caller says otherwise, as
        # torchrun starts its processes.
        env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-worker",
                                   str(r), str(world), root], stdout=logs[r],
                                  stderr=subprocess.STDOUT, env=env) for r in range(world)]
        deadline = time.monotonic() + (900 if spec["cells"] else 420)
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for fh in logs:
                fh.close()
        workers_s = time.perf_counter() - t0
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            for r in failed:
                with open(os.path.join(root, f"rank{r}.log")) as fh:
                    print(f"data_parallel rank {r} (rc {procs[r].returncode}):\n"
                          + fh.read()[-6000:], file=sys.stderr, flush=True)
            raise SystemExit(f"data_parallel phase failed: ranks {failed}")
        ranks = []
        for r in range(world):
            with open(os.path.join(root, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        checks = {}
        for name, _ in runs:
            out = os.path.join(root, name)
            log = dp_step_log(out)
            params = torch.load(os.path.join(out, "checkpoint-0", "state.pt"),
                                map_location="cpu", weights_only=True)["model"]
            num = sum(float((params[k].float() - v).pow(2).sum()) for k, v in ref_params.items())
            den = sum(float(v.pow(2).sum()) for v in ref_params.values())
            res = [rk["runs"][name] for rk in ranks]
            hashes = {}
            for rr in res:
                hashes.setdefault(rr["model_index"], set()).add(rr["param_hash"])
            c = {"steps": [r["step"] for r in log], "loss": [r["loss"] for r in log],
                 "loss_one_process": [r["loss"] for r in ref_log],
                 "grad_norm": [r["grad_norm"] for r in log],
                 "grad_norm_one_process": [r["grad_norm"] for r in ref_log],
                 "param_rel_l2": math.sqrt(num / den),
                 "launches_per_step": [rr["launches_per_step"] for rr in res],
                 "replicas_bit_identical": all(len(h) == 1 for h in hashes.values()),
                 "steps_per_s": [rr["steps_per_s"] for rr in res],
                 "samples_per_s": res[0]["steps_per_s"] * DP_ROWS,
                 "peak_gib": [rr["peak_gib"] for rr in res],
                 "nccl_ms_per_step": res[0].get("nccl_ms_per_step"),
                 "device_ms_per_step": res[0].get("device_ms_per_step")}
            if "moments_sharded" in res[0]:
                c["moments_sharded"] = [rr["moments_sharded"] for rr in res]
            c["ok"] = (len(log) == len(ref_log) == DP_STEPS
                       and all(dp_rel(a, b) <= DP_LOSS_TOL
                               for a, b in zip(c["loss"], c["loss_one_process"]))
                       and all(dp_rel(a, b) <= DP_NORM_TOL
                               for a, b in zip(c["grad_norm"], c["grad_norm_one_process"]))
                       and c["param_rel_l2"] <= DP_PARAM_TOL
                       and all(rr["launches_ok"] for rr in res)
                       and c["replicas_bit_identical"]
                       and all(m > 0 for m in c.get("moments_sharded", [1])))
            checks[name] = c
        cells = [{**rk0, "peak_gib_ranks": [rk["cells"][i]["peak_gib"] for rk in ranks]}
                 for i, rk0 in enumerate(ranks[0]["cells"])]
        ok = all(c["ok"] for c in checks.values())
        emit({"phase": "data_parallel", "world": world, "cards": cards, "backend": backend,
              "global_batch": DP_ROWS, "steps": DP_STEPS, "model": "ScOT-B bf16 pallas",
              "one_process": {**ref_timed, "samples_per_s": ref_timed["steps_per_s"] * DP_ROWS,
                              "seconds": ref_s},
              "checks": checks, "hsdp": "hsdp" in checks, "cells": cells,
              "one_process_cells": one_cells,
              "workers_s": workers_s, "ok": ok, "card": card,
              "tolerances": {"loss": DP_LOSS_TOL, "grad_norm": DP_NORM_TOL,
                             "param_rel_l2": DP_PARAM_TOL}})
        if not ok:
            raise SystemExit("data_parallel phase failed")
        return ranks[0]["runs"]["ddp"]["launches"]
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# The bench
# ---------------------------------------------------------------------------

# bench_torch.py from its command line: eager (with the ScOT-L entry), then
# its CUDA-graph mode; seconds each may take.
BENCH_RUNS = (({}, 900), ({"BENCH_SCAN": "10", "BENCH_SKIP_L": "1"}, 600))
BENCH_WARMUP = 2        # steps before the 3 compared, eager and on the graph's side stream
BENCH_GRAPH_TOL = 1e-6  # relative L2, graph replays vs eager steps (losses, parameters)


def bench_line(env, timeout, want_l):
    """``python bench_torch.py`` in a subprocess with ``env`` added: its one
    JSON line, checked (value > 0, 0 < mfu <= 1.05, the card's name and
    power limit, the ScOT-L entry without an error when ``want_l``)."""
    root = Path(__file__).resolve().parent
    res = subprocess.run([sys.executable, str(root / "bench_torch.py")], cwd=root,
                         env=dict(os.environ, **env), capture_output=True, text=True,
                         timeout=timeout)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    line = json.loads(lines[0]) if len(lines) == 1 else None
    extra = (line or {}).get("extra", {})
    ok = (res.returncode == 0 and line is not None and line["value"] > 0
          and line["metric"] == "samples_per_sec_per_chip_scot_b_pretrain"
          and extra.get("mfu") is not None and 0 < extra["mfu"] <= 1.05
          and bool(extra.get("device")) and extra.get("power_limit_w") is not None
          and (not want_l or ("scot_l" in extra and "error" not in extra["scot_l"])))
    if not ok:
        print(res.stdout[-4000:], res.stderr[-8000:], sep="\n", file=sys.stderr, flush=True)
    return line, ok


def bench_graph_vs_eager():
    """``bench_torch.GraphStep`` held to eager steps at ScOT-B b32, from the
    same seeded weights and optimizer: ``BENCH_WARMUP`` steps (eager; on the
    graph's side stream before its capture), then three steps each way.
    Gated: three replays against three eager steps of the graph's own
    optimizer (capturable AdamW, LR in device tensors; ``capture=False``),
    losses and parameters within relative L2 ``BENCH_GRAPH_TOL``, and
    launches 64/64/32/32 a step; the replays' losses against eager
    ``train_step`` with the default AdamW within the same. Printed: the
    parameters against that default AdamW, whose arithmetic rounds
    otherwise (``GraphStep``'s docstring)."""
    import bench_torch as bt

    cfg = bt.bench_config("B")
    data = bt.make_batch(cfg, BATCH, "cuda")
    runs = {}
    for mode in ("eager", "eager_capturable", "graph"):
        model, opt, sched = bt.build(cfg, "cuda")
        if mode == "eager":
            for _ in range(BENCH_WARMUP):
                bt.eager_step(model, opt, sched, data)

            def step():
                return bt.eager_step(model, opt, sched, data)
        else:
            step = bt.GraphStep(model, opt, sched, data, warmup=BENCH_WARMUP,
                                capture=mode == "graph")
            graph_launches = step.launches_per_step
        losses = torch.stack([step()["loss"].clone() for _ in range(3)])
        runs[mode] = (losses, torch.cat([p.detach().flatten() for p in model.parameters()]))
        del model, opt, sched, step
        torch.cuda.empty_cache()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    lg, pg = runs["graph"]
    cmp = {}
    for ref in ("eager_capturable", "eager"):
        lr_, pr = runs[ref]
        cmp[ref] = {"losses": lr_.tolist(), "loss_rel_l2": rel(lg, lr_),
                    "param_rel_l2": rel(pg, pr), "loss_max_abs_diff": float((lg - lr_).abs().max()),
                    "param_max_abs_diff": float((pg - pr).abs().max())}
    want = launches(window_attention_fwd=64, window_attention_bwd=64, fused_mlp_fwd=32,
                    fused_mlp_bwd=32)
    same = cmp["eager_capturable"]
    ok = (same["loss_rel_l2"] <= BENCH_GRAPH_TOL and same["param_rel_l2"] <= BENCH_GRAPH_TOL
          and cmp["eager"]["loss_rel_l2"] <= BENCH_GRAPH_TOL and graph_launches == want)
    return {"what": f"ScOT-B b{BATCH}: {BENCH_WARMUP} steps, then 3 graph replays vs 3 eager "
                    "steps from the same seeded weights and optimizer",
            "graph_losses": lg.tolist(), "vs": cmp, "tol": BENCH_GRAPH_TOL,
            "graph_launches_per_step": {k: v for k, v in graph_launches.items() if v},
            "ok": ok}


def bench_profiles(line):
    """Where a bench step's device time goes, eager and as a CUDA graph:
    ``device_time_profile`` of one ScOT-B and one ScOT-L step at the bench's
    batches (the eager idle share against the eager step time of the
    bench's line; the graph's against its replay's wall time, median of 5),
    the graph's replay ms, and each size's seconds."""
    import bench_torch as bt

    def profile(fn, wall_ms):
        prof = device_time_profile(fn, wall_ms)
        return {k: prof[k] for k in ("device_busy_ms", "device_idle_share", "device_kernels",
                                     "busy_ms_by_group")}

    out = {}
    for size, res in (("B", line["extra"]), ("L", line["extra"]["scot_l"])):
        t0 = time.perf_counter()
        cfg = bt.bench_config(size)
        data = bt.make_batch(cfg, res["batch"], "cuda")
        model, opt, sched = bt.build(cfg, "cuda")
        eager = profile(lambda: bt.eager_step(model, opt, sched, data), res["step_time_ms"])
        del model, opt, sched
        torch.cuda.empty_cache()
        model, opt, sched = bt.build(cfg, "cuda")
        graph = bt.GraphStep(model, opt, sched, data)
        replay_ms = host_ms(graph, iters=5)
        out[f"ScOT-{size} b{res['batch']}"] = {
            "eager": eager, "graph": {"replay_ms": replay_ms, **profile(graph, replay_ms)},
            "seconds": time.perf_counter() - t0}
        del model, opt, sched, data, graph
        torch.cuda.empty_cache()
    return out


def phase_bench(card):
    """``bench_torch.py``, the port's train-step bench, run twice from its
    command line (eager with the ScOT-L entry; ``BENCH_SCAN=10``, a CUDA
    graph of one step replayed), each line checked and printed; then, in
    this process, the graph's step held to eager steps
    (``bench_graph_vs_eager``) and the device time by group of eager and
    graph steps (``bench_profiles``)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    lines, oks, flops = [], [], {}
    for env, timeout in BENCH_RUNS:
        line, ok = bench_line({**env, **flops}, timeout, want_l="BENCH_SKIP_L" not in env)
        lines.append(line)
        oks.append(ok)
        if line is not None:  # the count does not depend on the mode
            flops = {"BENCH_FLOPS": repr(line["extra"]["flops_per_step"])}
        print(json.dumps(line), flush=True)
    graph = bench_graph_vs_eager()
    ok = all(oks) and graph["ok"]
    profiles = bench_profiles(lines[0]) if oks[0] else None
    emit({"phase": "bench", "runs": [env for env, _ in BENCH_RUNS], "lines_ok": oks,
          "graph_vs_eager": graph, "eager_step_profiles": profiles,
          "seconds": time.perf_counter() - t0, "ok": ok, "card": card})
    if not ok:
        raise SystemExit("bench phase failed")


def kernels_line(results, bwd_results, cln_results, op_results, per_forward, rollout_counts,
                 step_counts, tail_forward, tail_counts, op_counts, general, f32_counts,
                 odd_counts, trainer_counts, trainer_steps, b32_counts, general_tail, paths):
    """One entry per hand-written kernel. ``launches`` is the count from the
    path that runs it: the train step (the first four; with the Trainer's
    steps beside it), the fused-tail train step (the tail's two), the op's
    forward + backward path (the separate-q/k/v attention's two), the fp32
    ScOT-B train step (the general kernels, with the fp32 ScOT-T and the
    mlp_ratio-3, D = 24 ScOT-T steps' counts beside it), the fp32 ScOT-B
    fused-tail train step (the general tail kernels, ``general_tail``: with
    its forward's and rollout's counts, and the fused-tail fp32 ScOT-T and
    mlp_ratio-3 ScOT-T steps' beside it). ``paths`` adds,
    to every entry, its launches in each later path (``<path>_launches``:
    the remat step, the train CLI, the fine-tune, the inference CLI's
    ``eval``)."""
    def entry(name, source, replaces, rows, shape_prefix, counts, **extra):
        row = next(r for r in rows if r["model"] == "B" and r["shape"].startswith(shape_prefix))
        b_rows = [r for r in rows if r["model"] == "B"]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, **extra,
                "launches": counts[name],
                "max_abs_err": max(r["max_abs_err"] for r in b_rows),
                "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                **({"device_ms": row["kernel_device_ms"],
                    "library_device_ms": row["library_device_ms"]}
                   if "kernel_device_ms" in row else {}),
                "shape": "ScOT-B b32 " + row["shape"]}

    def main_path(name):
        return {"forward_launches": per_forward[name], "rollout_launches": rollout_counts[name],
                "train_step_launches": step_counts[name],
                "trainer_launches_per_step": trainer_counts[name] / trainer_steps}

    def general_entry(name, source, replaces, rows, prefix, **extra):
        row = next(r for r in rows if r["model"] == "B-fp32" and r["shape"].startswith(prefix))
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, **extra,
                "launches": b32_counts[name], "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "device_ms": row["kernel_device_ms"],
                "library_device_ms": row["library_device_ms"],
                "shape": "ScOT-B fp32 b32 " + row["shape"],
                "path": "ScOT-B fp32 train step (launches); ScOT-T fp32 step: "
                        f"{f32_counts[name]}; D = 24, F = 3C bf16 step: {odd_counts[name]}"}

    def general_tail_entry(name, replaces, rows):
        row = next(r for r in rows if r["model"] == "B-fp32" and r["shape"].startswith("stage0"))
        g = general_tail
        return {"name": name, "route": "cuda", "source": csrc + "mlp_cln_general.cu",
                "replaces": replaces, "launches": g["step"][name],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "device_ms": row["kernel_device_ms"],
                "library_device_ms": row["library_device_ms"],
                "shape": "ScOT-B fp32 b32 " + row["shape"],
                "fused_tail_forward_launches": g["forward"][name],
                "fused_tail_rollout_launches": g["rollout"][name],
                "path": "ScOT-B fp32 fused-tail train step (launches); ScOT-T fp32 fused-tail "
                        f"step: {g['T_fp32'][name]}; D = 24, F = 3C bf16 fused-tail step: "
                        f"{g['T_odd'][name]}"}

    def tail_path(name):
        return {"fused_tail_forward_launches": tail_forward[name],
                "fused_tail_train_step_launches": tail_counts[name]}

    csrc = "poseidon_tpu_torch/csrc/"
    tail_rows = general_tail["kernels"]
    op_path = "fused_window_attention forward + backward, every ScOT-B/L/T shape and T=49"
    return _with_paths({"kernels": [
        entry("window_attention_fwd", csrc + "window_attention.cu",
              "poseidon_tpu/ops/window_attention.py:131", results["attention"], "stage0_shifted",
              step_counts, **main_path("window_attention_fwd")),
        entry("window_attention_bwd", csrc + "window_attention_bwd.cu",
              "poseidon_tpu/ops/window_attention.py:215", bwd_results["attention"],
              "stage0_shifted", step_counts, **main_path("window_attention_bwd")),
        entry("fused_mlp_fwd", csrc + "mlp.cu", "poseidon_tpu/ops/mlp.py:149",
              results["mlp"], "stage0", step_counts, also_replaces="poseidon_tpu/ops/mlp.py:87",
              **main_path("fused_mlp_fwd")),
        entry("fused_mlp_bwd", csrc + "mlp_bwd.cu", "poseidon_tpu/ops/mlp.py:157",
              bwd_results["mlp"], "stage0", step_counts,
              also_replaces="poseidon_tpu/ops/mlp.py:114, poseidon_tpu/ops/mlp.py:130",
              **main_path("fused_mlp_bwd")),
        entry("fused_window_attention_fwd", csrc + "window_attention.cu",
              "poseidon_tpu/ops/window_attention.py:126", op_results["fwd"], "stage0_shifted",
              op_counts, path=op_path),
        entry("fused_window_attention_bwd", csrc + "window_attention_bwd.cu",
              "poseidon_tpu/ops/window_attention.py:201", op_results["bwd"], "stage0_shifted",
              op_counts, path=op_path),
        entry("mlp_cln_fwd", csrc + "mlp_cln.cu", "poseidon_tpu/ops/mlp.py:272",
              cln_results["fwd"], "stage0", tail_counts, **tail_path("mlp_cln_fwd")),
        entry("mlp_cln_bwd", csrc + "mlp_cln_bwd.cu", "poseidon_tpu/ops/mlp.py:284",
              cln_results["bwd"], "stage0", tail_counts, **tail_path("mlp_cln_bwd")),
        general_entry("window_attention_general_fwd", csrc + "window_attention_general.cu",
                      "poseidon_tpu/ops/window_attention.py:131", general["attention_fwd"],
                      "stage0_shifted", also_replaces="poseidon_tpu/ops/window_attention.py:126"),
        general_entry("window_attention_general_bwd", csrc + "window_attention_general.cu",
                      "poseidon_tpu/ops/window_attention.py:215", general["attention_bwd"],
                      "stage0_shifted", also_replaces="poseidon_tpu/ops/window_attention.py:201"),
        general_entry("mlp_general_fwd", csrc + "mlp_general.cu", "poseidon_tpu/ops/mlp.py:149",
                      general["mlp_fwd"], "stage0", also_replaces="poseidon_tpu/ops/mlp.py:87"),
        general_entry("mlp_general_bwd", csrc + "mlp_general.cu", "poseidon_tpu/ops/mlp.py:157",
                      general["mlp_bwd"], "stage0",
                      also_replaces="poseidon_tpu/ops/mlp.py:114, poseidon_tpu/ops/mlp.py:130"),
        general_tail_entry("mlp_cln_general_fwd", "poseidon_tpu/ops/mlp.py:272", tail_rows["fwd"]),
        general_tail_entry("mlp_cln_general_bwd", "poseidon_tpu/ops/mlp.py:284", tail_rows["bwd"]),
    ]}, paths)


def _with_paths(line, paths):
    for entry in line["kernels"]:
        for path, counts in paths.items():
            entry[f"{path}_launches"] = counts[entry["name"]]
    return line


DP_SOURCES = ("window_attention", "window_attention_bwd", "mlp", "mlp_bwd")


def phase_dp_environment(build):
    """``--phase data_parallel`` or ``bench``: the cards (name and power limit, and how
    they are linked) and the build of the sources the bf16 train step
    runs."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                          timeout=60).stdout
    print(topo, flush=True)
    card = smi.splitlines()[0] if smi else ""
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    seconds = build.build(DP_SOURCES)
    emit({"phase": "environment", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "cards": torch.cuda.device_count(), "nvidia_smi": smi.splitlines(),
          "nvcc_seconds": seconds, "build_wall_s": time.perf_counter() - t0})
    return card


def main(argv) -> int:
    if argv[:1] == ["--dp-worker"]:
        dp_worker(int(argv[1]), int(argv[2]), argv[3])
        return 0
    if argv not in ([], ["--phase", "data_parallel"], ["--phase", "bench"]):
        print("usage: chip_smoke.py [--phase data_parallel|bench]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import poseidon_tpu_torch as pt
    from poseidon_tpu_torch.models import attention as attn_mod
    from poseidon_tpu_torch.ops import _build, mlp as mlp_op, window_attention as wa_mod
    from poseidon_tpu_torch.utils.device import bound_ms

    if argv:
        card = phase_dp_environment(_build)
        if argv[1] == "bench":
            phase_bench(card)
        else:
            phase_data_parallel(pt, card)
        emit(device_line())
        return 0
    card = phase_environment(_build, wa_mod, mlp_op)
    results = phase_kernels(pt, wa_mod, mlp_op, attn_mod, bound_ms, card)
    model, x, t, per_forward, forward_ms = phase_model(pt, wa_mod, mlp_op, attn_mod, card)
    phase_profile(model, x, t, forward_ms, card)
    rollout_counts = phase_rollout(pt, model, x, t, per_forward, card)
    bwd_results = phase_bwd_kernels(pt, wa_mod, mlp_op, attn_mod, bound_ms, card)
    step, step_counts, step_ms = phase_train(pt, wa_mod, mlp_op, model, card)
    phase_train_profile(step, step_ms, card)
    cln_results = phase_cln_kernels(pt, mlp_op, bound_ms, card)
    op_results, op_counts = phase_fused_attention(pt, wa_mod, attn_mod, bound_ms, card)
    tail_model, _, _, tail_forward, _ = phase_model(pt, wa_mod, mlp_op, attn_mod, card,
                                                    fused_tail=True)
    tail_step, tail_counts, tail_step_ms = phase_train(pt, wa_mod, mlp_op, tail_model, card,
                                                       fused_tail=True)
    phase_train_profile(tail_step, tail_step_ms, card, fused_tail=True)
    phase_tail_vs_unfused(model, tail_model, x, t, step, tail_step, card)
    del tail_model, tail_step, step
    # ScOT-T (embed 48: D = 16 at every stage): forward and train step.
    t_model, *_ = phase_model(pt, wa_mod, mlp_op, attn_mod, card, size="T")
    phase_train(pt, wa_mod, mlp_op, t_model, card, size="T")
    del t_model
    # The general kernels: at their shapes, then ScOT-T in fp32 (every
    # attention and MLP call on them) and ScOT-T with D = 24 and F = 3C.
    general = phase_general_kernels(pt, wa_mod, mlp_op, attn_mod, bound_ms, card)
    f32_model, *_ = phase_model(pt, wa_mod, mlp_op, attn_mod, card, size="T",
                                dtype=torch.float32, tol=FP32_REL_TOL, name="model_T_fp32")
    _, f32_counts, _ = phase_train(pt, wa_mod, mlp_op, f32_model, card, size="T",
                                   tol=FP32_REL_TOL, name="train_T_fp32")
    del f32_model
    odd_model, *_ = phase_model(pt, wa_mod, mlp_op, attn_mod, card, size="T", overrides=ODD,
                                name="model_T_odd")
    _, odd_counts, _ = phase_train(pt, wa_mod, mlp_op, odd_model, card, size="T",
                                   name="train_T_odd")
    del odd_model
    # ScOT-B in fp32 (the serving dtype of the inference CLI): the general
    # kernels at full width and depth.
    _, _, b32_counts = phase_fp32_b(pt, wa_mod, mlp_op, attn_mod, card)
    # The general tail kernels: at their shapes, then ScOT-T in fp32 and
    # with D = 24 and F = 3C in bf16, and ScOT-B in fp32, under the fused
    # tail.
    general_cln = phase_general_cln_kernels(pt, mlp_op, bound_ms, card)
    t_tail = {}
    for key, dtype, over, tol in (("T_fp32", torch.float32, None, FP32_REL_TOL),
                                  ("T_odd", torch.bfloat16, ODD, MODEL_REL_TOL)):
        tmodel, *_ = phase_model(pt, wa_mod, mlp_op, attn_mod, card, fused_tail=True, size="T",
                                 dtype=dtype, overrides=over, tol=tol,
                                 name=f"model_{key}_tail")
        _, t_tail[key], _ = phase_train(pt, wa_mod, mlp_op, tmodel, card, fused_tail=True,
                                        size="T", tol=FP32_REL_TOL if over is None
                                        else GRAD_REL_TOL, name=f"train_{key}_tail")
        del tmodel
    b32_tail = dict(zip(("forward", "rollout", "step"),
                        phase_fp32_b(pt, wa_mod, mlp_op, attn_mod, card, fused_tail=True)))
    # The Trainer.
    trainer_counts, trainer_steps = phase_trainer(pt, wa_mod, mlp_op, card, step_ms)
    # Gradient checkpointing, the two command lines, intermediates.
    remat_counts = phase_remat(pt, wa_mod, mlp_op, model, card)
    del model
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        run_dir, data, cli_counts, ft_counts = phase_cli_train(pt, wa_mod, mlp_op, card, root)
        inference_counts = phase_cli_inference(pt, card, run_dir, data, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_intermediates(pt, attn_mod, card)
    dp_counts = phase_data_parallel(pt, card)
    phase_bench(card)
    paths = {"remat_step": remat_counts, "cli_train": cli_counts, "cli_finetune": ft_counts,
             "cli_inference_eval": inference_counts, "data_parallel_rank0": dp_counts}
    emit(kernels_line(results, bwd_results, cln_results, op_results, per_forward,
                      rollout_counts, step_counts, tail_forward, tail_counts, op_counts, general,
                      f32_counts, odd_counts, trainer_counts, trainer_steps, b32_counts,
                      {**b32_tail, **t_tail, "kernels": general_cln}, paths))
    emit(device_line())
    return 0


def device_line():
    return {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
