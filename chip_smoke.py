#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of poseidon-tpu on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, one JSON line each (any failure ends the run with a non-zero exit):

1. environment: versions, the card (nvidia-smi name and power limit on a
   line of its own), the nvcc build of every kernel from csrc/, TF32 off;
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, bf16, at every shape the ScOT-B batch-32 serving path gives it
   (and ScOT-L's), with kernel / plain / library times (CUDA events, median
   of 20 after warm-up) and the least time the card could take (bound);
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
6. the kernels line; 7. the device line, last.

Exits non-zero without printing results when CUDA is absent.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

BATCH = 32
ITERS = 20
ATTN_TOL = 3e-2   # bf16 output, allclose atol = rtol: rounding-order flips only
MLP_TOL = 3e-2
MODEL_REL_TOL = 3e-2  # relative L2, kernel path vs plain path, bf16 end to end


def emit(obj) -> None:
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


def phase_environment(build):
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
                    if "registers" in ln or "spill" in ln]
             for name in build.SOURCES}
    emit({"phase": "environment", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "csrc": str(build.CSRC), "build_dir": str(build.BUILD_DIR),
          "nvcc_seconds": seconds, "build_wall_s": wall,
          "ptxas": ptxas, "tf32": "off for matmul and cudnn (comparisons in full fp32/bf16)"})
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


def attention_case(attn_mod, n, t, heads, d, nw, window, res, shift, gen):
    c = heads * d
    dev = "cuda"
    qkv = torch.randn(n, t, 3 * c, generator=gen).to(dev, torch.bfloat16)
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


def attention_library_call(qkv, qb, bm, scale, heads):
    """One PyTorch call computing the same attention on pre-normalised
    inputs (timed only; the port never calls it)."""
    n, t, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q, k, v = qkv.reshape(n, t, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    q = q + qb.reshape(heads, 1, d).to(q.dtype)
    qs = (F.normalize(q.float(), dim=-1) * scale.reshape(heads, 1, 1)).to(qkv.dtype)
    kn = F.normalize(k.float(), dim=-1).to(qkv.dtype)
    nw = bm.shape[0]
    mask = bm.to(qkv.dtype).unsqueeze(0).expand(n // nw, nw, heads, t, t).reshape(n, heads, t, t)
    v = v.contiguous()
    return lambda: F.scaled_dot_product_attention(qs, kn, v, attn_mask=mask, scale=1.0)


def attention_bound(n, t, heads, d, nw, bound_ms):
    c = heads * d
    flops = 4.0 * n * heads * t * t * d
    nbytes = n * t * 3 * c * 2 + c * 4 + nw * heads * t * t * 4 + heads * 4 + n * t * c * 2
    return bound_ms(flops, nbytes)


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
    for model_name, cfg in (("B", cfg_b), ("L", cfg_l)):
        for tag, n, t, heads, d, nw, window, res, shift in attention_shapes(cfg, BATCH):
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
                   "library_ms": cuda_ms(attention_library_call(qkv, qb, bm, scale, heads)),
                   "bound_ms": bms, "bound_by": by, "card": card}
            emit(row)
            results["attention"].append(row)
            if not ok:
                raise SystemExit(f"window_attention kernel disagrees at {row['shape']}")
            del qkv, out, ref
        for tag, m, c, f in mlp_shapes(cfg, BATCH, mlp_op):
            x = torch.randn(m, c, generator=gen).to("cuda", torch.bfloat16)
            w1 = (torch.randn(f, c, generator=gen) / math.sqrt(c)).to("cuda", torch.bfloat16)
            w2 = (torch.randn(c, f, generator=gen) / math.sqrt(f)).to("cuda", torch.bfloat16)
            b1 = (0.1 * torch.randn(f, generator=gen)).to("cuda")
            b2 = (0.1 * torch.randn(c, generator=gen)).to("cuda")
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
                   "bound_ms": bms, "bound_by": by, "card": card}
            emit(row)
            results["mlp"].append(row)
            if not ok:
                raise SystemExit(f"mlp kernel disagrees at {row['shape']}")
    return results


# ---------------------------------------------------------------------------
# Model and rollout
# ---------------------------------------------------------------------------

def reset_counts(wa, mlp_op):
    wa.window_attention.launches = 0
    mlp_op.mlp.launches = 0


def read_counts(wa, mlp_op):
    return {"window_attention_fwd": wa.window_attention.launches,
            "fused_mlp_fwd": mlp_op.mlp.launches}


@torch.no_grad()
def perturb_attention(model, attention_cls, gen):
    """Make the model's output depend on every head's attention pattern.

    At init the CPB bias is about 8 everywhere, every logit scale is 10 and
    the q/v biases are 0, so a kernel that read bm, the scale or the q-bias
    of the wrong head or window would still agree with the plain path. And
    the conditional norms of the embedding and after each attention scale by
    about 0.01, so the tokens are nearly alike and the output hardly depends
    on any attention pattern. So: the CPB MLP, logit scales and q/v biases
    are redrawn from ``gen``, and those norms' scales set to about 1."""
    def draw(p, std):
        p.copy_((std * torch.randn(p.shape, generator=gen)).to(p.device))

    model.embeddings.norm.weight.bias.fill_(1.0)
    for mod in model.modules():
        norm = getattr(mod, "layernorm_before", None)
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


def phase_model(pt, wa, mlp_op, attn_mod, card):
    cfg = pt.make_config("B", image_size=128, num_channels=4, num_out_channels=4,
                         channel_slice_list=(0, 1, 3, 4), use_conditioning=True,
                         attention_impl="pallas")
    t0 = time.perf_counter()
    model = pt.build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    perturb_attention(model, attn_mod.WindowAttention, torch.Generator().manual_seed(3))
    plain = pt.ScOT(cfg.replace(attention_impl="xla"), dtype=torch.bfloat16)
    plain.load_state_dict(model.state_dict(), strict=True)
    plain = plain.to("cuda").eval()
    build_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(BATCH, 4, 128, 128, generator=gen).to("cuda")
    t = torch.full((BATCH,), 0.5, device="cuda")

    with torch.no_grad():
        y_plain = plain(x, t)
        torch.cuda.synchronize()
        reset_counts(wa, mlp_op)
        y = model(x, t)
        torch.cuda.synchronize()
        counts = read_counts(wa, mlp_op)
        fwd_ms = host_ms(lambda: model(x, t), iters=5)
        plain_fwd_ms = host_ms(lambda: plain(x, t), iters=5)
    rel = float((y - y_plain).norm() / y_plain.norm())
    ok = (tuple(y.shape) == (BATCH, 4, 128, 128) and bool(torch.isfinite(y).all())
          and rel <= MODEL_REL_TOL
          and counts == {"window_attention_fwd": 64, "fused_mlp_fwd": 32})
    emit({"phase": "model", "model": "ScOT-B 128x128 c4 bf16 conditioned", "batch": BATCH,
          "weights": "seed 0 init; CPB MLP, logit scales, q/v biases redrawn (seed 3); "
                     "embedding and post-attention norm scales 1",
          "params": sum(p.numel() for p in model.parameters()), "build_s": build_s,
          "rel_l2_vs_plain_path": rel, "tol": MODEL_REL_TOL,
          "out_rms": float(y.float().pow(2).mean().sqrt()),
          "forward_ms": fwd_ms, "samples_per_s": BATCH / (fwd_ms / 1e3),
          "plain_path_forward_ms": plain_fwd_ms, "launches_per_forward": counts,
          "ok": ok, "card": card})
    if not ok:
        raise SystemExit("model phase failed")
    return model, x, t, counts, fwd_ms


def phase_profile(model, x, t, forward_ms, card):
    """Where one kernel-path forward spends device time: torch.profiler over
    one forward, device busy time (sum of kernel self times), and the
    kernels that take the most. The idle share is taken against the
    unprofiled forward time (``forward_ms``): the profiler's own host work
    stretches the profiled wall time, not the device's."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        model(x, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x, t)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3

    def dev_us(evt):
        return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)

    # Device-side events only (kernels, memcpy/memset): the CPU ops that
    # launched them carry the same time again.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    groups = {}
    for e in kernels:
        name = e.key.lower()
        if "window_attention_fwd_kernel" in name or "mlp_fwd_kernel" in name:
            g = "port kernels"
        elif any(k in name for k in ("gemm", "xmma", "cutlass", "sm90", "cublas")):
            g = "library GEMMs"
        elif "conv" in name or "cudnn" in name:
            g = "convolutions"
        else:
            g = "elementwise, reductions, copies"
        groups[g] = groups.get(g, 0.0) + dev_us(e) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    emit({"phase": "profile", "what": "one kernel-path ScOT-B b32 forward",
          "forward_ms": forward_ms, "profiled_wall_ms": wall, "device_busy_ms": busy,
          "device_idle_share": max(0.0, 1.0 - busy / forward_ms),
          "device_idle_share_of_profiled_wall": max(0.0, 1.0 - busy / wall),
          "device_kernels": sum(e.count for e in kernels), "busy_ms_by_group": groups,
          "top_device": [{"name": e.key[:80], "count": e.count, "ms": dev_us(e) / 1e3}
                         for e in top], "card": card})


def phase_rollout(pt, wa, mlp_op, model, x, t, per_forward, card):
    steps = 4
    with torch.no_grad():
        reset_counts(wa, mlp_op)
        y = pt.autoregressive_rollout(model, x, t, ar_steps=steps, num_out_channels=4,
                                      device="cuda")
        torch.cuda.synchronize()
        counts = read_counts(wa, mlp_op)
        roll_ms = host_ms(lambda: pt.autoregressive_rollout(
            model, x, t, ar_steps=steps, num_out_channels=4, device="cuda"), iters=3, warmup=1)
    ok = (tuple(y.shape) == (BATCH, 4, 128, 128) and bool(torch.isfinite(y).all())
          and counts == {k: steps * v for k, v in per_forward.items()})
    emit({"phase": "rollout", "ar_steps": steps, "batch": BATCH, "rollout_ms": roll_ms,
          "final_rms": float(y.float().pow(2).mean().sqrt()), "launches": counts,
          "ok": ok, "card": card})
    if not ok:
        raise SystemExit("rollout phase failed")
    return counts


def kernels_line(results, per_forward, rollout_counts):
    def pick(rows, shape_prefix):
        return next(r for r in rows if r["model"] == "B" and r["shape"].startswith(shape_prefix))

    attn = pick(results["attention"], "stage0_shifted")
    mlp = pick(results["mlp"], "stage0")
    b_attn = [r for r in results["attention"] if r["model"] == "B"]
    b_mlp = [r for r in results["mlp"] if r["model"] == "B"]
    return {"kernels": [
        {"name": "window_attention_fwd", "route": "cuda",
         "source": "poseidon_tpu_torch/csrc/window_attention.cu",
         "replaces": "poseidon_tpu/ops/window_attention.py:131",
         "launches": per_forward["window_attention_fwd"],
         "rollout_launches": rollout_counts["window_attention_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in b_attn),
         "ms": attn["kernel_ms"], "plain_ms": attn["plain_ms"], "bound_ms": attn["bound_ms"],
         "bound_by": attn["bound_by"], "library_ms": attn["library_ms"],
         "shape": "ScOT-B b32 " + attn["shape"]},
        {"name": "fused_mlp_fwd", "route": "cuda", "source": "poseidon_tpu_torch/csrc/mlp.cu",
         "replaces": "poseidon_tpu/ops/mlp.py:149",
         "also_replaces": "poseidon_tpu/ops/mlp.py:87",
         "launches": per_forward["fused_mlp_fwd"],
         "rollout_launches": rollout_counts["fused_mlp_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in b_mlp),
         "ms": mlp["kernel_ms"], "plain_ms": mlp["plain_ms"], "bound_ms": mlp["bound_ms"],
         "bound_by": mlp["bound_by"], "library_ms": mlp["library_ms"],
         "shape": "ScOT-B b32 " + mlp["shape"]},
    ]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import poseidon_tpu_torch as pt
    from poseidon_tpu_torch.models import attention as attn_mod
    from poseidon_tpu_torch.ops import _build, mlp as mlp_op, window_attention as wa_mod
    from poseidon_tpu_torch.utils.device import bound_ms

    card = phase_environment(_build)
    results = phase_kernels(pt, wa_mod, mlp_op, attn_mod, bound_ms, card)
    model, x, t, per_forward, forward_ms = phase_model(pt, wa_mod, mlp_op, attn_mod, card)
    phase_profile(model, x, t, forward_ms, card)
    rollout_counts = phase_rollout(pt, wa_mod, mlp_op, model, x, t, per_forward, card)
    emit(kernels_line(results, per_forward, rollout_counts))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
