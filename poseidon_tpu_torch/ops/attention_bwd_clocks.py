"""Where the window-attention backward kernel's time goes: a build of
``csrc/window_attention_bwd.cu`` with ``-DATTN_BWD_CLOCKS``, in which thread
0 of each CTA adds the SM clocks (``clock64``) of each phase of its walk
into counters.

    python -m poseidon_tpu_torch.ops.attention_bwd_clocks    # one CUDA card

The build goes to ``build/kernels/variants/``. At ScOT-B/L/T batch-32
shapes (and ScOT-B b128 stage 0) it calls the build once through the
packed-QKV entry with the plan of ``ops.window_attention`` and prints one
JSON line: each phase's clocks per CTA and per tile, averaged over the
CTAs, the walk's length, and the clocks of the whole CTA. Its outputs are
checked bit for bit against ``window_attention_bwd`` (the counters only
read the clock).
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from . import _build
from . import window_attention as wa

PHASES = ("prologue", "wait for the tile's rows", "staging", "S and dP",
          "statistics (+ CS > 1: last strip's dq)", "ds, dbm, ds and dO/den tiles",
          "products (D = 64: with dq out)", "dq out", "the tile's last dq (CS > 1)", "dk, dv",
          "next tile's copies (one stage)", "the walk's end")
CLK_N = 12


def build_clocks() -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "libwindow_attention_bwd_clocks.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DATTN_BWD_CLOCKS", "-o", str(out),
           str(_build.CSRC / "window_attention_bwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the clocks build:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.window_attention_bwd.argtypes = list(wa._BWD_SIGNATURES["window_attention_bwd"])
    lib.window_attention_bwd.restype = ctypes.c_int
    lib.window_attention_bwd_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.window_attention_bwd_clocks.restype = ctypes.c_int
    return lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("attention_bwd_clocks: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    print(card)
    lib = build_clocks()
    import poseidon_tpu_torch as pt
    cases = []
    for name, batch in (("B", 32), ("L", 32), ("T", 32), ("B", 128)):
        cfg = pt.make_config(name, image_size=128, num_channels=4, num_out_channels=4)
        for i in range(cfg.num_stages):
            window, _ = cfg.stage_window_and_shift(i, False)
            if batch == 128 and i > 0:
                continue
            res, heads = cfg.stage_resolution(i), cfg.num_heads[i]
            cases.append((f"{name} b{batch} stage{i}", batch * (res // window) ** 2,
                          window * window, heads, cfg.stage_dim(i) // heads))
    gen = torch.Generator().manual_seed(0)
    for tag, n, t, heads, d in cases:
        c = heads * d
        qkv = torch.randn(n, t, 3 * c, generator=gen).to("cuda", torch.bfloat16)
        qb = (0.1 * torch.randn(c, generator=gen)).cuda()
        bm = (16.0 * torch.sigmoid(torch.randn(1, heads, t, t, generator=gen))).cuda()
        scale = torch.full((heads,), 10.0, device="cuda")
        do = torch.randn(n, t, c, generator=gen).to("cuda", torch.bfloat16)
        ref = wa.window_attention_bwd(qkv, qb, bm, scale, heads, do)
        pack, groups, ctas = wa.bwd_plan(n, 1, heads, t, wa.bwd_resident_clusters(t, d))
        dqkv = torch.empty_like(qkv)
        _, f32 = wa._bwd_scratch(n, t, heads, d, 1, qkv.device)
        err = lib.window_attention_bwd(
            qkv.data_ptr(), qb.data_ptr(), bm.data_ptr(), scale.data_ptr(), do.data_ptr(),
            dqkv.data_ptr(), *(a.data_ptr() for a in f32), n, t, heads, d, 1, groups,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"clocks build launch failed: CUDA error {err}")
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip((dqkv,) + f32[:3], ref))
        rows = min(ctas, 8192)
        buf = (ctypes.c_ulonglong * (rows * CLK_N))()
        err = lib.window_attention_bwd_clocks(ctypes.addressof(buf), rows)
        if err != 0:
            raise RuntimeError(f"reading the clocks failed: CUDA error {err}")
        clk = torch.tensor(list(buf), dtype=torch.float64).reshape(rows, CLK_N)
        tiles = -(-(n // 1) // pack)
        walk = tiles / groups
        mean = clk.mean(dim=0)
        print(json.dumps({
            "shape": f"{tag}: windows={n} T={t} H={heads} D={d}", "P": pack, "G": groups,
            "ctas": ctas, "tiles_per_cta": walk, "bits_match_kernel": same,
            "cta_clocks": float(clk.sum(dim=1).mean()),
            "per_cta": {p: float(v) for p, v in zip(PHASES, mean)},
            "per_tile": {p: float(v) / walk for p, v in zip(PHASES, mean)}, "card": card}),
            flush=True)


if __name__ == "__main__":
    main()
