"""Window cosine attention, forward and backward: the Hopper kernels'
wrappers, their plain PyTorch versions, and the autograd Function that
joins them.

Per (window, head) pair, with q/k/v read out of the fused QKV GEMM output::

    q  = q + qb                                  (rounded to the input dtype)
    qn = q / max(||q||, 1e-12);   kn = k / max(||k||, 1e-12)     (fp32)
    S  = cast(scale[h] * qn) @ cast(kn)^T + bm[n mod nW, h]      (fp32 accumulate)
    O  = cast(exp(S - max S)) @ v / sum(exp(S - max S))

where ``cast`` rounds to the input dtype. This is the function of
``poseidon_tpu/ops/window_attention.py::_fwd_kernel_qkv`` (with the same
rounding points as its ``_scores``/``_fwd_body``), on the port's layouts:

- ``qkv`` (N, T, 3C): the QKV GEMM output as it comes, columns
  [q | k | v], each in (head, d) order; N = images x windows, the windows
  of one image contiguous.
- ``qb`` (C,) fp32 q-projection bias (zeros when the model has none).
- ``bm`` (nW, H, T, T) fp32: CPB bias + doubled shift mask; nW = 1 for
  unshifted blocks. Window n uses ``bm[n mod nW]``.
- ``scale`` (H,) fp32: exp(min(logit_scale, log 100)).
- returns (N, T, C) in qkv's dtype, columns in (head, d) order: the
  layout the output projection GEMM consumes.

The backward (:func:`window_attention_bwd`) recomputes the scores from q
and k, as ``_bwd_kernel_qkv`` does, and returns (dqkv (N, T, 3C) in qkv's
dtype, dqb (C,), dbm (nW, H, T, T), dscale (H,)), the last three fp32 and
summed over all windows.

:func:`fused_window_attention` is the JAX package's public op of the same
name: the same attention on separate q, k and v with no q-bias (the function
of ``_fwd_kernel`` / ``_bwd_kernel``), in its four layouts, with gradients to
q, k, v, the position bias, the mask and the logit scales.

A CPU tensor goes to the plain version. A CUDA tensor goes to a kernel or
raises: the Hopper kernels (``csrc/window_attention.cu``,
``csrc/window_attention_bwd.cu``) for bf16 with T <= 256 and D in {16, 32,
64}, the general ones (``csrc/window_attention_general.cu``: wgmma, fp32
operands as 3xTF32) for fp32 operands and any other T <= 1024 and D <= 128
(:func:`attention_kernel_for`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_EPS = 1e-12


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bm: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel on (N, T, H, D) q, k, v (no
    q-bias), with its rounding points; returns (N, T, H, D) in q's dtype."""
    n, t, heads, _ = q.shape
    nw = bm.shape[0]
    cdt = q.dtype
    qn = q.float() / torch.clamp(torch.linalg.vector_norm(q.float(), dim=-1, keepdim=True), min=_EPS)
    kn = k.float() / torch.clamp(torch.linalg.vector_norm(k.float(), dim=-1, keepdim=True), min=_EPS)
    qs = (qn * scale.reshape(1, 1, heads, 1)).to(cdt).float()
    s = torch.einsum("nthd,nshd->nhts", qs, kn.to(cdt).float())
    s = (s.reshape(n // nw, nw, heads, t, t) + bm[None]).reshape(n, heads, t, t)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = e.sum(dim=-1)                                               # (N, H, T)
    o = torch.einsum("nhts,nshd->nthd", e.to(cdt).float(), v.float())
    o = o / den.transpose(1, 2)[..., None]
    return o.to(cdt)


def window_attention_plain(qkv: torch.Tensor, qb: torch.Tensor, bm: torch.Tensor,
                           scale: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its rounding points."""
    n, t, c3 = qkv.shape
    q, k, v = qkv.reshape(n, t, 3, heads, c3 // (3 * heads)).unbind(2)  # (N, T, H, D) each
    q = q + qb.reshape(heads, -1).to(qkv.dtype)
    return attention_plain(q, k, v, bm, scale).reshape(n, t, c3 // 3)


GENERAL_MAX_T = 1024  # windows up to 32x32
GENERAL_MAX_D = 128


def attention_kernel_for(dtype: torch.dtype, t: int, d: int) -> str:
    """Which kernel a call on the card runs: ``"wgmma"`` (the Hopper
    kernels, ``csrc/window_attention.cu`` and ``window_attention_bwd.cu``)
    for bf16 operands with 1 <= T <= 256 and D in {16, 32, 64}, else
    ``"general"`` (``csrc/window_attention_general.cu``: wgmma, bf16 or
    fp32 operands (3xTF32), 1 <= T <= 1024 and 1 <= D <= 128)."""
    if dtype == torch.bfloat16 and 1 <= t <= 256 and d in (16, 32, 64):
        return "wgmma"
    return "general"


def _check_operands(ops, fp32s, n, t, heads, d, bm):
    """Checks shared by the kernels' wrappers; ``ops`` (the q/k/v operands,
    one dtype) and ``fp32s`` are (name, tensor) pairs. Returns (nW, the
    kernel that takes the call)."""
    dtype = ops[0][1].dtype
    for name, a in ops:
        if a.dtype not in (torch.bfloat16, torch.float32) or a.dtype != dtype:
            raise TypeError(f"window_attention kernels: {name} must be bf16 or fp32, of one "
                            f"dtype with {ops[0][0]}, got {a.dtype}")
    kernel = attention_kernel_for(dtype, t, d)
    if not (1 <= t <= GENERAL_MAX_T and 1 <= d <= GENERAL_MAX_D):
        raise ValueError(f"window_attention kernels take 1 <= T <= {GENERAL_MAX_T} and "
                         f"1 <= D <= {GENERAL_MAX_D}, got T={t}, D={d}")
    nw = bm.shape[0]
    if bm.shape != (nw, heads, t, t) or n % nw:
        raise ValueError(f"bm must be (nW, H, T, T) with N % nW == 0, got "
                         f"{tuple(bm.shape)} for N={n}")
    for name, a in fp32s:
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32, got {a.dtype}")
    first, dev = ops[0][0], ops[0][1].device
    for name, a in ops + fp32s:
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, {first} on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if kernel == "wgmma" and any(a.data_ptr() % 16 for _, a in ops):
        raise ValueError(f"{', '.join(n for n, _ in ops)} must be 16-byte aligned")
    return nw, kernel


def _check(qkv, qb, bm, scale, heads):
    if qkv.ndim != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (N, T, 3C), got {tuple(qkv.shape)}")
    n, t, c3 = qkv.shape
    c = c3 // 3
    if c % heads:
        raise ValueError(f"C={c} is not a multiple of heads={heads}")
    if qb.shape != (c,) or scale.shape != (heads,):
        raise ValueError("qb must be (C,) and scale (H,)")
    d = c // heads
    nw, kernel = _check_operands([("qkv", qkv)], [("qb", qb), ("bm", bm), ("scale", scale)],
                                 n, t, heads, d, bm)
    if kernel == "wgmma" and qb.data_ptr() % 16:
        raise ValueError("qb must be 16-byte aligned")
    return n, t, c, d, nw, kernel


def _forward(qkv: torch.Tensor, qb: torch.Tensor, bm: torch.Tensor,
             scale: torch.Tensor, heads: int) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, qb, bm, scale, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {qkv.device}")
    n, t, c, d, nw, kernel = _check(qkv, qb, bm, scale, heads)
    out = torch.empty((n, t, c), dtype=qkv.dtype, device=qkv.device)
    if kernel == "general":
        _general_fwd(_qkv_ptrs(qkv, c), 3 * c, qb, bm, scale, out, n, t, heads, d, nw)
        window_attention.launches_general += 1
        return out
    lib = _build.load("window_attention", _SIGNATURES)
    _build.launch(
        lib, "window_attention_fwd", qkv.device,
        qkv.data_ptr(), qb.data_ptr(), bm.data_ptr(), scale.data_ptr(),
        out.data_ptr(), n, t, heads, d, nw,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    window_attention.launches += 1
    return out


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bm: torch.Tensor,
                        scale: torch.Tensor, do: torch.Tensor):
    """Plain PyTorch version of the backward kernel on (N, T, H, D) q, k,
    v, do: the function of ``_bwd_body`` / ``_bwd_kernel``, with their
    rounding points (dod, e before dV, ds before dQ/dK, and dq/dk/dv rounded
    to the input dtype; everything else fp32). Returns (dq, dk, dv, dbm,
    dscale)."""
    n, t, heads, _ = q.shape
    nw = bm.shape[0]
    cdt = q.dtype

    def rnd(x):
        return x.to(cdt).float()

    qf = q.float()
    kf = k.float()
    qnorm = torch.clamp(torch.linalg.vector_norm(qf, dim=-1, keepdim=True), min=_EPS)
    knorm = torch.clamp(torch.linalg.vector_norm(kf, dim=-1, keepdim=True), min=_EPS)
    qn, kn = qf / qnorm, kf / knorm
    sc = scale.reshape(1, 1, heads, 1)
    qsb, knb = rnd(qn * sc), rnd(kn)
    s = torch.einsum("nthd,nshd->nhts", qsb, knb)
    s = (s.reshape(n // nw, nw, heads, t, t) + bm[None]).reshape(n, heads, t, t)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = e.sum(dim=-1, keepdim=True)                                  # (N, H, T, 1)
    dof = do.float()
    dod = rnd(dof / den[..., 0].transpose(1, 2)[..., None])            # (N, T, H, D)
    dv = torch.einsum("nhts,nthd->nshd", rnd(e), dod).to(cdt)
    dp = torch.einsum("nthd,nshd->nhts", rnd(dof), v.float())
    ds = e * ((dp - (dp * e).sum(dim=-1, keepdim=True) / den) / den)
    dsb = rnd(ds)
    dqs = torch.einsum("nhts,nshd->nthd", dsb, knb)
    dkn = torch.einsum("nhts,nthd->nshd", dsb, qsb)
    dsrow = (dqs * qn).sum(dim=-1)                                     # (N, T, H)

    def norm_bwd(dxn, xn, nrm):
        return (dxn - xn * (dxn * xn).sum(dim=-1, keepdim=True)) / nrm

    dq = norm_bwd(dqs * sc, qn, qnorm).to(cdt)
    dk = norm_bwd(dkn, kn, knorm).to(cdt)
    dbm = ds.reshape(n // nw, nw, heads, t, t).sum(dim=0)
    return dq, dk, dv, dbm, dsrow.sum(dim=(0, 1))


def window_attention_bwd_plain(qkv: torch.Tensor, qb: torch.Tensor, bm: torch.Tensor,
                               scale: torch.Tensor, heads: int, do: torch.Tensor):
    """Plain PyTorch version of the backward kernel: the function of
    ``_bwd_body`` / ``_bwd_kernel_qkv``, with their rounding points (see
    :func:`attention_bwd_plain`; dqb summed from the rounded dq)."""
    n, t, c3 = qkv.shape
    q, k, v = qkv.reshape(n, t, 3, heads, c3 // (3 * heads)).unbind(2)  # (N, T, H, D) each
    q = q + qb.reshape(heads, -1).to(qkv.dtype)
    dq, dk, dv, dbm, dscale = attention_bwd_plain(q, k, v, bm, scale, do.reshape(q.shape))
    dqkv = torch.stack([dq, dk, dv], dim=2).reshape(n, t, c3)
    return dqkv, dq.float().sum(dim=(0, 1)).reshape(-1), dbm, dscale


BWD_PARTIAL_BUDGET = 32 << 20  # bytes of the backward's dbm partials


def bwd_pack(t: int) -> int:
    """Windows P a 64-key tile of the backward kernel holds: 64 // T at T
    <= 32 (block-diagonal, windows of one bias slot and head), else 1."""
    return 64 // t if t <= 32 else 1


def _bwd_nk(t: int) -> int:
    """Padded window NK of the backward kernel: 64, 128 or 256."""
    return 64 if t <= 64 else 128 if t <= 128 else 256


def _bwd_cluster(t: int) -> int:
    """CTAs per cluster of the backward kernel: one per 64 padded keys."""
    return _bwd_nk(t) // 64


# Clusters of the backward kernel resident at once on an H100 SXM (132 SMs),
# by padded window NK, as cudaOccupancyMaxActiveClusters gives them on the
# NVIDIA H100 80GB HBM3 (``kernel_info``'s "clusters"): two CTAs an SM at NK
# = 64 (three at D = 16), and clusters of two and four CTAs at one CTA an
# SM, as the card's GPCs place them: 66 and 30, not 132 / 2 and 132 / 4.
# On the card the wrappers use the card's own count.
H100_BWD_CLUSTERS = {64: 264, 128: 66, 256: 30}


@functools.lru_cache(maxsize=None)
def bwd_plan(n: int, nw: int, heads: int, t: int, clusters: int | None = None):
    """(P, G, CTAs) of the backward kernel for ``n`` windows of size ``t``,
    ``nw`` bias slots and ``heads`` heads, on a card that holds ``clusters``
    of its clusters at once (default: ``H100_BWD_CLUSTERS``). A cluster of
    T/64 CTAs (one at T <= 64) takes one bias slot and head and walks the
    tiles (P windows each, :func:`bwd_pack`) of one of G groups, and writes
    one fp32 dbm partial per group. G is the one that finishes in the fewest
    rounds, a round being one tile of every resident cluster: waves of
    resident clusters x the longest walk, the smaller G on a tie, with the
    partials (G x nW x H x T x T fp32) within ``BWD_PARTIAL_BUDGET``."""
    pack = bwd_pack(t)
    tiles = -(-(n // nw) // pack)
    per_group = nw * heads
    slots = clusters or H100_BWD_CLUSTERS[_bwd_nk(t)]
    cap = max(1, min(tiles, BWD_PARTIAL_BUDGET // (nw * heads * t * t * 4)))
    best = (None, 1)
    for g in range(1, cap + 1):
        rounds = -(-per_group * g // slots) * -(-tiles // g)
        if best[0] is None or rounds < best[0]:
            best = (rounds, g)
    return pack, best[1], per_group * best[1] * _bwd_cluster(t)


_resident = {}


def bwd_resident_clusters(t: int, d: int, device=None) -> int:
    """Clusters of the backward kernel's instantiation for window size
    ``t`` and head width ``d`` that the card holds at once (the occupancy
    calculator, once per card and instantiation; builds and loads the
    kernel)."""
    index = torch.cuda.current_device() if device is None else device.index
    key = (index, _bwd_nk(t), d)
    if key not in _resident:
        vals = (ctypes.c_int * 7)()
        with torch.cuda.device(index):
            err = _build.load("window_attention_bwd", _BWD_SIGNATURES).window_attention_bwd_info(
                t, d, ctypes.addressof(vals))
        if err != 0:
            raise RuntimeError(f"window_attention_bwd info failed: {err}")
        _resident[key] = vals[6]
    return _resident[key]


def window_attention_bwd(qkv: torch.Tensor, qb: torch.Tensor, bm: torch.Tensor,
                         scale: torch.Tensor, heads: int, do: torch.Tensor):
    """The backward of :func:`window_attention` for the output cotangent
    ``do`` (N, T, C): (dqkv, dqb, dbm, dscale); see the module docstring."""
    if qkv.device.type == "cpu":
        return window_attention_bwd_plain(qkv, qb, bm, scale, heads, do)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention_bwd: unsupported device {qkv.device}")
    n, t, c, d, nw, kernel = _check(qkv, qb, bm, scale, heads)
    if do.shape != (n, t, c) or do.dtype != qkv.dtype or do.device != qkv.device:
        raise ValueError(f"do must be ({n}, {t}, {c}) {qkv.dtype} on {qkv.device}")
    if not do.is_contiguous() or (kernel == "wgmma" and do.data_ptr() % 16):
        raise ValueError("do must be contiguous and 16-byte aligned")
    dqkv = torch.empty_like(qkv)
    if kernel == "general":
        f32 = _general_bwd(_qkv_ptrs(qkv, c), _qkv_ptrs(dqkv, c), 3 * c, qb, bm, scale, do,
                           n, t, heads, d, nw)
        window_attention_bwd.launches_general += 1
        return (dqkv,) + f32
    g, f32 = _bwd_scratch(n, t, heads, d, nw, qkv.device)
    lib = _build.load("window_attention_bwd", _BWD_SIGNATURES)
    _build.launch(
        lib, "window_attention_bwd", qkv.device,
        qkv.data_ptr(), qb.data_ptr(), bm.data_ptr(), scale.data_ptr(), do.data_ptr(),
        dqkv.data_ptr(), *(a.data_ptr() for a in f32),
        n, t, heads, d, nw, g, torch.cuda.current_stream(qkv.device).cuda_stream)
    window_attention_bwd.launches += 1
    dqb, dbm, dscale = f32[:3]
    return dqkv, dqb, dbm, dscale


def _bwd_scratch(n, t, heads, d, nw, device):
    """The backward kernel's window groups G and its fp32 outputs and
    scratch: dqb (C,), dbm (nW, H, T, T), dscale (H,), and the per-group
    partials of dbm and (per cluster rank) of dqb | dscale."""
    _, g, _ = bwd_plan(n, nw, heads, t, bwd_resident_clusters(t, d, device))
    f32 = dict(dtype=torch.float32, device=device)
    return g, (torch.empty(heads * d, **f32), torch.empty((nw, heads, t, t), **f32),
               torch.empty(heads, **f32), torch.empty((g, nw, heads, t, t), **f32),
               torch.empty((g * _bwd_cluster(t), nw, heads, d + 1), **f32))


def _ptrs(*tensors):
    return tuple(a.data_ptr() for a in tensors)


def _qkv_ptrs(qkv: torch.Tensor, c: int):
    """The q, k and v base pointers inside a packed (N, T, 3C) tensor."""
    p, step = qkv.data_ptr(), c * qkv.element_size()
    return p, p + step, p + 2 * step


def _general_fwd(ptrs, ld, qb, bm, scale, out, n, t, heads, d, nw):
    """Launch the general forward kernel on q/k/v at the data pointers
    ``ptrs`` (row stride ``ld``) into ``out`` (N, T, C); ``qb`` may be None."""
    lib = _build.load("window_attention_general", _GENERAL_SIGNATURES)
    _build.launch(
        lib, "window_attention_general_fwd", out.device,
        *ptrs, None if qb is None else qb.data_ptr(), bm.data_ptr(), scale.data_ptr(),
        out.data_ptr(), ld, heads * d, n, t, heads, d, nw, int(out.dtype == torch.float32),
        torch.cuda.current_stream(out.device).cuda_stream)


def general_bwd_plan(n: int, nw: int, heads: int, t: int):
    """(fold, G) of the general backward: whether its dk/dv kernel sums dbm
    itself (T <= 64: one 64 x 64 fp32 sum in shared memory) or a dbm kernel
    does, and the window groups G whose fp32 dbm partials (G x nW x H x T x
    T) the one or the other writes. A CTA walks the windows of one group,
    bias slot and head (and, in the dbm kernel, of one 64-query strip and
    64-key block): about two CTAs an SM for the folded kernel, eight for
    the dbm kernel's shorter walks, the partials within 32 MiB."""
    blocks = -(-t // 64)
    fold = blocks == 1
    units = nw * heads * blocks * blocks
    target = (2 if fold else 8) * _SMS
    g = min(n // nw, max(1, -(-target // units)))
    return fold, max(1, min(g, (32 << 20) // (nw * heads * t * t * 4)))


def _general_bwd(ptrs, dptrs, ld, qb, bm, scale, do, n, t, heads, d, nw):
    """Launch the general backward kernels on q/k/v at ``ptrs`` with the
    output cotangent ``do`` (N, T, C), writing dq/dk/dv at ``dptrs`` (both
    with row stride ``ld``); returns (dqb, dbm, dscale) fp32."""
    f32 = dict(dtype=torch.float32, device=do.device)
    dqb, dscale = torch.empty(heads * d, **f32), torch.empty(heads, **f32)
    dbm = torch.empty((nw, heads, t, t), **f32)
    _, groups = general_bwd_plan(n, nw, heads, t)
    stats = torch.empty(n * heads * t * 3, **f32)                 # row max, den, delta
    part = torch.empty(n * heads * -(-t // 64) * (d + 1), **f32)  # per-CTA dqb | dscale
    part_bm = torch.empty((groups, nw, heads, t, t), **f32)       # per-group dbm
    lib = _build.load("window_attention_general", _GENERAL_SIGNATURES)
    _build.launch(
        lib, "window_attention_general_bwd", do.device,
        *ptrs, None if qb is None else qb.data_ptr(), bm.data_ptr(), scale.data_ptr(),
        do.data_ptr(), *dptrs, dqb.data_ptr(), dbm.data_ptr(), dscale.data_ptr(),
        stats.data_ptr(), part.data_ptr(), part_bm.data_ptr(), ld, n, t, heads, d, nw, groups,
        int(do.dtype == torch.float32), torch.cuda.current_stream(do.device).cuda_stream)
    return dqb, dbm, dscale


def kernel_info() -> dict:
    """Registers, local-memory (spill) bytes and dynamic shared-memory
    bytes of every instantiation of the two wgmma kernels, by padded window
    NK = 64, 128, 256 and head width D (the backward's also its CTAs an SM
    and clusters resident at once by the occupancy calculator, its stages of
    prefetched rows, and whether its bias tile stays in shared memory), and
    of the general kernels' six kernels, by operand type and padded head
    width DP (builds and loads them)."""
    out = {}
    keys = ("registers", "spill_bytes", "smem_bytes", "ctas_per_sm", "stages", "bias_resident",
            "clusters")
    for name, sigs, entry, n in (("window_attention", _SIGNATURES, "window_attention_fwd_info",
                                  3),
                                 ("window_attention_bwd", _BWD_SIGNATURES,
                                  "window_attention_bwd_info", 7)):
        fn = getattr(_build.load(name, sigs), entry)
        for nk in (64, 128, 256):
            for d in (16, 32, 64):
                vals = (ctypes.c_int * n)()
                err = fn(nk, d, ctypes.addressof(vals))
                if err != 0:
                    raise RuntimeError(f"{name} info failed: {err}")
                out[f"{name} NK={nk} D={d}"] = dict(zip(keys, vals))
    fn = _build.load("window_attention_general", _GENERAL_SIGNATURES).window_attention_general_info
    for kernel, kname in enumerate(("fwd T<=64", "fwd T<=256", "fwd T>256", "bwd_dq",
                                    "bwd_dkdv", "bwd_dbm", "bwd_dkdv+dbm")):
        for fp32 in (0, 1):
            for dp in (16, 32, 64, 128):
                if kname == "fwd T<=256" and fp32:
                    continue  # not built: fp32 takes two passes past T = 64
                vals = (ctypes.c_int * 3)()
                err = fn(kernel, fp32, dp, ctypes.addressof(vals))
                if err != 0:
                    raise RuntimeError(f"window_attention_general info failed: {err}")
                out[f"window_attention_general {kname} {'fp32' if fp32 else 'bf16'} "
                    f"DP={dp}"] = {"registers": vals[0], "spill_bytes": vals[1],
                                    "smem_bytes": vals[2]}
    return out


class WindowAttentionFn(torch.autograd.Function):
    """Forward through the forward kernel (or its plain version on the CPU),
    backward through the backward kernel (or its plain version): the
    ``jax.custom_vjp`` of ``_attention_core_qkv``."""

    @staticmethod
    def forward(ctx, qkv, qb, bm, scale, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv, qb, bm, scale)
        return _forward(qkv, qb, bm, scale, heads)

    @staticmethod
    def backward(ctx, do):
        qkv, qb, bm, scale = ctx.saved_tensors
        dqkv, dqb, dbm, dscale = window_attention_bwd(qkv, qb, bm, scale, ctx.heads,
                                                      do.contiguous())
        return dqkv, dqb, dbm, dscale, None


def window_attention(qkv: torch.Tensor, qb: torch.Tensor, bm: torch.Tensor,
                     scale: torch.Tensor, heads: int) -> torch.Tensor:
    """Fused window cosine attention with its backward; see the module
    docstring. ``window_attention.launches`` counts forward launches of the
    wgmma kernel, ``window_attention_bwd.launches`` backward ones; their
    ``launches_general`` count the general kernel's."""
    return WindowAttentionFn.apply(qkv, qb, bm, scale, heads)


# ---------------------------------------------------------------------------
# The separate-q/k/v op
# ---------------------------------------------------------------------------

LAYOUTS = ("nhtd", "nthd", "nhdt", "nhdt_packed")


def _check_sep(q, k, v, bm, scale):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must be (N, T, H, D) of one shape and dtype")
    n, t, heads, d = q.shape
    if scale.shape != (heads,):
        raise ValueError("scale must be (H,)")
    nw, kernel = _check_operands([("q", q), ("k", k), ("v", v)],
                                 [("bm", bm), ("scale", scale)], n, t, heads, d, bm)
    return n, t, heads, d, nw, kernel


def _forward_sep(q, k, v, bm, scale):
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bm, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_window_attention: unsupported device {q.device}")
    n, t, heads, d, nw, kernel = _check_sep(q, k, v, bm, scale)
    out = torch.empty_like(q)
    if kernel == "general":
        _general_fwd(_ptrs(q, k, v), heads * d, None, bm, scale, out, n, t, heads, d, nw)
        fused_window_attention.launches_general += 1
        return out
    lib = _build.load("window_attention", _SIGNATURES)
    _build.launch(
        lib, "fused_window_attention_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bm.data_ptr(), scale.data_ptr(),
        out.data_ptr(), n, t, heads, d, nw, torch.cuda.current_stream(q.device).cuda_stream)
    fused_window_attention.launches += 1
    return out


def fused_window_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bm: torch.Tensor, scale: torch.Tensor, do: torch.Tensor):
    """The backward of the separate-q/k/v attention on (N, T, H, D) q, k, v
    and output cotangent ``do``: (dq, dk, dv in q's dtype, dbm (nW, H, T, T)
    and dscale (H,) fp32, summed over all windows)."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, bm, scale, do)
    if q.device.type != "cuda":
        raise ValueError(f"fused_window_attention_bwd: unsupported device {q.device}")
    n, t, heads, d, nw, kernel = _check_sep(q, k, v, bm, scale)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or not do.is_contiguous() or (kernel == "wgmma" and do.data_ptr() % 16):
        raise ValueError("do must be contiguous, 16-byte aligned, and of q's shape and dtype")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if kernel == "general":
        _, dbm, dscale = _general_bwd(_ptrs(q, k, v), _ptrs(dq, dk, dv), heads * d, None, bm,
                                      scale, do, n, t, heads, d, nw)
        fused_window_attention_bwd.launches_general += 1
        return dq, dk, dv, dbm, dscale
    g, f32 = _bwd_scratch(n, t, heads, d, nw, q.device)
    lib = _build.load("window_attention_bwd", _BWD_SIGNATURES)
    _build.launch(
        lib, "fused_window_attention_bwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bm.data_ptr(), scale.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *(a.data_ptr() for a in f32), n, t, heads, d, nw, g,
        torch.cuda.current_stream(q.device).cuda_stream)
    fused_window_attention_bwd.launches += 1
    return dq, dk, dv, f32[1], f32[2]


class FusedWindowAttentionFn(torch.autograd.Function):
    """The ``jax.custom_vjp`` of ``_attention_core``: forward and backward
    kernels (or their plain versions on the CPU) on (N, T, H, D) q, k, v,
    with gradients to q, k, v, bm and scale."""

    @staticmethod
    def forward(ctx, q, k, v, bm, scale):
        ctx.save_for_backward(q, k, v, bm, scale)
        return _forward_sep(q, k, v, bm, scale)

    @staticmethod
    def backward(ctx, do):
        return fused_window_attention_bwd(*ctx.saved_tensors, do.contiguous())


def _to_nthd(x: torch.Tensor, layout: str, heads: int) -> torch.Tensor:
    if layout == "nthd":
        return x
    if layout == "nhtd":
        return x.permute(0, 2, 1, 3)
    if layout == "nhdt":
        return x.permute(0, 3, 1, 2)
    # nhdt_packed: (N, H', D, P*T), head h'*P + j at tokens j*T.. of row h'.
    n, hp, d, tp = x.shape
    p = heads // hp
    return x.reshape(n, hp, d, p, tp // p).permute(0, 4, 1, 3, 2).reshape(n, tp // p, heads, d)


def _from_nthd(o: torch.Tensor, layout: str, packed_rows: int) -> torch.Tensor:
    if layout == "nthd":
        return o
    if layout == "nhtd":
        return o.permute(0, 2, 1, 3)
    if layout == "nhdt":
        return o.permute(0, 2, 3, 1)
    n, t, h, d = o.shape
    hp = packed_rows
    return o.reshape(n, t, hp, h // hp, d).permute(0, 2, 4, 3, 1).reshape(n, hp, d, h // hp * t)


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
                           layout: str = "nhtd", windows_per_image: int = 1) -> torch.Tensor:
    """Fused cosine window attention on separate q, k, v, with its backward:
    ``poseidon_tpu.ops.fused_window_attention`` in PyTorch.

    Args:
        q, k, v: projected (unnormalised) q/k/v, as (N, H, T, D) when
            ``layout == "nhtd"``, (N, T, H, D) ("nthd"), (N, H, D, T)
            ("nhdt"), or (N, H', D, P*T) with P = H / H' heads packed along
            the token axis in (head-block, token) order, head h'*P + j at
            tokens j*T.. ("nhdt_packed", unshifted windows only). N is a
            multiple of the window count nW, the windows of one image
            contiguous.
        bias: (H, T, T) fp32 position bias (already 16*sigmoid'd).
        mask: (nW, T, T) fp32 additive shift mask, already doubled by the
            caller; zeros when unshifted.
        scale: (H,) fp32 exp(clamped logit_scale).
        windows_per_image: the true number of windows per image. It sets the
            shard granularity of the JAX op; on one card it is only checked.
    Returns:
        The attention output in q's dtype and the inputs' layout.

    The kernels read token-major (N, T, H, D): the other layouts are brought
    to it and back, and head packing, which on the TPU only filled its
    lanes and is the same function as no packing, is undone.
    ``fused_window_attention.launches`` counts forward kernel launches,
    ``fused_window_attention_bwd.launches`` backward ones.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if layout == "nhdt_packed" and mask.shape[0] != 1:
        raise ValueError("the packed layout requires unshifted windows: mask (1, T, T)")
    heads = bias.shape[0]
    q4, k4, v4 = (_to_nthd(a, layout, heads).contiguous() for a in (q, k, v))
    n = q4.shape[0]
    if int(windows_per_image) != windows_per_image or windows_per_image < 1 \
            or n % max(int(windows_per_image), mask.shape[0]):
        raise ValueError(f"windows_per_image must be a positive int with N % max(it, nW) == 0, "
                         f"got {windows_per_image} for N={n}, nW={mask.shape[0]}")
    bm = (bias.float()[None] + mask.float()[:, None]).contiguous()
    out = FusedWindowAttentionFn.apply(q4, k4, v4, bm, scale.float())
    return _from_nthd(out, layout, q.shape[1])


window_attention.launches = 0
window_attention_bwd.launches = 0
fused_window_attention.launches = 0
fused_window_attention_bwd.launches = 0
# Launches of the general kernels (``attention_kernel_for(...) == "general"``).
window_attention.launches_general = 0
window_attention_bwd.launches_general = 0
fused_window_attention.launches_general = 0
fused_window_attention_bwd.launches_general = 0
_SMS = 132  # the H100's SMs: the general backward's groups fill them
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # qkv, qb, bm, scale, out, n_windows, T, heads, D, nW, stream
    "window_attention_fwd": (_P,) * 5 + (_I,) * 5 + (_P,),
    # q, k, v, bm, scale, out, n_windows, T, heads, D, nW, stream
    "fused_window_attention_fwd": (_P,) * 6 + (_I,) * 5 + (_P,),
    # T, D, int[3] out: registers, spill bytes, dynamic shared-memory bytes
    "window_attention_fwd_info": (_I, _I, _P),
}
_BWD_SIGNATURES = {
    # qkv, qb, bm, scale, do, dqkv, dqb, dbm, dscale, part_bm, part_q,
    # n_windows, T, heads, D, nW, groups, stream
    "window_attention_bwd": (_P,) * 11 + (_I,) * 6 + (_P,),
    # q, k, v, bm, scale, do, dq, dk, dv, dqb (scratch), dbm, dscale,
    # part_bm, part_q, n_windows, T, heads, D, nW, groups, stream
    "fused_window_attention_bwd": (_P,) * 14 + (_I,) * 6 + (_P,),
    # T, D, int[7] out: registers, spill bytes, dynamic shared-memory bytes, CTAs an SM,
    # stages, bias resident, clusters resident at once
    "window_attention_bwd_info": (_I, _I, _P),
}
_GENERAL_SIGNATURES = {
    # q, k, v, qb, bm, scale, out, ld, ldo, n_windows, T, heads, D, nW, fp32, stream
    "window_attention_general_fwd": (_P,) * 7 + (_I,) * 8 + (_P,),
    # q, k, v, qb, bm, scale, do, dq, dk, dv, dqb, dbm, dscale, stats, part, part_bm,
    # ld, n_windows, T, heads, D, nW, groups, fp32, stream
    "window_attention_general_bwd": (_P,) * 16 + (_I,) * 8 + (_P,),
    # kernel, fp32, DP, int[3] out: registers, spill bytes, dynamic shared-memory bytes
    "window_attention_general_info": (_I, _I, _I, _P),
}
