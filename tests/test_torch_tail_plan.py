"""The general fused tail's plan and schedule on the CPU.

(a) ``ops/mlp.py::tail_plan``, the plan that the general tail's C entries
take on the card (``csrc/mlp_cln_general.cu``, ``csrc/mlp_cln_rows.cuh``),
at every fused-tail block of ScOT-B, -L and -T in fp32, of ScOT-T with
``mlp_ratio=3`` in bf16 (batch 32), and at the card tests' ``GENERAL_CLN``
shapes: which kernel takes each direction, the device kernels a call, whole
rows a CTA with no F split and u computed once a row in the forward, and a
shared-memory layout that fits the card and holds the ring's items.

(b) A plain-torch emulation of the row-tile kernel's schedule: F in steps
of the plan's width, each step's hidden columns halved between two
warpgroups (or, with two row tiles a CTA, all of them for each
warpgroup's own rows), u over C in the plan's chunks, o summed per output
half over the steps' pieces, the norm's row sums of the two halves added
in one order, the backward's two walks (dh from cast(do), u again or kept,
du, dx per output half) and its per-warp partial sums (db1, and db2,
dscale, dshift over 16 rows) reduced in the kernel's order; every rounding
where the kernel rounds (g, o, cast(do), cast(du), dx once). Held, in
fp32, to ``mlp_cln_plain`` / ``mlp_cln_bwd_plain`` within relative L2 1e-5
per output (the two differ only in summation order), and to the JAX
package's ``fused_mlp_cln`` and its ``jax.vjp`` (Pallas in interpret mode,
as tests/test_torch_mlp_cln.py runs them) within
tests/test_torch_mlp_cln.py's fp32 tolerance (atol 2e-5, rtol 1e-4); in
bf16 to the plain versions within relative L2 3e-2 (each rounds its
intermediates to bf16 at the same points, in another summation order: a
few bf16 ulps), at C in {17, 64, 200, 384} with F not a multiple of 64,
one and three images of 128 rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poseidon_tpu.ops import mlp as jmlp

import poseidon_tpu_torch as pt
from poseidon_tpu_torch.models.layers import gelu_exact
from poseidon_tpu_torch.ops import mlp as mlp_op

from test_torch_mlp_cln import ATOL, RTOL, make

torch.set_num_threads(1)

EPS = 1e-5
BATCH = 32
ODD = dict(embed_dim=48, num_heads=(2, 4, 8, 16), mlp_ratio=3.0)
# (B, L, C, F, dtype) of tests/test_torch_kernels_cuda.py::GENERAL_CLN.
GENERAL_CLN = [(4, 1024, 96, 384, "fp32"), (8, 256, 192, 768, "fp32"),
               (4, 256, 384, 1536, "fp32"), (4, 1024, 48, 144, "bf16"),
               (4, 256, 96, 288, "bf16"), (3, 64, 17, 33, "fp32"), (3, 64, 17, 33, "bf16"),
               (2, 128, 200, 600, "bf16"), (2, 192, 64, 256, "bf16"),
               (1, 128, 1024, 4096, "fp32"), (2, 64, 1024, 4096, "bf16"),
               (2, 256, 384, 1536, "bf16"), (1, 64, 384, 1536, "fp32"),
               (2, 128, 320, 1280, "fp32"), (2, 128, 193, 772, "fp32")]
DT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def scot_tail_shapes():
    """(model, B * L, C, F, dtype) of every block the general tail takes on
    the card under ``fused_block_tail`` at batch 32 on 128 x 128 inputs."""
    out = []
    for name, size, over, dt in (("B", "B", {}, torch.float32), ("L", "L", {}, torch.float32),
                                 ("T", "T", {}, torch.float32), ("T-odd", "T", ODD, torch.bfloat16)):
        cfg = pt.make_config(size, image_size=128, num_channels=4, num_out_channels=4, **over)
        for i in range(cfg.num_stages):
            c, l = cfg.stage_dim(i), cfg.stage_resolution(i) ** 2
            f = int(cfg.mlp_ratio * c)
            if mlp_op.use_fused_tail(c, l, f) and mlp_op.mlp_kernel_for(c, f, dt) == "general":
                out.append((f"{name} stage {i}", BATCH * l, c, f, dt))
    return out


def test_scot_tail_shapes_are_the_expected_blocks():
    got = [(name, m, c, f) for name, m, c, f, _ in scot_tail_shapes()]
    assert got == [("B stage 0", 32768, 96, 384), ("B stage 1", 8192, 192, 768),
                   ("L stage 0", 32768, 192, 768), ("L stage 1", 8192, 384, 1536),
                   ("T stage 0", 32768, 48, 192), ("T stage 1", 8192, 96, 384),
                   ("T-odd stage 0", 32768, 48, 144), ("T-odd stage 1", 8192, 96, 288)]


def _check_rows_part(part, m, c, f, dtype, bwd):
    fp32 = dtype == torch.float32
    rows = part["rows"]
    assert rows in (1, 2) and part["f_split"] == 1
    assert part["device_kernels"] == (4 if bwd else 2)
    assert part["ctas"] * 64 * rows == m
    # The warpgroups' output columns cover C: split in two halves, or whole.
    assert part["nh"] in mlp_op.GENERAL_WIDTHS and part["nh"] * (2 if rows == 1 else 1) >= c
    if rows == 2:
        assert bwd and c <= 96 and m % 128 == 0 and m // 128 >= mlp_op.H100_SMS
        assert part["xres"] == 1
    fs = mlp_op._step(part["nh"], rows)
    ks = 8 if fp32 else 16
    assert part["kp"] % ks == 0 and fs % part["kp"] == 0
    assert part["kc"] % 16 == 0 and part["kc"] <= -(-c // 16) * 16
    assert 2 <= part["ns"] <= 4
    assert part["u_products"] == (2 if bwd and not part["ukeep"] else 1)
    assert not part["ukeep"] or bwd
    smem = mlp_op._rows_layout(c, f, fp32, bwd, part["nh"], part["kc"], part["kp"],
                               part["xres"], part["ukeep"], part["ns"], rows)
    assert part["smem"] == smem <= mlp_op.TAIL_SMEM
    # One more slot would not fit, or the ring is at its four.
    assert part["ns"] == 4 or mlp_op._rows_layout(
        c, f, fp32, bwd, part["nh"], part["kc"], part["kp"], part["xres"], part["ukeep"],
        part["ns"] + 1, rows) > mlp_op.TAIL_SMEM
    if not part["xres"]:  # x streamed by bulk copies, a row at a time
        assert c % 16 == 0 and (part["kc"] * (4 if fp32 else 2)) % 16 == 0


@pytest.mark.parametrize("name,m,c,f,dtype", scot_tail_shapes(),
                         ids=[s[0].replace(" ", "_") for s in scot_tail_shapes()])
def test_tail_plan_at_scot_blocks(name, m, c, f, dtype):
    """Every ScOT block of the general tail runs the row-tile kernel in the
    backward (4 device kernels a call, no F split, no fp32 partials of o);
    the forward runs it where the general MLP's forward kernel would split
    F (M / 128 below the card's SMs) or C > 192, else that kernel with the
    norm in its epilogue (2 kernels, no row kernel either way)."""
    plan = mlp_op.tail_plan(m, c, f, dtype)
    _check_rows_part(plan["bwd"], m, c, f, dtype, True)
    fwd = plan["fwd"]
    if c > 192 or m // 128 < mlp_op.H100_SMS:
        _check_rows_part(fwd, m, c, f, dtype, False)
    else:
        assert fwd == {"kernel": "mlp_general", "device_kernels": 2}
    assert fwd["device_kernels"] == 2


def test_tail_plan_picks():
    """The plans measured on the H100 (PERF.md): ScOT-L stage 1 (C = 384)
    with 192 output columns a warpgroup, x resident in the forward and
    streamed beside the W1 chunks in the backward (x and cast(do) of 64
    rows do not both fit beside the ring); two row tiles a CTA for ScOT-B
    stage 0's backward; u kept at ScOT-T's stage 0 in bf16."""
    p = mlp_op.tail_plan(8192, 384, 1536, torch.float32)
    assert (p["fwd"]["nh"], p["fwd"]["xres"], p["bwd"]["nh"], p["bwd"]["xres"]) == (192, 1, 192, 0)
    p = mlp_op.tail_plan(32768, 96, 384, torch.float32)
    assert p["fwd"]["kernel"] == "mlp_general" and p["bwd"]["rows"] == 2
    assert p["bwd"]["ctas"] == 256
    p = mlp_op.tail_plan(32768, 48, 144, torch.bfloat16)
    assert p["bwd"]["ukeep"] == 1 and p["bwd"]["u_products"] == 1
    p = mlp_op.tail_plan(8192, 192, 768, torch.float32)
    assert p["fwd"]["kernel"] == p["bwd"]["kernel"] == "tail_rows"
    assert p["fwd"]["rows"] == p["bwd"]["rows"] == 1 and p["fwd"]["nh"] == 96


@pytest.mark.parametrize("b,l,c,f,dt", GENERAL_CLN)
def test_tail_plan_at_general_cln_shapes(b, l, c, f, dt):
    m, dtype = b * l, DT[dt]
    plan = mlp_op.tail_plan(m, c, f, dtype)
    if c > mlp_op.TAIL_MAX_C:
        assert plan["fwd"] == {"kernel": "mlp_general", "device_kernels": 3}
        assert plan["bwd"] == {"kernel": "mlp_general", "device_kernels": None}
        return
    for direction in ("fwd", "bwd"):
        part = plan[direction]
        if part["kernel"] == "tail_rows":
            _check_rows_part(part, m, c, f, dtype, direction == "bwd")
        else:
            assert direction == "fwd" and c <= 192 and m // 128 >= mlp_op.H100_SMS
    assert plan["bwd"]["kernel"] == "tail_rows"
    packed = list(mlp_op._pack_plan(plan["bwd"]))
    assert packed == [1, plan["bwd"]["nh"], plan["bwd"]["kc"], plan["bwd"]["kp"],
                      plan["bwd"]["xres"], plan["bwd"]["ukeep"], plan["bwd"]["ns"],
                      plan["bwd"]["rows"]]


def test_pack_plan_of_the_general_mlp_path_is_zero():
    assert list(mlp_op._pack_plan({"kernel": "mlp_general"})) == [0] * 8


# ---------------------------------------------------------------------------
# (b) The schedule, emulated
# ---------------------------------------------------------------------------

def _dgelu(u):
    return 0.5 * (1.0 + torch.erf(u * 0.7071067811865476)) + \
        u * torch.exp(-0.5 * u * u) * 0.3989422804014327


def _chunked(a, w, kc):
    """a @ w^T over the reduction index in chunks of kc, summed in order (the
    kernel's W1 / W2^T chunks)."""
    out = None
    for k0 in range(0, a.shape[1], kc):
        p = a[:, k0:k0 + kc] @ w[:, k0:k0 + kc].t()
        out = p if out is None else out + p
    return out


def emulate(x, w1, b1, w2, b2, scale, shift, eps, dy, part):
    """The row-tile kernel's forward (dy None) or backward under ``part``
    (one direction of ``tail_plan``), in plain torch: the forward's out, or
    (dx, dw1, db1, dw2, db2, dscale, dshift)."""
    cdt = x.dtype
    B, L, C = x.shape
    F = w1.shape[0]
    rows, nh, kc, kp = part["rows"], part["nh"], part["kc"], part["kp"]
    fs = mlp_op._step(nh, rows)
    ft = fs if rows == 2 else fs // 2          # hidden columns a warpgroup computes
    fp = -(-F // 64) * 64
    cpo = nh * (1 if rows == 2 else 2)
    w1f = torch.zeros(fp, C)
    w1f[:F] = w1.float()
    w2f = torch.zeros(cpo, fp)
    w2f[:C, :F] = w2.float()
    b1f = torch.zeros(fp)
    b1f[:F] = b1
    xf = x.float().reshape(-1, C)
    M = xf.shape[0]
    halves = [(0, nh), (nh, 2 * nh)] if rows == 1 else [(0, nh)]
    # Walk 1 (both row tiles of a CTA alike: each warpgroup's rows are its
    # own tile's, so the emulation walks every row at once).
    us, gs = [], []
    y = torch.zeros(M, cpo)
    for j in range(fp // fs):
        cols = range(j * fs, (j + 1) * fs)
        u = torch.cat([_chunked(xf, w1f[j * fs + k * ft: j * fs + (k + 1) * ft], kc)
                       for k in range(fs // ft)], dim=1) + b1f[cols.start:cols.stop]
        g = gelu_exact(u).to(cdt).float()
        us.append(u)
        gs.append(g)
        for p0 in range(0, fs, kp):
            y = y + g[:, p0:p0 + kp] @ w2f[:, j * fs + p0: j * fs + p0 + kp].t()
    o = torch.zeros(M, cpo)
    o[:, :C] = (y[:, :C] + b2).to(cdt).float()

    def row_sum(v):  # the halves' sums, added in order
        s = None
        for a, b in halves:
            t = v[:, a:b].sum(1, keepdim=True)
            s = t if s is None else s + t
        return s

    mu = row_sum(o) / C
    rs = torch.rsqrt(torch.clamp(row_sum(o * o) / C - mu * mu, min=0.0) + eps)
    img = torch.arange(M) // L
    sc = torch.zeros(M, cpo)
    sc[:, :C] = scale[img]
    if dy is None:
        sh = shift[img]
        v = (sc[:, :C] * ((o[:, :C] - mu) * rs) + sh).to(cdt).float()
        return (xf + v).to(cdt).reshape(B, L, C)
    yhat = (o - mu) * rs
    d = torch.zeros(M, cpo)
    d[:, :C] = dy.float().reshape(-1, C)
    h = d * sc
    m1, m2 = row_sum(h) / C, row_sum(h * yhat) / C
    do = rs * (h - m1 - yhat * m2)
    do[:, C:] = 0
    dob = do.to(cdt).float()

    def tile_sums(v):  # per warp's 16 rows, then the partials in order
        parts = v.reshape(M // 16, 16, -1).sum(1)
        out = torch.zeros(parts.shape[1])
        for t in range(parts.shape[0]):
            out = out + parts[t]
        return out, parts

    db2, _ = tile_sums(do[:, :C])
    _, ps = tile_sums((d * yhat)[:, :C])
    _, pd = tile_sums(d[:, :C])
    per_image = L // 16
    dscale = torch.stack([ps[i * per_image:(i + 1) * per_image].sum(0) for i in range(B)])
    dshift = torch.stack([pd[i * per_image:(i + 1) * per_image].sum(0) for i in range(B)])
    # Walk 2.
    w2t = torch.zeros(fp, C)
    w2t[:F] = w2.float().t()
    w1t = torch.zeros(cpo, fp)
    w1t[:C, :F] = w1.float().t()
    dx = torch.zeros(M, cpo)
    dus, gts = [], []
    for j in range(fp // fs):
        dh = torch.cat([_chunked(dob[:, :C], w2t[j * fs + k * ft: j * fs + (k + 1) * ft], kc)
                        for k in range(fs // ft)], dim=1)
        u = us[j]  # kept, or recomputed to the same bits
        du = dh * _dgelu(u)
        dub = du.to(cdt).float()
        dus.append(du)
        gts.append(gs[j])
        for p0 in range(0, fs, kp):
            dx = dx + dub[:, p0:p0 + kp] @ w1t[:, j * fs + p0: j * fs + p0 + kp].t()
    dxo = (dx[:, :C] + d[:, :C]).to(cdt).reshape(B, L, C)
    du_all, g_all = torch.cat(dus, 1), torch.cat(gts, 1)
    db1, _ = tile_sums(du_all)
    dub_all = du_all.to(cdt).float()
    dw1 = (dub_all.t() @ xf)[:F]
    dw2 = (dob[:, :C].t() @ g_all)[:, :F]
    return dxo, dw1, db1[:F], dw2, db2, dscale, dshift


def _inputs(b, l, c, f, dtype, seed=3):
    x, w1, b1, w2, b2, scale, shift, dy = make(b, l, c, f, seed=seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (t(x).to(dtype), t(w1.T).to(dtype), t(b1), t(w2.T).to(dtype), t(b2), t(scale),
            t(shift), t(dy).to(dtype)), (x, w1, b1, w2, b2, scale, shift, dy)


def _rel(a, r):
    return float((a.float() - r.float()).norm() / max(float(r.float().norm()), 1e-30))


SCHEDULE = [(1, 128, 17, 52), (3, 128, 17, 52), (1, 128, 64, 193), (3, 128, 64, 193),
            (1, 128, 200, 601), (3, 128, 200, 601), (1, 128, 384, 1000)]


@pytest.mark.parametrize("b,l,c,f", SCHEDULE)
def test_schedule_matches_plain_and_jax_in_fp32(b, l, c, f):
    (x, w1, b1, w2, b2, scale, shift, dy), np_in = _inputs(b, l, c, f, torch.float32)
    m = b * l
    names = ("dx", "dw1", "db1", "dw2", "db2", "dscale", "dshift")
    plain_out = mlp_op.mlp_cln_plain(x, w1, b1, w2, b2, scale, shift, EPS)
    plain_bwd = mlp_op.mlp_cln_bwd_plain(x, w1, b1, w2, b2, scale, EPS, dy)
    jx, jw1, jb1, jw2, jb2, jsc, jsh, jdy = np_in
    out_j, vjp = jax.vjp(lambda *a: jmlp.fused_mlp_cln(*a, eps=EPS), jnp.asarray(jx),
                         jnp.asarray(jw1), jnp.asarray(jb1), jnp.asarray(jw2), jnp.asarray(jb2),
                         jnp.asarray(jsc), jnp.asarray(jsh))
    jg = vjp(jnp.asarray(jdy))
    ref_j = [np.asarray(out_j)] + [np.asarray(jg[0]), np.asarray(jg[1]).T, np.asarray(jg[2]),
                                   np.asarray(jg[3]).T, np.asarray(jg[4]), np.asarray(jg[5]),
                                   np.asarray(jg[6])]
    # Every plan the kernel could take at this width: one row tile a CTA, and
    # two where the width allows (forced here: the planner picks two only at
    # the card-filling M of ScOT's stage 0).
    parts = [mlp_op.tail_plan(m, c, f, torch.float32)["bwd"]]
    two = mlp_op._rows_plan(c, f, True, True, 2) if m % 128 == 0 else None
    if two is not None:
        parts.append(dict(two, ctas=m // 128))
    for part in parts:
        out = emulate(x, w1, b1, w2, b2, scale, shift, EPS, None, part)
        assert _rel(out, plain_out) <= 1e-5
        np.testing.assert_allclose(out.numpy(), ref_j[0], atol=ATOL["float32"],
                                   rtol=RTOL["float32"], err_msg="out")
        grads = emulate(x, w1, b1, w2, b2, scale, shift, EPS, dy, part)
        for i, (name, a, r) in enumerate(zip(names, grads, plain_bwd)):
            assert a.shape == r.shape, name
            assert _rel(a, r) <= 1e-5 or float((a - r).abs().max()) <= 1e-7, (name, _rel(a, r))
            np.testing.assert_allclose(a.numpy(), ref_j[i + 1], atol=ATOL["float32"],
                                       rtol=RTOL["float32"], err_msg=name)


@pytest.mark.parametrize("b,l,c,f", [(3, 128, 17, 52), (1, 128, 200, 601), (1, 128, 384, 1000)])
def test_schedule_matches_plain_in_bf16(b, l, c, f):
    (x, w1, b1, w2, b2, scale, shift, dy), _ = _inputs(b, l, c, f, torch.bfloat16)
    part = mlp_op.tail_plan(b * l, c, f, torch.bfloat16)["bwd"]
    out = emulate(x, w1, b1, w2, b2, scale, shift, EPS, None, part)
    assert out.dtype == torch.bfloat16
    assert _rel(out, mlp_op.mlp_cln_plain(x, w1, b1, w2, b2, scale, shift, EPS)) <= 3e-2
    grads = emulate(x, w1, b1, w2, b2, scale, shift, EPS, dy, part)
    for a, r in zip(grads, mlp_op.mlp_cln_bwd_plain(x, w1, b1, w2, b2, scale, EPS, dy)):
        assert a.shape == r.shape and _rel(a, r) <= 3e-2
