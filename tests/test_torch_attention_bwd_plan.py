"""The window-attention backward kernel's plan and its packed tiles, on the
CPU at toy sizes (no card).

- ``bwd_plan`` at every attention block of ScOT-B, ScOT-L and ScOT-T at
  batch 32 and at the bench's batches (ScOT-B 128, ScOT-L 64), on the
  H100's resident clusters (``H100_BWD_CLUSTERS``): P = 64 // T windows a
  tile at T <= 32 (1 above), at least 132 CTAs where the windows allow (at
  T = 256 the 30 clusters of four CTAs an H100 holds at once: 120), the dbm
  partials within the stated budget, and G the fewest rounds by its own
  definition.
- A plain PyTorch emulation of the kernel's tiles (``packed_bwd``): P
  windows of one bias slot and head in a block-diagonal 64-key tile, -inf
  off the diagonal blocks, padded and missing rows masked as the kernel
  masks them, with ``attention_bwd_plain``'s rounding points, unpacked. It
  equals ``attention_bwd_plain`` at T in {4, 9, 16, 25, 32, 49}, nW in {1,
  4} and window counts P does not divide: fp32 operands within atol = rtol
  = 1e-5 (the two differ only in fp32 sum order: the 64-key rows add zeros,
  and dbm sums tiles and folds blocks), bf16 operands with the card tests'
  tolerances (dq, dk, dv allclose 3e-2: a sum-order flip moves a bf16
  rounding by one ulp; dbm, dscale relative L2 1e-2).
- The emulation at T = 16 against the JAX package's ``_core_bwd_qkv`` (the
  Pallas kernel in interpret mode), on its operand layout as
  ``test_torch_attention_grad.py::test_bwd_matches_core_bwd_qkv`` runs it:
  fp32, atol = rtol = 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from poseidon_tpu.ops import window_attention as jwa

import poseidon_tpu_torch as pt
from poseidon_tpu_torch.ops import window_attention as wa

from test_torch_attention_op import make, to_qkv3

torch.set_num_threads(1)

SMS = 132


def _shapes():
    """(name, n_windows, T, heads, nW) of every attention block kind."""
    out = []
    for name, batches in (("B", (32, 128)), ("L", (32, 64)), ("T", (32,))):
        cfg = pt.make_config(name, image_size=128, num_channels=4, num_out_channels=4)
        for batch in batches:
            for i in range(cfg.num_stages):
                res, heads = cfg.stage_resolution(i), cfg.num_heads[i]
                for shifted in (False, True):
                    window, shift = cfg.stage_window_and_shift(i, shifted)
                    if shifted and not shift:
                        continue
                    nw_img = (res // window) ** 2
                    out.append((f"{name} b{batch} stage{i}{' shifted' if shift else ''}",
                                batch * nw_img, window * window, heads, nw_img if shift else 1))
    return out


SHAPES = _shapes()


@pytest.mark.parametrize("name,n,t,heads,nw", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan(name, n, t, heads, nw):
    pack, groups, ctas = wa.bwd_plan(n, nw, heads, t)
    assert pack == (64 // t if t <= 32 else 1)
    tiles = -(-(n // nw) // pack)
    cluster = 1 if t <= 64 else 2 if t <= 128 else 4
    slots = wa.H100_BWD_CLUSTERS[64 * cluster]
    assert 1 <= groups <= tiles and ctas == nw * heads * groups * cluster
    partials = groups * nw * heads * t * t * 4
    assert partials <= wa.BWD_PARTIAL_BUDGET or groups == 1
    cap = max(1, min(tiles, wa.BWD_PARTIAL_BUDGET // (nw * heads * t * t * 4)))
    # The card filled where the windows allow: at least 132 CTAs, or every
    # cluster slot (clusters of four CTAs: 30 fit at once, 120 CTAs).
    assert ctas >= min(SMS, slots * cluster, nw * heads * cap * cluster)

    def rounds(g):
        return -(-nw * heads * g // slots) * -(-tiles // g)

    assert rounds(groups) == min(rounds(g) for g in range(1, cap + 1))
    assert all(rounds(g) > rounds(groups) for g in range(1, groups))


def _rnd(x, cdt):
    return x.to(cdt).float()


def packed_bwd(q, k, v, bm, scale, do):
    """The backward kernel's tiling in plain PyTorch on (N, T, H, D) q, k,
    v, do: for each bias slot, its windows slot + nW j in tiles of P =
    ``bwd_pack(T)`` (rows p T + t of a 64-row tile, zeros past the last
    window), S's starting values bm on the diagonal blocks, -inf off them
    and on padded keys, 0 on padded queries; queries without a window give
    nothing. Returns (dq, dk, dv, dbm, dscale) as ``attention_bwd_plain``."""
    n, t, heads, d = q.shape
    nw, cdt = bm.shape[0], q.dtype
    pack = wa.bwd_pack(t)
    rows = 64 if t <= 64 else t
    per = n // nw
    r = torch.arange(rows)
    blk = r // t
    same = blk[:, None] == blk[None, :]
    dq, dk, dv = (torch.zeros(n, t, heads, d) for _ in range(3))
    dbm_tile = torch.zeros(nw, heads, rows, rows)
    dscale = torch.zeros(heads)
    sc = scale.reshape(heads, 1, 1)
    for slot in range(nw):
        start = torch.zeros(heads, rows, rows)  # (query, key)
        for p in range(pack):
            start[:, p * t:(p + 1) * t, p * t:(p + 1) * t] = bm[slot]
        start = torch.where(same & (blk[None, :] < pack), start, torch.full_like(start, -np.inf))
        start = torch.where((blk < pack)[:, None], start, torch.zeros_like(start))
        for tau in range(-(-per // pack)):
            wins = [slot + nw * (tau * pack + p) for p in range(pack) if tau * pack + p < per]
            nv = len(wins) * t

            def tile(x):
                out = torch.zeros(heads, rows, d)
                out[:, :nv] = x[wins].float().reshape(nv, heads, d).transpose(0, 1)
                return out

            qf, kf, vf, dof = tile(q), tile(k), tile(v), tile(do)
            qnorm = torch.clamp(torch.linalg.vector_norm(qf, dim=-1, keepdim=True), min=1e-12)
            knorm = torch.clamp(torch.linalg.vector_norm(kf, dim=-1, keepdim=True), min=1e-12)
            qn, kn = qf / qnorm, kf / knorm
            qsb, knb = _rnd(qn * sc, cdt), _rnd(kn, cdt)
            s = qsb @ knb.transpose(1, 2) + start
            e = torch.exp(s - s.amax(dim=-1, keepdim=True))
            den = e.sum(dim=-1, keepdim=True)
            valid = (r < nv)[None, :, None]
            e = torch.where(valid, e, torch.zeros_like(e))
            dod = _rnd(dof / den, cdt)
            dvt = _rnd(e, cdt).transpose(1, 2) @ dod
            dp = _rnd(dof, cdt) @ vf.transpose(1, 2)
            ds = e * ((dp - (dp * e).sum(dim=-1, keepdim=True) / den) / den)
            dsb = _rnd(ds, cdt)
            dqs = dsb @ knb
            dkn = dsb.transpose(1, 2) @ qsb
            dscale += ((dqs * qn).sum(dim=-1) * (r < nv)).sum(dim=-1)

            def norm_bwd(dxn, xn, nrm):
                return (dxn - xn * (dxn * xn).sum(dim=-1, keepdim=True)) / nrm

            dqt = norm_bwd(dqs * sc, qn, qnorm).to(cdt)
            dkt = norm_bwd(dkn, kn, knorm).to(cdt)
            for out, val in ((dq, dqt), (dk, dkt), (dv, dvt.to(cdt))):
                out[wins] = val[:, :nv].transpose(0, 1).reshape(len(wins), t, heads, d).float()
            dbm_tile[slot] += ds
    dbm = sum(dbm_tile[:, :, p * t:(p + 1) * t, p * t:(p + 1) * t] for p in range(pack))
    return dq.to(cdt), dk.to(cdt), dv.to(cdt), dbm, dscale


def _inputs(n, t, heads, d, nw, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(n, t, heads, d)).astype(np.float32))
                   for _ in range(4))
    bm = 2.0 * rng.normal(size=(nw, heads, t, t))
    if nw > 1:
        bm[1, :, : t // 2, t // 2:] -= 200.0
        bm[1, :, t // 2:, : t // 2] -= 200.0
    scale = rng.uniform(1.0, 10.0, size=(heads,))
    return q, k, v, do, torch.from_numpy(bm.astype(np.float32)), \
        torch.from_numpy(scale.astype(np.float32))


PACKED = [(t, nw, dtype) for t in (4, 9, 16, 25, 32, 49) for nw in (1, 4)
          for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("t,nw,dtype", PACKED)
def test_packed_tiles_equal_plain(t, nw, dtype):
    pack = wa.bwd_pack(t)
    per = 2 * pack + 1 if pack > 1 else 3  # a part-filled last tile where P > 1
    heads, d = 2, 16
    q, k, v, do, bm, scale = _inputs(nw * per, t, heads, d, nw, seed=t + nw)
    cdt = getattr(torch, dtype)
    q, k, v, do = (a.to(cdt) for a in (q, k, v, do))
    got = packed_bwd(q, k, v, bm, scale, do)
    ref = wa.attention_bwd_plain(q, k, v, bm, scale, do)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
    if dtype == "float32":
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    else:
        for a, b in zip(got[:3], ref[:3]):
            torch.testing.assert_close(a.float(), b.float(), atol=3e-2, rtol=3e-2)
        for a, b in zip(got[3:], ref[3:]):
            assert float((a - b).norm() / b.norm()) <= 1e-2


def test_packed_tiles_match_core_bwd_qkv():
    """T = 16, P = 4: nine windows (three tiles, the last with one window)
    of one bias slot, four heads, against the Pallas backward kernel."""
    t, h, nw, n, d = 16, 4, 1, 9, 32
    qkv, qb, bias, mask, scale = make(n, h, t, d, nw, seed=12, scale_hi=10.0)
    do = np.random.default_rng(13).normal(size=(n, t, h * d)).astype(np.float32)
    base = nw * h
    bm = bias[None] + mask[:, None]
    srow = np.broadcast_to(scale[None, :, None], (nw, h, t)).reshape(base, 1, t)
    qbt = np.broadcast_to(qb.reshape(1, h, d, 1), (nw, h, d, 1)).reshape(base, d, 1)
    dqkv3, dqb_j, dbm_j, dsrow_j = jwa._core_bwd_qkv(
        to_qkv3(qkv, jnp.float32).reshape(3, n * h, d, t), jnp.asarray(qbt),
        jnp.asarray(bm.reshape(base, t, t)), jnp.asarray(srow),
        jnp.asarray(do.reshape(n, t, h * d).transpose(0, 2, 1).reshape(n * h, d, t)))
    q, k, v = torch.from_numpy(qkv).reshape(n, t, 3, h, d).unbind(2)
    q = q + torch.from_numpy(qb).reshape(h, d)
    dq, dk, dv, dbm, dscale = packed_bwd(q, k, v, torch.from_numpy(np.ascontiguousarray(bm)),
                                         torch.from_numpy(scale),
                                         torch.from_numpy(do).reshape(n, t, h, d))
    assert wa.bwd_pack(t) == 4
    ref_qkv = np.asarray(dqkv3).reshape(3, n, h * d, t).transpose(1, 3, 0, 2).reshape(n, t, -1)
    got_qkv = torch.stack([dq, dk, dv], dim=2).reshape(n, t, -1).numpy()
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_qkv, ref_qkv, **tol)
    np.testing.assert_allclose(dq.sum(dim=(0, 1)).reshape(-1).numpy(),
                               np.asarray(dqb_j).reshape(nw, h * d).sum(0), **tol)
    np.testing.assert_allclose(dbm.numpy(), np.asarray(dbm_j).reshape(nw, h, t, t), **tol)
    np.testing.assert_allclose(dscale.numpy(), np.asarray(dsrow_j).reshape(nw, h, t).sum((0, 2)),
                               **tol)
