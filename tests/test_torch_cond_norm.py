"""The conditional LayerNorm's kernels through their plain twin
(``poseidon_tpu_torch/ops/norm.py``), on the CPU:

- the twin's forward and its explicit backward formulas (dx, and the four
  map gradients through the per-image sums) against autograd of the chain
  in ``models/layers.py::ConditionalLayerNorm``, fp32 and bf16, on (B, L, C)
  tokens and NHWC (B, H, W, C) images, at every width of ScOT-T/B/L and 16
  to 1024 rows an image, with a lead time per image, one of them 0; rows
  whose variance clamps pass no gradient through it, as autograd of the
  clamp passes none;
- the twin against the JAX package's ``ConditionalLayerNorm`` and its VJP
  on the same weights (fp32);
- the kernels' plan: its invariants at every ScOT shape and at rows an
  image that no power of two divides, and the backward's per-CTA partials,
  reduced in tile order with each tile's lead time, equal to the twin's
  per-image sums (every tile lies in one image; an image's last may be
  short);
- the dispatch: ``"xla"`` and the CPU take the chain, and the operands the
  kernels do not take raise; the state dict is the chain module's;
- the launch counters of the new kernels.

Tolerances: the twin and the chain run the same fp32 statistics, so the
forward agrees to fp32 rounding (1e-5) and in bf16 to one flip of the final
rounding (2^-7 relative); dx and the sums by another order of the same
fp32 arithmetic, relative L2 1e-5 (bf16 dx: 1e-2, rounding flips).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu.models import layers as jl
from poseidon_tpu_torch import ops
from poseidon_tpu_torch.models import layers as pl
from poseidon_tpu_torch.ops import norm

torch.set_num_threads(1)

TIMES = (0.0, 0.37, 2.5)
# (C, rows an image): every width of ScOT-T/B/L, 16 to 1024 rows.
SHAPES = [(48, 1024), (96, 1024), (192, 256), (384, 64), (768, 16), (1536, 16)]
# ScOT-T, -B and -L at 128 x 128: (C, rows an image) of every conditional norm.
SCOT_NORMS = sorted({(c, l) for e in (48, 96, 192) for i in range(4)
                     for c, l in ((e << i, 1024 >> (2 * i)),)})
# (C, rows an image) whose images end in a short tile: stage 3 at 64 x 64
# (4 rows), one row, and odd counts.
RAGGED = [(768, 4), (1536, 1), (96, 40), (192, 49), (384, 3), (48, 1000)]


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def _module(c, seed):
    g = torch.Generator().manual_seed(seed)
    m = pl.ConditionalLayerNorm(c)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
        m.weight.bias.add_(1.0)
    return m


def _maps(m):
    return m.weight.weight, m.weight.bias, m.bias.weight, m.bias.bias


def _values(m):
    return tuple(p.detach() for p in _maps(m))


def _inputs(c, rows, nhwc, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    side = int(rows ** 0.5)
    shape = (len(TIMES), side, side, c) if nhwc else (len(TIMES), rows, c)
    x = (3 * torch.randn(shape, generator=g) + 1).to(dtype)
    dy = torch.randn(shape, generator=g).to(dtype)
    return x, torch.tensor(TIMES), dy


def _chain(m, x, t, dy):
    x = x.clone().requires_grad_()
    y = m(x, t)
    return (y.detach(), *torch.autograd.grad(y, [x, *_maps(m)], dy))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("nhwc", [False, True], ids=["tokens", "nhwc"])
@pytest.mark.parametrize("c,rows", SHAPES)
def test_twin_matches_autograd_of_chain(c, rows, nhwc, dtype):
    m = _module(c, seed=c)
    x, t, dy = _inputs(c, rows, nhwc, dtype, seed=rows)
    want = _chain(m, x, t, dy)
    y, mean, rstd = norm.cond_layer_norm_plain(x, t, *_values(m), m.eps)
    got = (y, *norm.cond_layer_norm_bwd_plain(x, t, *_values(m)[:2], mean, rstd, dy))
    assert y.dtype == dtype and got[1].dtype == dtype and mean.shape == x.shape[:-1]
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(y.float().numpy(), want[0].float().numpy(), rtol=tol, atol=tol)
    assert _rel(got[1], want[1]) <= (1e-5 if dtype == torch.float32 else 1e-2)
    for name, a, b in zip(("dw_scale", "db_scale", "dw_shift", "db_shift"), got[2:], want[2:]):
        assert a.shape == b.shape and _rel(a, b) <= 1e-5, name
    # Image 0, at lead time 0, adds nothing to the weights' gradients.
    rest = norm.cond_layer_norm_bwd_plain(x[1:], t[1:], *_values(m)[:2], mean[1:], rstd[1:], dy[1:])
    assert _rel(got[2], rest[1]) <= 1e-6 and _rel(got[4], rest[3]) <= 1e-6


def test_twin_function_matches_twin():
    # On the CPU the autograd Function runs the twin, bit for bit.
    m = _module(96, seed=1)
    x, t, dy = _inputs(96, 64, False, torch.bfloat16, seed=2)
    y, mean, rstd = norm.cond_layer_norm_plain(x, t, *_values(m), m.eps)
    want = norm.cond_layer_norm_bwd_plain(x, t, *_values(m)[:2], mean, rstd, dy)
    xr = x.clone().requires_grad_()
    out = norm.cond_layer_norm(xr, t, *_maps(m), m.eps)
    got = torch.autograd.grad(out, [xr, *_maps(m)], dy)
    assert torch.equal(out, y)
    for a, b in zip(got, want):
        assert torch.equal(a, b.view_as(a))


def test_clamped_variance_passes_no_gradient_through_it():
    # Rows of mean 1000 and spread 1e-3, near the rounding of E[x^2] - mu^2:
    # it goes negative on about half of them, where autograd of the clamp
    # passes no gradient through the variance, and neither does the twin
    # (rstd < 0 flags them). There the two agree to fp32 rounding, and the
    # dropped term is ~1% of dx. On the other rows the chain's own gradient
    # through E[x^2] - mu^2 loses ~1e-3 to cancellation at this mean.
    m = _module(96, seed=3)
    g = torch.Generator().manual_seed(4)
    x = 1000.0 + 1e-3 * torch.randn(3, 64, 96, generator=g)
    dy = torch.randn(3, 64, 96, generator=g)
    t = torch.tensor(TIMES)
    want = _chain(m, x, t, dy)[1]
    y, mean, rstd = norm.cond_layer_norm_plain(x, t, *_values(m), m.eps)
    clamped = rstd < 0
    assert 0 < int(clamped.sum()) < clamped.numel()
    dx = norm.cond_layer_norm_bwd_plain(x, t, *_values(m)[:2], mean, rstd, dy)[0]
    assert _rel(dx[clamped], want[clamped]) <= 1e-5
    assert _rel(dx[~clamped], want[~clamped]) <= 1e-2
    unflagged = norm.cond_layer_norm_bwd_plain(x, t, *_values(m)[:2], mean, rstd.abs(), dy)[0]
    assert _rel(unflagged[clamped], want[clamped]) > 3e-3


@pytest.mark.parametrize("shape", [(3, 1024, 48), (3, 256, 192), (3, 8, 8, 384), (3, 16, 1536)])
def test_twin_matches_jax_conditional_norm(shape):
    c = shape[-1]
    rng = np.random.default_rng(c)
    x = (3 * rng.normal(size=shape) + 1).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    t = np.asarray(TIMES, np.float32)
    params = {k: {"kernel": rng.normal(size=(1, c)).astype(np.float32),
                  "bias": (1.0 + rng.normal(size=c)).astype(np.float32)}
              for k in ("cond_scale", "cond_shift")}
    fm = jl.ConditionalLayerNorm(dim=c, eps=1e-5)
    y_j, vjp = jax.vjp(lambda p, xx: fm.apply({"params": p}, xx, t), params, jnp.asarray(x))
    dp_j, dx_j = vjp(jnp.asarray(dy))
    maps = [torch.from_numpy(a) for a in (params["cond_scale"]["kernel"].T.copy(),
                                          params["cond_scale"]["bias"],
                                          params["cond_shift"]["kernel"].T.copy(),
                                          params["cond_shift"]["bias"])]
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    y, mean, rstd = norm.cond_layer_norm_plain(xt, tt, *maps, 1e-5)
    dx, dws, dbs, dwb, dbb = norm.cond_layer_norm_bwd_plain(xt, tt, *maps[:2], mean, rstd,
                                                            torch.from_numpy(dy))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    assert _rel(dx, torch.from_numpy(np.array(dx_j))) <= 1e-5
    for got, want in ((dws, dp_j["cond_scale"]["kernel"].T), (dbs, dp_j["cond_scale"]["bias"]),
                      (dwb, dp_j["cond_shift"]["kernel"].T), (dbb, dp_j["cond_shift"]["bias"])):
        assert _rel(got, torch.from_numpy(np.array(want))) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("batch", [1, 128, 256])
def test_plan_fits_every_scot_norm(batch, dtype):
    for c, l in SCOT_NORMS:
        m = batch * l
        for bwd in (False, True):
            p = norm.plan(m, c, l, dtype, bwd)
            groups = p["threads"] // p["g"]
            assert p["g"] in (1, 2, 4, 8, 16, 32) and 32 <= p["threads"] <= 256
            assert p["threads"] % 32 == 0 and p["rows"] % groups == 0
            assert l % p["rows"] == 0 and p["tiles"] * p["rows"] == m
            assert p["tiles_per_image"] * p["rows"] == l
            assert c // (8 if dtype == torch.bfloat16 else 4) <= p["nv"] * p["g"]
            assert p["rows"] // groups <= 16
            assert p["nv"] <= 6 or dtype == torch.float32  # NV 12: fp32 only


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("c,l", RAGGED)
def test_plan_covers_rows_no_power_of_two_divides(c, l, dtype):
    for batch in (1, 3, 256):
        for bwd in (False, True):
            p = norm.plan(batch * l, c, l, dtype, bwd)
            groups = p["threads"] // p["g"]
            assert 32 <= p["threads"] <= 256 and p["threads"] % 32 == 0
            assert p["rows"] % groups == 0 and p["rows"] // groups <= 16
            assert p["tiles_per_image"] == -(-l // p["rows"])
            assert (p["tiles_per_image"] - 1) * p["rows"] < l
            assert p["tiles"] == batch * p["tiles_per_image"]
            assert c // (8 if dtype == torch.bfloat16 else 4) <= p["nv"] * p["g"]
            assert p["nv"] <= 6 or dtype == torch.float32  # NV 12: fp32 only


@pytest.mark.parametrize("c,rows", [(96, 1024), (768, 16), (768, 4), (96, 40)])
def test_tile_partials_reduce_to_the_twins_sums(c, rows):
    # The backward kernels' order of summation, emulated: each CTA's column
    # sums over its plan's rows (an image's last tile the rest of it), then
    # every tile weighted by its image's t.
    m = _module(c, seed=5)
    x = torch.randn(len(TIMES), rows, c, generator=torch.Generator().manual_seed(6))
    t, dy = torch.tensor(TIMES), torch.randn_like(x)
    y, mean, rstd = norm.cond_layer_norm_plain(x, t, *_values(m), m.eps)
    want = norm.cond_layer_norm_bwd_plain(x, t, *_values(m)[:2], mean, rstd, dy)[1:]
    p = norm.plan(x.numel() // c, c, rows, x.dtype, True)
    xhat = (x - mean[..., None]) * rstd.abs()[..., None]
    part = torch.stack([torch.stack([a.sum(0) for img in v for a in img.split(p["rows"])])
                        for v in (dy * xhat, dy)], 1)
    assert part.shape == (p["tiles"], 2, c)
    tt = t.repeat_interleave(p["tiles_per_image"])[:, None]
    got = ((tt * part[:, 0]).sum(0), part[:, 0].sum(0), (tt * part[:, 1]).sum(0),
           part[:, 1].sum(0))
    for a, b in zip(got, want):
        assert _rel(a, b.reshape(-1)) <= 1e-5


def _refused(*args):
    try:
        norm._operands(*args)
    except ValueError:
        return True
    return False


def test_operands_the_kernels_do_not_take_raise():
    m = _module(96, seed=7)
    x = torch.randn(2, 64, 96)
    t = torch.tensor([0.1, 0.2])
    maps = _maps(m)
    # Any rows an image, tokens or NHWC; in fp32 C a multiple of 4.
    for ok in (x, x.bfloat16(), torch.randn(2, 4, 4, 96), torch.randn(2, 40, 96),
               torch.randn(2, 1, 96)):
        l = ok.numel() // (2 * 96)
        assert norm._operands(ok, t, *maps) == (2 * l, 96, l)
    assert norm._operands(torch.randn(2, 16, 44), t, *_maps(_module(44, seed=8))) == (32, 44, 16)
    refused = {
        "fp16": (x.half(), t),
        "not contiguous": (x.transpose(0, 1).contiguous().transpose(0, 1), t),
        "a time per row": (x, torch.rand(128)),
        "a time that needs a gradient": (x, t.clone().requires_grad_()),
        "misaligned": (torch.randn(2 * 64 * 96 + 1)[1:].view(2, 64, 96), t),
    }
    for why, (xx, tt) in refused.items():
        assert _refused(xx, tt, *maps), why
    for c, dtype in ((44, torch.bfloat16), (42, torch.float32), (1544, torch.bfloat16)):
        assert _refused(torch.randn(2, 16, c).to(dtype), t, *_maps(_module(c, seed=8))), c
    assert _refused(x, t, maps[0].double(), *maps[1:])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_cpu_and_xla_take_the_chain(impl, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernels' op was called")

    monkeypatch.setattr(norm, "cond_layer_norm", refuse)
    m = _module(96, seed=9)
    mk = pl.make_norm(True, 96, 1e-5, torch.bfloat16, impl)
    mk.load_state_dict(m.state_dict())
    assert mk.impl == impl
    x, t, dy = _inputs(96, 64, False, torch.bfloat16, seed=10)
    for a, b in zip(_chain(mk, x, t, dy), _chain(m, x, t, dy)):
        assert torch.equal(a, b)


def test_state_dict_keys_unchanged():
    import poseidon_tpu_torch as pt

    keys = {"weight.weight", "weight.bias", "bias.weight", "bias.bias"}
    assert set(pl.make_norm(True, 96, 1e-5, torch.float32, "pallas").state_dict()) == keys
    sds = []
    for impl in ("xla", "pallas"):
        cfg = pt.make_config("T", image_size=32, num_channels=2, num_out_channels=2,
                             channel_slice_list=(0, 1, 2), use_conditioning=True,
                             attention_impl=impl, depths=(1, 1), num_heads=(3, 6),
                             skip_connections=(1, 0), window_size=8)
        sds.append({k: tuple(v.shape) for k, v in pt.ScOT(cfg).state_dict().items()})
    assert sds[0] == sds[1]
    conds = [mod for mod in pt.ScOT(cfg).modules() if isinstance(mod, pl.ConditionalLayerNorm)]
    assert conds and all(mod.impl == "pallas" for mod in conds)


def test_launch_counters_count_the_norm_kernels():
    names = [n for n, _, _ in ops.COUNTERS]
    assert names[-2:] == ["cond_layer_norm_fwd", "cond_layer_norm_bwd"]
    ops.reset_launch_counts()
    m = _module(96, seed=11)
    x, t, dy = _inputs(96, 64, False, torch.float32, seed=12)
    xr = x.clone().requires_grad_()
    norm.cond_layer_norm(xr, t, *_maps(m)).backward(dy)
    assert not any(ops.launch_counts().values())  # the twin on the CPU launches nothing
    norm.cond_layer_norm.launches += 141
    norm.cond_layer_norm_bwd.launches += 141
    ops.add_launch_counts({"cond_layer_norm_fwd": 141, "cond_layer_norm_bwd": 141})
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {"cond_layer_norm_fwd": 282, "cond_layer_norm_bwd": 282}
    ops.reset_launch_counts()
    assert not any(ops.launch_counts().values())
