"""Dropout in the port: the four sites of the JAX package (attention
probabilities, attention output projection, block MLP output, embedding),
each drawn from the caller's ``torch.Generator``. The two frameworks draw
different bits, so the masks are not compared with JAX; what is held:
eval mode and rate 0 are the identity, the kept share in train mode is
within binomial bounds, and the attention block leaves its kernel path
exactly when attention dropout is active in train mode."""

import math

import pytest
import torch

import poseidon_tpu_torch as pt
from poseidon_tpu_torch.models import attention as attn_mod
from poseidon_tpu_torch.models.layers import dropout
from poseidon_tpu_torch.ops import window_attention as wa

torch.set_num_threads(1)

TOY = dict(image_size=32, patch_size=4, num_channels=2, num_out_channels=2, embed_dim=16,
           depths=(2, 2), num_heads=(2, 2), skip_connections=(1, 0), window_size=4)


def test_identity_in_eval_and_at_rate_zero():
    x = torch.randn(4, 8, 16)
    g = torch.Generator().manual_seed(0)
    assert dropout(x, 0.3, training=False, generator=g) is x
    assert dropout(x, 0.0, training=True, generator=g) is x
    assert torch.equal(dropout(x, 1.0, training=True, generator=g), torch.zeros_like(x))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_kept_share_within_binomial_bounds(rate):
    n = 200_000
    x = torch.ones(n)
    y = dropout(x, rate, training=True, generator=torch.Generator().manual_seed(1))
    kept = y != 0
    keep = 1.0 - rate
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1.0 / keep))
    sd = math.sqrt(n * keep * (1.0 - keep))
    assert abs(int(kept.sum()) - n * keep) <= 5.0 * sd


def test_same_generator_state_same_mask():
    x = torch.randn(1000)
    a = dropout(x, 0.5, True, torch.Generator().manual_seed(7))
    b = dropout(x, 0.5, True, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)


def _count_kernel_calls(monkeypatch):
    calls = []
    orig = wa.window_attention_plain
    monkeypatch.setattr(wa, "window_attention_plain", lambda *a: calls.append(1) or orig(*a))
    return calls


@pytest.mark.parametrize("train,attn_rate,hidden_rate,kernel", [
    (False, 0.0, 0.0, True), (True, 0.0, 0.0, True), (True, 0.0, 0.2, True),
    (False, 0.2, 0.0, True), (True, 0.2, 0.0, False)])
def test_kernel_path_gives_way_only_under_active_attention_dropout(
        train, attn_rate, hidden_rate, kernel, monkeypatch):
    calls = _count_kernel_calls(monkeypatch)
    cfg = pt.make_config("T", attention_impl="pallas", attention_probs_dropout_prob=attn_rate,
                         hidden_dropout_prob=hidden_rate, **TOY)
    model = pt.build_model(cfg, device="cpu").train(train)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 2, 32, 32, generator=gen)
    y = model(x, torch.full((2,), 0.5), generator=gen)
    assert torch.isfinite(y).all()
    blocks = [m for m in model.modules() if isinstance(m, attn_mod.WindowAttention)]
    assert all(b.uses_kernel() == kernel for b in blocks)
    assert len(calls) == (len(blocks) if kernel else 0)


@pytest.mark.parametrize("field", ["hidden_dropout_prob", "attention_probs_dropout_prob"])
def test_train_mode_dropout_changes_the_output_and_eval_does_not(field):
    cfg = pt.make_config("T", **{field: 0.3}, **TOY)
    model = pt.build_model(cfg, device="cpu")
    with torch.no_grad():
        for p in model.parameters():   # weights away from init, so every site matters
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(3)))
    x = torch.randn(2, 2, 32, 32, generator=torch.Generator().manual_seed(4))
    t = torch.full((2,), 0.5)
    with torch.no_grad():
        ref = model.eval()(x, t)
        assert torch.equal(model(x, t, generator=torch.Generator().manual_seed(5)), ref)
        model.train()
        a = model(x, t, generator=torch.Generator().manual_seed(5))
        b = model(x, t, generator=torch.Generator().manual_seed(5))
        c = model(x, t, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, ref) and not torch.equal(a, c)
