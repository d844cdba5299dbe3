"""Gradient checkpointing in the port (``ScOT(remat=...)``, the JAX
package's modes ``True``, ``"save_all"``, ``"save_dots"``): in train mode
with hidden dropout, attention dropout and drop-path on, every mode gives
the loss, the gradients and the generator's end state of the step without
checkpointing, bit for bit on the CPU (the recompute replays the forward's
masks from the generator state saved at block entry, and puts the state
back). ``True`` and ``"save_dots"`` run each block's forward twice,
``"save_all"`` once. One Trainer step with ``gradient_checkpointing=True``
(the model built with ``remat=True``, as the train CLI builds it) ends on
the weights of the step without it. The JAX package's own check of the
same property is ``tests/test_trainer.py`` (remat must not change
gradients)."""

import numpy as np
import pytest
import torch

import poseidon_tpu_torch as pt
from poseidon_tpu_torch.models.scot import SwinBlock

from test_trainer import SyntheticTimeDataset

torch.set_num_threads(1)

TOY = dict(image_size=32, patch_size=4, num_channels=2, num_out_channels=2, embed_dim=24,
           depths=(2, 2), num_heads=(2, 2), skip_connections=(1, 0), window_size=4,
           channel_slice_list=(0, 1, 2), use_conditioning=True)
RATES = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1, drop_path_rate=0.2)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(3, 2, 32, 32)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(3, 2, 32, 32)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(0.1, 1.0, size=3).astype(np.float32))
    return x, y, t


def _step(cfg, remat, generator_seed=7, count=False):
    """Loss, gradients, the generator's end state and the number of block
    forwards of one forward + backward in train mode."""
    model = pt.build_model(cfg, device="cpu", seed=0, remat=remat).train()
    calls = [0]
    if count:
        for m in model.modules():
            if isinstance(m, SwinBlock):
                m.register_forward_pre_hook(lambda *a: calls.__setitem__(0, calls[0] + 1))
    x, y, t = _inputs()
    gen = torch.Generator().manual_seed(generator_seed)
    loss = pt.scot_loss(model(x, t, generator=gen), y, cfg)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    return loss.detach(), grads, gen.get_state(), calls[0]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("mode", [True, "save_all", "save_dots"])
def test_remat_mode_matches_plain_step_bit_for_bit(mode, impl):
    # Under "pallas" the attention dropout is off, so that the blocks take
    # the kernel path in train mode (active attention dropout leaves it).
    rates = dict(RATES, attention_probs_dropout_prob=0.0) if impl == "pallas" else RATES
    cfg = pt.make_config("T", **TOY, **rates, attention_impl=impl)
    loss0, grads0, state0, calls0 = _step(cfg, False, count=True)
    loss, grads, state, calls = _step(cfg, mode, count=True)
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys() and len(grads) > 50
    for k in grads0:
        assert torch.equal(grads[k], grads0[k]), k
    assert torch.equal(state, state0)
    n_blocks = 2 * sum(TOY["depths"])
    assert calls0 == n_blocks
    assert calls == (n_blocks if mode == "save_all" else 2 * n_blocks)


def test_remat_without_masks_and_under_no_grad():
    # Eval mode draws nothing: the generator is left alone and the output is
    # the plain forward's; without grad no block is checkpointed.
    cfg = pt.make_config("T", **TOY, **RATES)
    x, _, t = _inputs(1)
    ref = pt.build_model(cfg, device="cpu", seed=0)
    model = pt.build_model(cfg, device="cpu", seed=0, remat=True)
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    assert torch.equal(model(x, t, generator=gen), ref(x, t))
    assert torch.equal(gen.get_state(), before)
    with torch.no_grad():
        assert torch.equal(model.train()(x, t, generator=gen),
                           ref.train()(x, t, generator=torch.Generator().manual_seed(3)))


def test_remat_modes_are_checked():
    cfg = pt.make_config("T", **TOY)
    with pytest.raises(ValueError, match="remat"):
        pt.ScOT(cfg, remat="everything")
    model = pt.ScOT(cfg)
    model.remat = "save_dots"
    assert model.encoder.remat == model.decoder.remat == "save_dots"
    with pytest.raises(ValueError, match="remat"):
        model.remat = 2


def test_trainer_step_with_gradient_checkpointing(tmp_path):
    cfg = pt.make_config("T", **dict(TOY, image_size=16, patch_size=2), **RATES)
    ds = SyntheticTimeDataset(n=8)
    weights = {}
    for flag in (False, True):
        args = pt.TrainingArguments(
            output_dir=str(tmp_path / str(flag)), train_batch_size=8, num_train_epochs=1,
            learning_rate=1e-3, compute_dtype="float32", gradient_checkpointing=flag,
            num_workers=1, report_to="none")
        model = pt.build_model(cfg, device="cpu", seed=0, remat=args.gradient_checkpointing)
        trainer = pt.Trainer(model, args, train_dataset=ds, device="cpu")
        trainer.train()
        assert trainer.step == 1
        weights[flag] = {k: v.clone() for k, v in model.state_dict().items()}
    for k, v in weights[False].items():
        assert torch.equal(weights[True][k], v), k
