"""The port's Trainer in its AR training branch against the JAX Trainer's,
on the CPU (tests/test_torch_trainer.py's toy model, dataset and weights,
with the resnet skip blocks): one train step under ``set_ar_steps(2)``."""

import jax
import numpy as np

from poseidon_tpu import ScOT as JScOT
from poseidon_tpu.training import Trainer as JTrainer
from poseidon_tpu.training import TrainingArguments as JArgs

import poseidon_tpu_torch as pt

from test_torch_trainer import RTOL_STEP, _args, _jax_pair, _port_trainer
from test_trainer import SyntheticTimeDataset


def test_ar_train_step_with_batchnorm_matches_jax(tmp_path):
    """The AR training branch (``set_ar_steps(2)``: the mean of the per-step
    losses against the final labels, BatchNorm running statistics of the
    resnet skip blocks updated step after step) on one batch: the loss and
    gradient norm at rtol 2e-4, and every running statistic after the step
    at atol 2e-5 (tests/test_torch_train_step.py's gates). The parameters
    are not compared after one AdamW step: the conv biases before each
    BatchNorm have zero gradient in train mode, and Adam's first step turns
    their round-off into +-lr."""
    jcfg, jvars, pcfg, sd = _jax_pair(seed=4, residual_model="resnet")
    pcfg_sd = pt.from_jax_params(jvars["params"], pcfg, jvars["batch_stats"])
    ds = SyntheticTimeDataset()
    kw = dict(learning_rate=1e-4, num_train_epochs=1)
    jt = JTrainer(JScOT(config=jcfg), _args(JArgs, tmp_path / "jax", **kw), train_dataset=ds,
                  variables=jvars)
    ptr = _port_trainer(tmp_path / "port", pcfg, pcfg_sd, ds, **kw)
    for t in (jt, ptr):
        t.set_ar_steps(2)
    batch = next(iter(pt.data.loader.DataLoader(ds, 8, num_workers=2).epoch(0)))
    state, metrics = jax.jit(jt._train_step)(jt.state, jt._device_batch(batch),
                                              jax.random.PRNGKey(0))
    out = ptr._train_step(ptr._device_batch(batch)[0], 0)
    np.testing.assert_allclose([float(out["loss"]), float(out["grad_norm"])],
                               [float(metrics["loss"]), float(metrics["grad_norm"])],
                               rtol=RTOL_STEP)
    ref = pt.from_jax_params(jax.tree.map(np.asarray, state.params), pcfg,
                             jax.tree.map(np.asarray, state.batch_stats))
    ours = ptr.model.state_dict()
    stats = [k for k in ref if "running_" in k]
    assert set(ref) == set(ours) and stats
    for name in stats:
        before = pcfg_sd[name].numpy()
        assert not np.array_equal(ours[name].numpy(), before), name  # updated by the steps
        np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(), atol=2e-5, rtol=0,
                                   err_msg=name)
    assert ptr.step == 1 and float(ptr.loss_sum) == float(out["loss"])
