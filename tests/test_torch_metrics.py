"""The port's metrics (``poseidon_tpu_torch.metrics``) against the JAX
package's (``poseidon_tpu.metrics``): the same numpy inputs through both,
equal to 1e-6 relative (both are numpy; the port's is a copy, so they are
in fact equal)."""

import numpy as np
import pytest

from poseidon_tpu import metrics as jm

from poseidon_tpu_torch import metrics as pm

RTOL = 1e-6


def _data(seed, n=12, c=4, res=8):
    rng = np.random.default_rng(seed)
    preds = rng.normal(size=(n, c, res, res)).astype(np.float32)
    targets = rng.normal(size=(n, c, res, res)).astype(np.float32)
    targets[0] = 0.0  # the 1e-10 zero guard
    return preds, targets


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("fn", ["lp_error", "relative_lp_error", "mean_relative_lp_error",
                                "median_relative_lp_error"])
def test_error_functions_match(fn, p):
    preds, targets = _data(0)
    kw = {} if fn == "lp_error" else {"return_percent": p == 1}
    np.testing.assert_allclose(getattr(pm, fn)(preds, targets, p, **kw),
                               getattr(jm, fn)(preds, targets, p, **kw), rtol=RTOL)


def test_error_statistics_match():
    errs = np.random.default_rng(1).uniform(size=50)
    assert pm.error_statistics(errs, "x") == pytest.approx(jm.error_statistics(errs, "x"),
                                                           rel=RTOL)


@pytest.mark.parametrize("absolute,full_data", [(False, False), (True, True)])
@pytest.mark.parametrize("slices,names", [((0, 1, 3, 4), ("rho", "uv", "p")), ((0, 4), ("all",))])
def test_channel_group_metrics_match(slices, names, absolute, full_data):
    preds, targets = _data(2)
    ours = pm.ChannelGroupMetrics(slices, names, absolute=absolute, full_data=full_data)
    theirs = jm.ChannelGroupMetrics(slices, names, absolute=absolute, full_data=full_data)
    assert ours.groups == theirs.groups
    got, want = ours(preds, targets), theirs(preds, targets)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    # Streaming: per-sample vectors of two chunks give the one-shot battery.
    chunks = [ours.per_sample(preds[:5], targets[:5]), ours.per_sample(preds[5:], targets[5:])]
    streamed = ours.from_samples({k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]})
    for k in want:
        np.testing.assert_allclose(streamed[k], want[k], rtol=RTOL, err_msg=k)


def test_compute_channel_group_metrics_match():
    preds, targets = _data(3)
    got = pm.compute_channel_group_metrics(preds, targets, (0, 1, 3, 4), ("rho", "uv", "p"))
    want = jm.compute_channel_group_metrics(preds, targets, (0, 1, 3, 4), ("rho", "uv", "p"))
    assert got == pytest.approx(want, rel=RTOL)
