"""The port's mesh and sharding rules (``poseidon_tpu_torch.parallel.mesh``)
against the JAX package's (``poseidon_tpu.parallel.mesh``): the FSDP rule
``param_partition_spec`` on a sweep of shapes and model-axis sizes;
``make_mesh``'s errors in one process and its shapes in a two-process gloo
group on the CPU (``tests/_torch_dist.py``), beside the JAX meshes of two
CPU devices; ``shard_batch``'s rows against the rows each JAX device holds
under ``P("data")``; ``gather_rows`` in rank order."""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from poseidon_tpu.parallel import mesh as jmesh

from poseidon_tpu_torch.parallel import mesh

import _torch_dist as td

SHAPES = [(), (7,), (96,), (65536,), (65537,), (256, 256), (255, 257), (384, 96), (96, 384),
          (1536, 384), (128, 128, 4), (3, 4, 4, 96), (4, 4, 96, 3), (169, 6), (2, 32768),
          (32768, 2), (6, 64, 64, 6), (1, 1, 65536), (3, 65537)]


@pytest.mark.parametrize("num_model", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("min_size", [2**16, 2**8])
def test_param_partition_spec_matches_jax(num_model, min_size):
    fake = types.SimpleNamespace(shape={"model": num_model})
    for shape in SHAPES:
        want = tuple(jmesh.param_partition_spec(shape, fake, min_size))
        assert mesh.param_partition_spec(shape, num_model, min_size) == want, shape


@pytest.mark.parametrize("num_data,num_model", [(2, 1), (None, 2), (1, 2), (3, 1)])
def test_make_mesh_errors_match_jax_in_one_process(num_data, num_model):
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(num_data, num_model, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(num_data, num_model, device_type="cpu")
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return td.run_ranks("_torch_dist:mesh_trial", 2, tmp_path_factory.mktemp("mesh"))


def test_make_mesh_shapes_match_jax(two_ranks):
    devices = jax.devices()[:2]
    for key, args in (("default", (None, 1)), ("model2", (None, 2)), ("data2", (2, 1)),
                      ("data1", (1, 2))):
        want = dict(jmesh.make_mesh(*args, devices=devices).shape)
        for rank, r in enumerate(two_ranks):
            assert r[key]["shape"] == want, (key, rank)
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(3, 1, devices=devices)
    assert [r["error"] for r in two_ranks] == [str(want.value)] * 2
    # Rank r: data index r // model, model index r % model.
    assert [(r["model2"]["data"], r["model2"]["model"]) for r in two_ranks] == [(0, 0), (0, 1)]
    assert [(r["data2"]["data"], r["data2"]["model"]) for r in two_ranks] == [(0, 0), (1, 0)]


def test_shard_batch_rows_match_jax(two_ranks):
    batch = {"x": np.arange(8 * 3, dtype=np.float32).reshape(8, 3), "t": np.arange(8.0)}
    devices = jax.devices()[:2]
    for key, args in (("data2", (2, 1)), ("data1", (1, 2))):
        jm = jmesh.make_mesh(*args, devices=devices)
        for name, v in batch.items():
            arr = jax.device_put(v, NamedSharding(jm, P("data")))
            held = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
            for rank, r in enumerate(two_ranks):
                np.testing.assert_array_equal(r[key]["rows"][name], held[devices[rank]])


def test_gather_rows_in_rank_order(two_ranks):
    want = torch.cat([torch.full((3, 2), float(r)) for r in range(2)])
    for r in two_ranks:
        assert torch.equal(r["gathered"], want)
