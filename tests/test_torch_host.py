"""The port's process helpers (``poseidon_tpu_torch.parallel.host``): with
``torch.distributed`` not initialised they answer as the JAX package's do in
one process; in a two-process gloo group on the CPU (localhost) they give
each process its rank, the group's size, a barrier, and process 0's object
on every process."""

import multiprocessing as mp
import socket

from poseidon_tpu.parallel import host as jhost

from poseidon_tpu_torch.parallel import host


def test_one_process_matches_jax():
    for name in ("process_index", "process_count", "is_primary"):
        assert getattr(host, name)() == getattr(jhost, name)()
    host.sync_hosts("x")
    obj = {"a": [1, 2], "b": "dir"}
    assert host.broadcast_object(obj) is obj and jhost.broadcast_object(obj) is obj


def _worker(rank, port, queue):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        host.sync_hosts("start")
        got = host.broadcast_object({"rank": rank, "path": f"/ckpt/{rank}"})
        queue.put((rank, host.process_index(), host.process_count(), host.is_primary(), got))
        host.sync_hosts("end")
    finally:
        dist.destroy_process_group()


def test_two_process_gloo_group():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, port, queue)) for r in range(2)]
    for p in procs:
        p.start()
    results = sorted(queue.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert results == [(0, 0, 2, True, {"rank": 0, "path": "/ckpt/0"}),
                       (1, 1, 2, False, {"rank": 0, "path": "/ckpt/0"})]


def test_initialize_distributed_without_launcher(monkeypatch):
    """Without torchrun's environment nothing is started; a CUDA request
    (the default) without a card raises, and is never run on the CPU. The
    launched case is tests/test_torch_cli_torchrun.py's."""
    import pytest
    import torch
    import torch.distributed as dist

    for k in host.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert host.initialize_distributed("cpu") == torch.device("cpu")
    assert not dist.is_initialized() and host.process_count() == 1
    if not torch.cuda.is_available():
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                host.initialize_distributed(dev)
