"""A run on several cards: one process a card (a rank), started and watched
by the process that was asked for the run (the launcher).

- The launcher picks a free local port and each rank's share of the host's
  cores, then starts ``python3 -m <module> <its own arguments> --rank r
  --port p --started s --cores c`` once a rank, each with its standard
  output and error in a temporary file.
- A rank pins itself to its cores before it loads torch (:func:`pin`),
  so that every thread it starts stays there, and joins the process group
  (:func:`start`): NCCL between the cards (gloo on the CPU), and a gloo
  group beside it for the host's agreements, the barriers around the
  window and the readings gathered to rank 0. Both time out.
- When a rank exits non-zero, or the ranks do not end within
  :data:`LINGER` seconds of rank 0, the launcher kills the others and
  returns non-zero with no standard output. When all exit 0 it returns
  what they wrote to standard error, rank 0's last, and rank 0's standard
  output, whose last line is the result.

Nothing here loads torch at import: a rank imports this module before it
pins itself.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

# Seconds a collective or a host agreement waits for the slowest rank. A
# first run builds the kernels under a file lock, outside any collective,
# so the ranks reach their first collectives together either way.
TIMEOUT_S = 300
# Seconds the other ranks may take to end once rank 0 has ended.
LINGER = 60
POLL_S = 0.1


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse_cpus(text: str) -> Set[int]:
    """``"0-3,8"`` -> {0, 1, 2, 3, 8}; anything else -> empty."""
    out: Set[int] = set()
    for part in text.strip().split(","):
        lo, _, hi = part.partition("-")
        if not lo.isdigit() or (hi and not hi.isdigit()):
            return set()
        out.update(range(int(lo), int(hi or lo) + 1))
    return out


def nearest_cpus(topo: str) -> Dict[int, Set[int]]:
    """Each card's "CPU Affinity" in the text of ``nvidia-smi topo -m``."""
    lines = [ln.split("\t") for ln in topo.splitlines()]
    header = next((ln for ln in lines if "CPU Affinity" in [f.strip() for f in ln]), None)
    if header is None:
        return {}
    col = [f.strip() for f in header].index("CPU Affinity")
    out = {}
    for ln in lines:
        name = ln[0].strip()
        if name.startswith("GPU") and name[3:].isdigit() and len(ln) > col:
            cpus = parse_cpus(ln[col])
            if cpus:
                out[int(name[3:])] = cpus
    return out


def share_cores(world: int, allowed: Set[int], near: Dict[int, Set[int]]) -> List[List[int]]:
    """Disjoint cores for each of ``world`` ranks (rank r on card r): the
    cores near a card that this process may use, split evenly among the
    ranks whose cards share them; where that leaves a rank none, the
    allowed cores split evenly among all ranks."""
    def split(pool: Sequence[int], parts: int, index: int) -> List[int]:
        n = len(pool)
        return list(pool[index * n // parts:(index + 1) * n // parts])

    mine = [set(near.get(r, ())) & allowed for r in range(world)]
    out = []
    for r in range(world):
        peers = [q for q in range(world) if mine[q] == mine[r]]
        cores = split(sorted(mine[r]), len(peers), peers.index(r)) if mine[r] else []
        out.append(cores)
    if any(not c for c in out) or len({c for cs in out for c in cs}) < sum(map(len, out)):
        out = [split(sorted(allowed), world, r) for r in range(world)]
    return out


def _topology() -> str:
    try:
        return subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                              timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ""


def rank_commands(module: str, argv: Sequence[str], world: int,
                  started: float) -> List[List[str]]:
    """The command of each rank: ``module`` with ``argv`` and the rank's
    own arguments (a free port, the launcher's start on the wall clock,
    its cores)."""
    port = free_port()
    cores = share_cores(world, os.sched_getaffinity(0), nearest_cpus(_topology()))
    return [[sys.executable, "-m", module, *argv, "--rank", str(r), "--port", str(port),
             "--started", repr(started), "--cores", ",".join(map(str, cores[r]))]
            for r in range(world)]


def launch(commands: Sequence[Sequence[str]]) -> Tuple[int, str, str]:
    """Start one process a command (rank r: ``commands[r]``), wait for
    them, and return (exit code, rank 0's standard output, every rank's
    standard error). The first rank to exit non-zero, or the ranks left
    :data:`LINGER` seconds after rank 0 ended, stop the rest: the code is
    then non-zero and the output empty. A SIGTERM to the launcher stops
    them too."""
    outs = [tempfile.TemporaryFile() for _ in commands]
    errs = [tempfile.TemporaryFile() for _ in commands]
    procs: List[subprocess.Popen] = []
    stop = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    failed, last = None, 0
    try:
        env = dict(os.environ, BENCHMARK_LAUNCHER_PID=str(os.getpid()))
        for cmd, out, err in zip(commands, outs, errs):
            procs.append(subprocess.Popen(list(cmd), stdout=out, stderr=err, env=env))
        zero_ended = None
        while failed is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                last = bad[0]
                failed = f"rank {last} exited with code {codes[last]}"
            elif all(c == 0 for c in codes):
                break
            elif codes[0] == 0:
                zero_ended = zero_ended or time.monotonic()
                if time.monotonic() - zero_ended > LINGER:
                    failed = f"ranks still running {LINGER} s after rank 0 ended"
            time.sleep(POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        signal.signal(signal.SIGTERM, stop)
    text = []
    for f in outs + errs:
        f.seek(0)
        text.append(f.read().decode(errors="replace"))
        f.close()
    out, err = text[:len(commands)], text[len(commands):]
    order = [r for r in range(len(commands)) if r != last] + [last]
    every = "".join(f"# rank {r}:\n{err[r]}" for r in order)
    if failed is not None:
        return 1, "", every + f"{failed}; the other ranks were stopped\n"
    return 0, out[0], every


def since(started: float) -> float:
    """The ``time.perf_counter()`` reading of the wall-clock time
    ``started`` (the launcher's start), in this process."""
    return time.perf_counter() - (time.time() - started)


def pin(cores: str) -> None:
    """Pin this process to ``cores`` (``"0,1,2"``) before it starts any
    thread, and have it killed when the launcher ends."""
    if cores:
        os.sched_setaffinity(0, parse_cpus(cores))
    launcher = os.environ.get("BENCHMARK_LAUNCHER_PID")
    if launcher and sys.platform.startswith("linux"):
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
        if os.getppid() != int(launcher):
            os._exit(1)


@dataclasses.dataclass
class Ranks:
    """This process's place in the process group, and the host's group."""

    rank: int
    world: int
    host: object

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.host)

    def gather(self, obj, dst: int = 0) -> Optional[list]:
        """Every rank's ``obj`` in rank order on rank ``dst``; None elsewhere."""
        import torch.distributed as dist

        out = [None] * self.world if self.rank == dst else None
        dist.gather_object(obj, out, dst=dst, group=self.host)
        return out

    def max(self, x: float) -> float:
        """The largest of the ranks' ``x``, on every rank."""
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, x, group=self.host)
        return max(out)


def start(rank: int, world: int, port: int, device) -> Ranks:
    """Join the process group on ``127.0.0.1:port``: NCCL on a card, gloo
    on the CPU, and a gloo group for the host; torch's threads on this
    process's cores."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(len(os.sched_getaffinity(0)))
    timeout = timedelta(seconds=TIMEOUT_S)
    cuda = torch.device(device).type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world, timeout=timeout)
    host = dist.new_group(backend="gloo", timeout=timeout) if cuda else dist.group.WORLD
    return Ranks(rank, world, host)


def run_rank(main: Callable[[], int]) -> None:
    """Run a rank's ``main`` and end the process with its code (1 where it
    raised, after the traceback), without the process group's teardown,
    which has nothing left to do and could wait on ranks that have gone."""
    try:
        code = main()
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    except BaseException:  # noqa: B036 - the rank ends here whatever was raised
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
