"""The port's kernel build and launch (``poseidon_tpu_torch.ops._build``) on
the CPU, with a stub compiler and a stub library:

- two processes that build into one directory at once (as the ranks of a
  process group do at their first step) run the compiler once per source:
  one builds under the lock, the other waits and finds the libraries;
- ``launch`` calls an entry point with the operands' card current, and
  every entry point of the wrappers goes through it, so that a process
  holding tensors on another card than its current one launches there.
"""

import ast
import contextlib
import os
import stat
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from poseidon_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]


def test_concurrent_builds_compile_each_source_once(tmp_path):
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    calls = tmp_path / "calls"
    nvcc = cuda / "bin" / "nvcc"
    # The stub compiler: takes a second, records its call, writes its -o file.
    nvcc.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        sleep 1
        echo "$$" >> {calls}
        while [ $# -gt 0 ]; do
          if [ "$1" = "-o" ]; then echo built > "$2"; fi
          shift
        done
        """))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    code = ("import sys\nfrom pathlib import Path\n"
            "import poseidon_tpu_torch.ops._build as b\n"
            "b.BUILD_DIR = Path(sys.argv[1])\n"
            "print(b.build(['mlp', 'mlp_bwd']))\n")
    env = dict(os.environ, CUDA_HOME=str(cuda), PYTHONPATH=str(REPO))
    out = tmp_path / "kernels"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    results = []
    for p in procs:
        stdout, _ = p.communicate(timeout=60)
        assert p.returncode == 0, stdout
        results.append(eval(stdout.strip().splitlines()[-1]))
    assert len(calls.read_text().split()) == 2          # one nvcc a source, not one a process
    assert sorted(sum(s == 0.0 for s in r.values()) for r in results) == [0, 2]
    for name in ("mlp", "mlp_bwd"):
        lib = out / _build.library_path(name).name
        assert lib.read_text() == "built\n"
    assert not list(out.glob("*.tmp"))


class _Lib:
    def __init__(self, err=0):
        self.calls, self.err = [], err

    def entry(self, *args):
        self.calls.append((_current[-1] if _current else None, args))
        return self.err

    def cuda_error_string(self, err):
        return b"stub error"


_current = []


@contextlib.contextmanager
def _device(dev):
    _current.append(torch.device(dev))
    try:
        yield
    finally:
        _current.pop()


def test_launch_makes_the_operands_card_current(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", _device)
    lib = _Lib()
    _build.launch(lib, "entry", torch.device("cuda", 3), 1, 2)
    assert lib.calls == [(torch.device("cuda", 3), (1, 2))]
    assert _current == []
    with pytest.raises(RuntimeError, match="entry kernel launch failed: CUDA error 7: stub error"):
        _build.launch(_Lib(err=7), "entry", torch.device("cuda", 1))


def test_every_entry_point_launches_through_launch():
    """No wrapper calls a library's entry point itself (only the general
    MLP's host-side scratch query, which launches nothing)."""
    for name in ("window_attention.py", "mlp.py"):
        tree = ast.parse((REPO / "poseidon_tpu_torch" / "ops" / name).read_text())
        direct = [node.func.attr for node in ast.walk(tree)
                  if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                  and isinstance(node.func.value, ast.Name) and node.func.value.id == "lib"]
        assert set(direct) <= {"mlp_general_scratch"}, (name, direct)
        launched = [node.args[1].value for node in ast.walk(tree)
                    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "launch"]
        assert len(launched) >= 6, (name, launched)
