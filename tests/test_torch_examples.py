"""The port's runnable examples (``examples/torch_*.py``), each in a
subprocess, ``--device cpu`` where it takes a device.

* ``torch_quickstart.py`` and ``torch_interacting_queues.py`` print the
  same lines as the JAX examples.
* ``torch_ingraph_controller.py``'s violations and budgets equal
  ``examples/ingraph_controller.py``'s.
* ``torch_serve_lm.py`` and ``torch_train_lm.py`` run their own asserts
  (every request finished, no HBM violation; a loss each step).
* The examples that take a device default to CUDA and fail without a
  card: there is no fallback.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EX = ROOT / "examples"
DEVICE_EXAMPLES = ["torch_ingraph_controller.py", "torch_serve_lm.py",
                   "torch_train_lm.py"]


def run(name: str, *args: str, ok: bool = True, **extra_env):
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="4", **extra_env)
    proc = subprocess.run([sys.executable, str(EX / name), *args],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=600)
    if ok:
        assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout if ok else proc


@pytest.mark.parametrize("name", ["quickstart.py", "interacting_queues.py"])
def test_host_examples_print_the_reference_lines(name):
    assert run(f"torch_{name}") == run(name)


def numbers(line: str) -> list[str]:
    return re.findall(r"-?\d+(?:\.\d+)?", line)


def test_ingraph_controller_equals_reference():
    got = run("torch_ingraph_controller.py", "--device", "cpu")
    want = run("ingraph_controller.py")
    g, w = got.strip().splitlines()[-1], want.strip().splitlines()[-1]
    # violations and the three budgets (and the settled pressure, goals)
    assert numbers(g.split("steps:")[1]) == numbers(w.split("steps:")[1])
    assert "violations=" in g


def test_serve_example_on_cpu():
    out = run("torch_serve_lm.py", "--device", "cpu")
    assert "finished 16/16" in out
    assert "HBM violations: 0;" in out
    assert "prefill[packed]" in out


def test_train_example_on_cpu(tmp_path):
    out = run("torch_train_lm.py", "--device", "cpu", "--steps", "4",
              "--batch", "4", "--seq", "32", "--workdir", str(tmp_path))
    steps = re.findall(r"^step +(\d+) +loss ([\d.]+)", out, re.M)
    assert [int(s) for s, _ in steps] == [1, 2, 3, 4]
    assert "final loss" in out
    assert any(tmp_path.iterdir())          # its checkpoints


@pytest.mark.parametrize("name", DEVICE_EXAMPLES)
def test_device_examples_default_to_cuda(name, tmp_path):
    """With no card visible the default device fails; nothing falls back
    to the CPU."""
    args = ("--workdir", str(tmp_path)) if name == "torch_train_lm.py" \
        else ()
    proc = run(name, *args, ok=False, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr or "cuda" in proc.stderr
