"""A run loads no module of JAX or of the JAX package, and refuses to run
without the card it asks for."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness

ROOT = str(harness.ROOT)


def test_a_cpu_run_leaves_no_jax_module_loaded():
    code = (
        "import dataclasses, json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark import harness\n"
        "cell = harness.load_cell('iiwa14_k50.b1.pcg')\n"
        "cell = dataclasses.replace(cell, traffic=dict(cell.traffic, batch=2, pool_mb=0,"
        " warmup_s=0.05, sample_calls=2, profile_calls=2))\n"
        "r = harness.measure(cell, 7, 0.1, True, device='cpu')\n"
        "print(json.dumps([r['correct'], harness.forbidden_modules(),"
        " sorted(m for m in sys.modules if m.split('.')[0] == 'gato_tpu_torch')[:1]]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    correct, forbidden, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct is True and forbidden == [] and port == ["gato_tpu_torch"]


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("gato_tpu_torch_lookalike_for_test", sys)
    try:
        assert "gato_tpu_torch_lookalike_for_test" not in harness.forbidden_modules()
    finally:
        del sys.modules["gato_tpu_torch_lookalike_for_test"]


def test_without_the_card_run_exits_2_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "iiwa14_k50.b1.pcg",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr
