"""Without a card a run exits non-zero and prints no result: it never falls
back to the CPU."""
import os
import subprocess
import sys

from portbench import registry


def test_run_refuses_the_cpu():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "shader.train.bf16.b24p64", "--seed", str(2 ** 31 + 5), "--seconds", "1"],
                       cwd=registry.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "correct" not in p.stdout
    assert "CUDA" in p.stderr
