"""Without a card the benchmark fails and prints no result; it never falls
back to the CPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import CHECKOUT


def test_no_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "dk_stis.train_b12", "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=CHECKOUT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
    assert "CUDA device" in proc.stderr
    assert not list(tmp_path.iterdir())
