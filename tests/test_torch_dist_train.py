"""The port's sharded training and dist/ substrates at world sizes 2 and 4
over gloo (tests/torch_dist_train_checks.py, run once in a subprocess):
the ring collective matmuls, int8 compression with error feedback, the
GPipe schedule, the sharded serving steps (prefill and decode) against
the mesh-less ones and the reference's, the sharded train step against the single-process
step
and the reference's ``make_train_step`` on forced host meshes of the same
shape (an MoE step expert parallel: each rank's products on its E/m
experts), and an elastic restore from 4 ranks to 2.  The checks and their
tolerances are in that script's docstring; each test reads one of its
lines, the training launcher's under ``torchrun`` on two ranks too.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PARTS = ["matmuls", "sharded step", "compression", "pipeline",
         "sharded serving", "step against the reference"]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One run of tests/torch_dist_train_checks.py: worlds 2 and 4 side by
    side, the JAX package on forced host meshes in a child of its own, and
    the training launcher under torchrun."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "torch_dist_train_checks.py"),
         "--worlds", "2", "4", "--out", str(tmp_path_factory.mktemp("jax"))],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("part", PARTS)
def test_spawned_worlds(spawned, part, world):
    assert f"ok {part} world={world}" in spawned


def test_elastic_restore_from_four_ranks_to_two(spawned):
    assert "ok elastic restore world=2" in spawned


def test_launcher_trains_on_a_mesh_under_torchrun(spawned):
    """``launch/train.py`` under torchrun on two ranks, run by the script
    beside the worlds (its ``check_launcher``): it resumes the one-device
    launcher's checkpoint of step 1 onto a ("data",) mesh of two and
    trains step 1 there; rank 0 alone prints and writes the record."""
    assert "ok launcher under torchrun world=2" in spawned
