"""chip_smoke.py's phases at tiny sizes on the CPU (the Pallas
interpreter stands in for the compiled kernels), and its refusal to run
without a GPU."""

import os
import subprocess
import sys

import pytest

import chip_smoke as C

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        C.main([])
    assert e.value.code == 2
    out, err = capsys.readouterr()
    assert out == "" and "needs a GPU" in err


def test_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_kernel_phase_tiny():
    assert C.phase_kernels(widths=((1, 3),), impl="host")


@pytest.mark.parametrize("impl", ["xla", "host"])
def test_msm_phase_tiny(impl):
    assert C.phase_msm(log2n=3, impl=impl, degs=(1,), n_distinct=4)


def test_credential_phase_tiny():
    assert C.phase_credential(num_payloads=0, rounds=1)


def test_random_planes_are_canonical():
    import numpy as np

    from zklaim_tpu.ff.limbs import limbs_to_ints
    from zklaim_tpu.ff.params import Q

    planes = np.asarray(C.random_planes(np.random.default_rng(0), 2, 64))
    assert planes.shape == (96, 64)
    for value in planes.reshape(6, 16, 64).transpose(0, 2, 1).reshape(-1, 16):
        assert limbs_to_ints(value[None])[0] < Q
