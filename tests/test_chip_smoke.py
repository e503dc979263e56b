"""``chip_smoke.py`` on the CPU: its phases at tiny sizes (the kernel in
interpret mode), its gate arithmetic, and its refusal to run without a
GPU or without the repository beside it."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from dcrmontecarlo_tpu.ops.pallas_walk import interpret_mode  # noqa: E402


def _run_script(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run_script(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_exits_nonzero_without_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_script(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_device_phase_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.device_phase()


def test_survey_gate_arithmetic():
    from dcrmontecarlo_tpu.validation import notebook_oracle_pins

    pins = notebook_oracle_pins()
    v = np.asarray(pins["fdm_401"], np.float64)
    se = np.ones_like(v)
    dv = v[:-1] - v[1:]
    g = chip_smoke.survey_gate(v, se, dv, np.sqrt(2.0) * se[1:], pins)
    assert g["ok"] and g["potentials_ok"] == len(v)
    # two potentials far off still pass (>= 19 of 21), three do not
    far = v.copy()
    far[:2] += 100.0
    assert chip_smoke.survey_gate(far, se, dv, se[1:], pins)["ok"]
    far[2] += 100.0
    assert not chip_smoke.survey_gate(far, se, dv, se[1:], pins)["ok"]
    # one dipole voltage beyond 4 sigma + 0.25 fails
    bad = dv.copy()
    bad[5] += 4.0 * np.sqrt(2.0) + 0.3
    assert not chip_smoke.survey_gate(v, se, bad, np.sqrt(2.0) * se[1:],
                                      pins)["ok"]
    # a common-mode shift below -25 fails
    assert not chip_smoke.survey_gate(v - 30.0, 10.0 * se, dv,
                                      np.sqrt(2.0) * se[1:], pins)["ok"]


def test_survey_phase_tiny():
    gates = chip_smoke.survey_phase(
        n_walks=16, max_steps=300, seeds=(0,), pseudo_walks=8,
        options=chip_smoke.gate_options(target_slots=512), enforce=False)
    assert len(gates) == 1
    assert np.isfinite(gates[0]["common_mode"])


def test_throughput_phase_tiny():
    rate = chip_smoke.throughput_phase(
        dict(target_slots=512, n_walks=16, max_steps=60, min_quota=4),
        repeats=1)
    assert rate > 0


def test_kernel_phase_tiny():
    tiny = dict(target_slots=256, pallas_block_rows=1)
    shapes = {
        "full": dict(tiny, n_walks=8, max_steps=40, min_quota=4),
        "short": dict(tiny, n_walks=32, max_steps=60),
        "accuracy": dict(tiny, n_walks=8, max_steps=100),
    }
    with interpret_mode():
        out = chip_smoke.kernel_phase(shapes=shapes, reps=1)
    assert set(out) == set(shapes)
    assert all(t["xla"] > 0 and t["pallas"] > 0 for t in out.values())


def test_sharded_phase_tiny():
    with interpret_mode():
        chip_smoke.sharded_phase(
            4, n_walks=16, max_steps=300,
            survey_options=dict(target_slots=256, pallas_block_rows=1),
            full_kw=dict(target_slots=256, n_walks=8, max_steps=40,
                         min_quota=4, pallas_block_rows=1))
