"""chip_smoke.py and bench.py: the contract of the entry scripts, and
every phase function at a tiny size on the CPU rig (the phases run at
full size on a GPU through ``python chip_smoke.py``)."""

import json
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def test_refuses_cpu_and_exits_nonzero():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "no GPU" in p.stderr
    assert '"ok"' not in p.stdout


def test_bench_main_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        bench.main()


def test_last_line_shape():
    line = chip_smoke.last_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["ok"] is True


@pytest.mark.parametrize("line,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W",
     ("NVIDIA H100 80GB HBM3", "700.00 W")),
    ("  NVIDIA H100, PCIe, 350.00 W\n", ("NVIDIA H100, PCIe", "350.00 W")),
])
def test_parse_nvidia_smi(line, want):
    assert chip_smoke.parse_smi(line) == want


@pytest.mark.parametrize("line", ["", "NVIDIA H100 80GB HBM3", ", 700 W"])
def test_parse_nvidia_smi_rejects_malformed(line):
    with pytest.raises(ValueError):
        chip_smoke.parse_smi(line)


def _stub_phases(monkeypatch, calls, fail=None):
    import jutul.jl_tpu.utils.compile_cache as cc

    monkeypatch.setattr(cc, "enable_compile_cache", lambda: "cache")

    def stub(name):
        def f(*a, **k):
            calls.append(name)
            if name == fail:
                raise RuntimeError(f"{name} failed")
        return f

    for name in ("phase_device", "phase_gpu_tests", "phase_flagship",
                 "phase_operators",
                 "phase_end_to_end", "phase_adjoint", "phase_four_cards"):
        monkeypatch.setattr(chip_smoke, name, stub(name))


def test_failing_phase_propagates_without_ok_line(monkeypatch, capsys):
    calls = []
    _stub_phases(monkeypatch, calls, fail="phase_end_to_end")
    with pytest.raises(RuntimeError, match="phase_end_to_end failed"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out
    assert calls == ["phase_device", "phase_gpu_tests", "phase_flagship",
                     "phase_operators", "phase_end_to_end"]


def test_four_cards_runs_no_other_phase(monkeypatch, capsys):
    calls = []
    _stub_phases(monkeypatch, calls)
    chip_smoke.main(["--four-cards"])
    assert calls == ["phase_device", "phase_four_cards"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["count"] == 4


def test_one_card_runs_every_phase_in_order(monkeypatch, capsys):
    calls = []
    _stub_phases(monkeypatch, calls)
    chip_smoke.main([])
    assert calls == ["phase_device", "phase_gpu_tests", "phase_flagship",
                     "phase_operators", "phase_end_to_end", "phase_adjoint"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"ok": True, "device": bench.device_record()}


def test_gpu_test_files_are_the_marked_ones():
    files = chip_smoke.gpu_test_files()
    assert files and all(os.path.basename(f).startswith("test_")
                         for f in files)
    assert os.path.join(ROOT, "tests", "test_context.py") in files
    assert os.path.join(ROOT, "tests", "test_chip_smoke.py") not in files


def test_flagship_phase_tiny():
    rec = chip_smoke.phase_flagship((16, 16, 8))
    assert rec["cells"] == 2048 and rec["newton_iterations"] > 0
    assert rec["linear_iterations"] > 0 and rec["run_seconds"] > 0
    assert jax.config.jax_enable_x64  # the f32 phase restored x64


def test_operators_phase_tiny():
    chip_smoke.phase_operators((8, 8, 4))


def test_end_to_end_phase_tiny():
    chip_smoke.phase_end_to_end((8, 8, 4), n_step=2)


def test_adjoint_phase_tiny():
    rec = chip_smoke.phase_adjoint((16, 16, 4), (8, 8, 4))
    assert rec["adjoint_seconds"] > 0 and rec["grad_trans_max_abs"] > 0


def test_four_cards_phase_on_virtual_devices():
    assert len(jax.devices()) >= 4  # conftest's 8 virtual CPU devices
    chip_smoke.phase_four_cards((6, 5, 4), n_dev=4)


def test_gpu_tests_phase_fails_where_they_skip():
    # here the gpu-marked tests skip, and a skip is not a pass
    with pytest.raises(RuntimeError, match="did not all pass"):
        chip_smoke.phase_gpu_tests()
