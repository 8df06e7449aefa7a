"""CPU rehearsal of chip_smoke.py's phases at tiny sizes (the card runs
them at the headline), and its refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from supersdr_jax.runtime import wideband

SMALL = dict(fs_in=64 * 12_000, n_chan=64, taps_per=8, n_taps=129,
             audio_rate=48_000, mode="AM")


def test_compile_phase_prints_memory(capsys):
    chip_smoke.compile_phase({**SMALL, "chunk_in": 64 * 256},
                             wideband.PROFILES, n_scan=2)
    out = capsys.readouterr().out
    assert out.count("compile ") == 2
    assert "temp " in out and "fast" in out and "quality" in out


def test_tail_phase_interpreted(capsys):
    chip_smoke.tail_phase(C=40, n=256, interpret=True)
    out = capsys.readouterr().out
    assert out.count("kernel vs XLA") == 4


def test_headline_phase_small(capsys):
    """The headline rule at a small width: the prefix of a long chunk
    matches the level of a 512-frame run from a fresh state."""
    tuning = wideband.PROFILES["fast"]
    mid = wideband.WidebandConfig(**SMALL, chunk_in=64 * 512, **tuning)
    rng = np.random.default_rng(2)
    iq = ((rng.normal(size=(1, mid.chunk_in))
           + 1j * rng.normal(size=(1, mid.chunk_in))) * 0.05
          ).astype(np.complex64)
    _, audio = wideband.process_many(mid, wideband.make_params(mid),
                                     wideband.init_state(mid), iq)
    mid_level = float(np.abs(np.asarray(audio, np.float32)).mean())
    chip_smoke.headline_phase({**SMALL, "chunk_in": 64 * 2048}, tuning,
                              mid_level, "cpu rehearsal", n_calls=1)
    assert "headline step (informative)" in capsys.readouterr().out


def test_headline_phase_rejects_bad_level():
    with pytest.raises(chip_smoke.SmokeError, match="prefix level"):
        chip_smoke.headline_phase({**SMALL, "chunk_in": 64 * 1024},
                                  wideband.PROFILES["fast"], 1e3, "cpu",
                                  n_calls=1)


def test_cli_phase(tmp_path, capsys):
    chip_smoke.cli_phase(str(tmp_path))
    out = capsys.readouterr().out
    for cmd in ("wideband", "demod", "waterfall", "kiwi"):
        assert f"cli {cmd}:" in out


def test_mesh_phase_on_four_virtual_devices(capsys):
    assert len(jax.devices()) >= 4
    chip_smoke.mesh_phase({**SMALL, "chunk_in": 64 * 256},
                          wideband.PROFILES["fast"], n_dev=4)
    out = capsys.readouterr().out
    assert out.count("mesh chunk") == 2


def test_device_info_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeError, match="not a GPU"):
        chip_smoke.device_info()


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_script_fails_without_a_gpu(tmp_path, alone):
    """Here (no card, no NVIDIA driver) the script exits non-zero and
    prints no result, in the checkout and on its own."""
    src = os.path.join(chip_smoke.REPO, "chip_smoke.py")
    if alone:
        shutil.copy(src, tmp_path / "chip_smoke.py")
        cwd, script = str(tmp_path), str(tmp_path / "chip_smoke.py")
    else:
        cwd, script = chip_smoke.REPO, src
    env = dict(os.environ, PATH=os.path.dirname(sys.executable))
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
