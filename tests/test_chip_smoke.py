"""chip_smoke.py on the CPU: its refusal without a GPU, its spot matcher,
its channelizer check at the smoke's geometry, a reduced App phase, and the
compile-cache directory rule it prints."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def _run(code_or_args, env_extra=None, drop=("JAX_COMPILATION_CACHE_DIR",)):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra or {})
    return subprocess.run([sys.executable] + code_or_args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    p = _run(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"})
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "not 'gpu'" in p.stdout


_CACHE_DIR = ("import jax; from cwsl_digi_tpu import jaxcache; "
              "print(jaxcache.enable(), jax.config.jax_compilation_cache_dir)")


def test_jaxcache_uses_env_dir_verbatim(tmp_path):
    d = str(tmp_path / "given")
    p = _run(["-c", _CACHE_DIR],
             {"JAX_PLATFORMS": "cpu", "JAX_COMPILATION_CACHE_DIR": d}, ())
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == [d, d]


def test_jaxcache_default_is_checkout_dir_in_every_process():
    outs = [_run(["-c", _CACHE_DIR], {"JAX_PLATFORMS": "cpu"})
            for _ in range(2)]
    for p in outs:
        assert p.returncode == 0, p.stderr
    want = str(REPO / ".jax_cache")
    assert [p.stdout.split() for p in outs] == [[want, want]] * 2


def _inj(line=3, mode="FT8", message="K1ABC W9XYZ EN37", freq=14_001_500.0):
    return {"line": line, "mode": mode, "message": message,
            "freq_hz": freq, "tol_hz": 6.25}


def _spot(line=3, mode="FT8", message="K1ABC W9XYZ EN37", freq=14_001_502.0):
    return {"line": line, "mode": mode, "message": message, "freq_hz": freq}


@pytest.mark.parametrize("spots,n_problems", [
    ([_spot()], 0),
    ([], 1),
    ([_spot(), _spot(line=7, message="CQ N0CALL FN13")], 1),
    ([_spot(line=4)], 2),                   # a miss and a false spot
    ([_spot(freq=14_001_510.0)], 2),        # more than one tone off
    ([_spot(), _spot()], 1),
    ([_spot(mode="FT4")], 2),
], ids=["hit", "miss", "false_spot", "wrong_line", "wrong_freq", "twice",
        "wrong_mode"])
def test_match_spots(spots, n_problems):
    assert len(cs.match_spots([_inj()], spots)) == n_problems


def test_channelizer_matches_ssbd_at_smoke_geometry():
    """BatchChannelizer vs the float64 SSBD oracle at the smoke's 192 kHz,
    on 3 of 16 channels over 0.5 s, float32 at default precision: max
    |error| within CHAN_TOL (2e-3) of full scale 1."""
    err, err_highest = cs.channelizer_error(cs.FS, 16, 0.5, 3,
                                            np.random.default_rng(1))
    assert err <= cs.CHAN_TOL and err_highest <= cs.CHAN_TOL


def test_upconverted_burst_lands_at_its_rf_frequency():
    """upconvert places audio frequency f at RF offset f_shift + f with the
    analytic amplitude of the audio tone."""
    fs, f_shift, f0 = 48_000, 7_000.0, 1_250.0
    t = np.arange(12_000) / 12_000
    z = cs.upconvert(np.cos(2 * np.pi * f0 * t), f_shift, fs)
    spec = np.abs(np.fft.fft(z))
    peak = np.fft.fftfreq(len(z), 1 / fs)[np.argmax(spec)]
    assert peak == pytest.approx(f_shift + f0, abs=1.0)
    assert np.median(np.abs(z)) == pytest.approx(1.0, rel=0.01)


def test_modes_phase_reduced(monkeypatch, capsys):
    """The per-mode phase at a CPU size: FT4 at batch 2 decodes its burst
    in window 0 and nothing in window 1, and reports compiled memory."""
    from cwsl_digi_tpu.constants import Mode
    from cwsl_digi_tpu.modes.base import get_decoder

    monkeypatch.setattr(get_decoder(Mode.FT4), "max_device_batch", 2)
    cs.phase_modes(np.random.default_rng(4), [Mode.FT4])
    out = capsys.readouterr().out
    assert "FT4: batch  2 x 90000" in out and "| ok (1 in window 0" in out
    assert "temp" in out


def test_app_phase_reduced(monkeypatch, capsys):
    """The App phase end to end at a CPU size: two FT8 lines over 16 s,
    one with a burst; it must be spotted on its line, the other silent."""
    monkeypatch.setattr(cs, "APP_MIX", (("FT8", 2),))
    monkeypatch.setattr(cs, "APP_SECONDS", 16)
    cs.phase_app(np.random.default_rng(3))
    out = capsys.readouterr().out
    assert "App spots: 1 found, 1 injected, 0 problems" in out
