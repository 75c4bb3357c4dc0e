"""False-decode guards: payloads no decoder reports, the GFSK engine's
weak-candidate gates, one JT65 decode per signal, the noise-audit tool, and
bench.py's refusal to run without a GPU."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cwsl_digi_tpu.modes import js8, message77
from cwsl_digi_tpu.modes.gfsk import add_noise_at_snr

REPO = Path(__file__).resolve().parent.parent


def _payload(i3: int, n3: int = 0) -> np.ndarray:
    bits = message77.pack77("K1ABC W9XYZ EN37").copy()
    bits[71:74] = message77.bits_from_int(n3, 3)
    bits[74:77] = message77.bits_from_int(i3, 3)
    return bits


@pytest.mark.parametrize("i3,n3", [(6, 0), (7, 0), (0, 2), (0, 6), (0, 7)])
def test_unsupported_payload_types_are_not_reported(i3, n3):
    assert message77.unpack77(_payload(i3, n3)).text.startswith(
        "<unsupported")
    assert message77.unpack77_text(_payload(i3, n3)) is None


def test_standard_payload_text_is_reported():
    bits = message77.pack77("K1ABC W9XYZ EN37")
    assert message77.unpack77_text(bits) == "K1ABC W9XYZ EN37"


def test_js8_malformed_frame_is_not_reported():
    bits = js8.pack_payload("K1ABC: W9XYZ 73").copy()
    bits[59:67] = 1                   # directed command index 255: none
    assert js8.unpack_payload(bits) is None
    dec = js8.JS8Decoder(top_k=16)
    assert dec.unpack(np.concatenate([bits, np.zeros(12, np.uint8)])) is None


@pytest.fixture(scope="module")
def js8_window():
    rng = np.random.default_rng(21)
    clean = js8.synthesize("K1ABC: W9XYZ 73", 1200.0)
    return add_noise_at_snr(clean, -10.0, 12_000, rng)[None]


@pytest.mark.parametrize("gates,decodes", [
    (dict(), True),                                  # JS8's own gates
    (dict(sync_min=-1, weak_sync=-1, snr_floor_db=-99.0), True),
    (dict(sync_min=21), False),                      # every sync count fails
    (dict(weak_sync=21, snr_floor_db=50.0), False),  # weak and below floor
    (dict(weak_sync=21, snr_floor_db=-99.0), True),  # weak, above floor
])
def test_weak_candidate_gates(js8_window, gates, decodes):
    dec = js8.JS8Decoder(top_k=16)
    dec.spec = dataclasses.replace(dec.spec, **gates)
    msgs = [r.message for r in dec.decode(js8_window)[0]]
    assert ("K1ABC: W9XYZ 73" in msgs) == decodes, msgs


def test_jt65_strong_signal_decodes_once():
    """A strong JT65 signal read half a tone off can yield a second,
    wrong codeword that passes RS and the soft accept: one decode per
    signal is kept (3 of these 15 windows misdecoded without the rule)."""
    sys.path.insert(0, str(REPO))
    from cwsl_digi_tpu.modes import jt65
    from cwsl_digi_tpu.modes.base import get_decoder
    from tools.parity import random_call, random_grid

    rng = np.random.default_rng(2)
    wins, wants = [], []
    for _ in range(15):
        text = f"{random_call(rng)} {random_call(rng)} {random_grid(rng)}"
        f0 = float(rng.uniform(700, 1800))
        snr = float(rng.uniform(-14, -8))
        wins.append(add_noise_at_snr(jt65.synthesize(text, f0), snr,
                                     12_000, rng))
        wants.append(text)
    res = get_decoder("JT65", fmax_hz=3000.0).decode(np.stack(wins))
    assert [[r.message for r in rs] for rs in res] == [[w] for w in wants]


def test_noise_audit_windows_are_reproducible():
    sys.path.insert(0, str(REPO))
    from tools import noise_audit

    a = noise_audit.noise_window(3, 17, 1000)
    assert a.dtype == np.float32 and a.shape == (1000,)
    assert np.array_equal(a, noise_audit.noise_window(3, 17, 1000))
    assert not np.array_equal(a, noise_audit.noise_window(3, 18, 1000))


def test_noise_audit_ungated_decoder_has_no_gates():
    sys.path.insert(0, str(REPO))
    from cwsl_digi_tpu.modes import base
    from tools import noise_audit

    dec = noise_audit.app_decoder("JS8", ungated=True)
    try:
        assert (dec.spec.sync_min, dec.spec.weak_sync) == (-1, -1)
        assert dec.spec.fmax_hz == 3000.0
    finally:    # later tests of this process get a gated JS8 decoder
        for key in [k for k, v in base._REGISTRY.items() if v is dec]:
            del base._REGISTRY[key]


def test_bench_refuses_cpu():
    env = {k: v for k, v in os.environ.items()}
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"metric"' not in p.stdout
    assert "no GPU" in p.stderr
