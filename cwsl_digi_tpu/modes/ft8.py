"""FT8: 8-GFSK, 79 symbols, LDPC(174,91)+CRC14 — native batched device decoder.

The flagship mode.  The reference hands 15 s windows to external ``jt9 -8``
processes (source/DecoderPool.hpp:634-676); here the whole decode — sync
search, demodulation, LDPC, CRC — is one fixed-shape JAX program batched
over capture windows and sync candidates (the shared engine in
gfsk_engine.py).

Protocol structure (public FT8 parameters):
  - 12.64 s burst: 79 symbols x 0.16 s (1920 samples @ 12 kHz), 6.25 baud;
  - 8-GFSK, tone spacing 6.25 Hz, BT=2.0;
  - 7x7 Costas arrays [3,1,4,0,6,5,2] at symbol offsets 0, 36, 72;
  - 58 data symbols carry 174 codeword bits, 3 per symbol, Gray-mapped
    [0,1,3,2,5,6,4,7];
  - codeword = LDPC(174,91) over [77 payload | 14 CRC] (see ldpc.py for the
    interop note on the parity-check table).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cwsl_digi_tpu.constants import Mode, WAVE_SR
from cwsl_digi_tpu.modes import message77
from cwsl_digi_tpu.modes.base import DecodeResult
from cwsl_digi_tpu.modes.crc import ft8_crc, ft8_crc_matrix
from cwsl_digi_tpu.modes.gfsk import gfsk_modulate
from cwsl_digi_tpu.modes.gfsk_engine import GFSKDecoder, ModeSpec, decode_program
from cwsl_digi_tpu.modes.ldpc import ft8_code, get_bp_decoder

# ---------------------------------------------------------------------------
# Protocol constants
# ---------------------------------------------------------------------------
COSTAS = np.array([3, 1, 4, 0, 6, 5, 2], dtype=np.int32)
GRAY = np.array([0, 1, 3, 2, 5, 6, 4, 7], dtype=np.int32)      # 3 bits -> tone
IGRAY = np.argsort(GRAY).astype(np.int32)                       # tone -> 3 bits
NSYM = 79
SPS = 1920                  # samples/symbol @ 12 kHz
BAUD = WAVE_SR / SPS        # 6.25
TONE_SPACING = BAUD         # Hz
NUM_TONES = 8
T_R = 15.0
SIGNAL_START_S = 0.5
HOP = SPS // 4
NFFT = 2 * SPS
BIN_HZ = WAVE_SR / NFFT

_sync_cells = tuple(
    (off + i, int(t))
    for off in (0, 36, 72)
    for i, t in enumerate(COSTAS)
)
DATA_SYM = tuple(
    s for s in range(NSYM) if not (s < 7 or 36 <= s < 43 or s >= 72)
)
assert len(DATA_SYM) == 58

SPEC = ModeSpec(
    name="FT8",
    n_sym=NSYM,
    sps=SPS,
    n_tones=NUM_TONES,
    bits_per_sym=3,
    sync_cells=_sync_cells,
    data_syms=DATA_SYM,
    gray_map=tuple(GRAY.tolist()),
    trperiod=T_R,
    signal_start_s=SIGNAL_START_S,
    top_k=512,
    bp_iters=30,
    max_hops=256,
    pad_hops=128,
    os_t=8,
    os_f=4,
    refine=True,
    sync_min=6,
    weak_sync=10,
    snr_floor_db=-24.0,
)


# ---------------------------------------------------------------------------
# Encoder (for tests, benchmarks, and signal subtraction)
# ---------------------------------------------------------------------------

def encode_payload(payload77: np.ndarray) -> np.ndarray:
    """payload 77 bits -> 79 tone indices."""
    payload77 = np.asarray(payload77, np.uint8)
    info91 = np.concatenate([payload77, ft8_crc(payload77)])
    codeword = ft8_code().encode(info91)            # 174 bits
    return SPEC.tones_from_codeword(codeword)


def encode_message(text: str) -> np.ndarray:
    return encode_payload(message77.pack77(text))


def synthesize(
    text: str,
    f0_hz: float = 1500.0,
    amplitude: float = 1.0,
    window_len: int = int(T_R * WAVE_SR),
    start_s: float = SIGNAL_START_S,
) -> np.ndarray:
    """Full 15 s window containing one FT8 burst (no noise)."""
    from cwsl_digi_tpu.modes.gfsk import place_burst

    burst = gfsk_modulate(encode_message(text), f0_hz, SPS, WAVE_SR,
                          TONE_SPACING, bt=2.0)
    return place_burst(burst, window_len, start_s, amplitude)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def ap_hypotheses(my_call: str = "", dx_call: str = "") -> np.ndarray:
    """A-priori decoding hypotheses (reference AP flags forwarded to jt9,
    source/DecoderPool.hpp:466-469).

    Rows are 77-element vectors: -1 = bit unknown, 0/1 = bit forced.
    Hypothesis 0 is always "no AP"; then "CQ ..." and, when configured,
    "MYCALL ..." / "MYCALL DXCALL ...".
    """
    rows = [np.full(77, -1, np.int8)]

    def with_c28a(c28: int, extra=()):
        h = np.full(77, -1, np.int8)
        h[0:28] = message77.bits_from_int(c28, 28)
        h[28] = 0                      # r1a
        h[74:77] = [0, 0, 1]           # i3 = 1 (standard message)
        for idx, v in extra:
            h[idx] = v
        return h

    rows.append(with_c28a(message77.pack_call28("CQ")))
    if my_call:
        try:
            rows.append(with_c28a(message77.pack_call28(my_call)))
            if dx_call:
                h = with_c28a(message77.pack_call28(my_call))
                h[29:57] = message77.bits_from_int(
                    message77.pack_call28(dx_call), 28)
                h[57] = 0
                rows.append(h)
        except ValueError:
            pass
    return np.stack(rows)


class FT8Decoder(GFSKDecoder):
    """Host wrapper: batched windows in, DecodeResult lists out."""

    def __init__(self, top_k: int | None = None, bp_iters: int | None = None,
                 spec: ModeSpec | None = None,
                 ap: np.ndarray | bool | None = None,
                 my_call: str = "", depth: int | None = None,
                 fmax_hz: float | None = None):
        s = spec or SPEC
        if top_k or bp_iters or depth or fmax_hz:
            # fmax_hz ≙ jt9 -H highestdecodefreq (DecoderPool.hpp:636-651)
            s = dataclasses.replace(s, top_k=top_k or s.top_k,
                                    bp_iters=bp_iters or s.bp_iters,
                                    depth=depth or s.depth,
                                    fmax_hz=fmax_hz or s.fmax_hz)
        if ap is True or (ap is None and my_call):
            ap = ap_hypotheses(my_call)
        elif ap is False:
            ap = None
        super().__init__(
            s,
            get_bp_decoder("ft8", iters=s.bp_iters),
            ft8_crc_matrix(),
            Mode.FT8,
            unpack=lambda bits: message77.unpack77_text(bits[:77]),
            ap_hypotheses=ap if isinstance(ap, np.ndarray) else None,
        )


def results_from_arrays(out: dict[str, np.ndarray],
                        mode: Mode = Mode.FT8,
                        spec: ModeSpec = SPEC) -> list[list[DecodeResult]]:
    """Host-side: validated candidate arrays -> deduped DecodeResult lists.

    Used by callers that run the device program themselves (e.g. the sharded
    pipeline) and only need the host unpack.
    """
    n_windows, top_k = out["valid"].shape
    results: list[list[DecodeResult]] = []
    for wi in range(n_windows):
        seen: dict[bytes, DecodeResult] = {}
        for k in range(top_k):
            if not out["valid"][wi, k]:
                continue
            payload = np.asarray(out["payload"][wi, k, :77])
            text = message77.unpack77_text(payload)
            if text is None:
                continue
            key = np.packbits(payload).tobytes()
            dt = out["t0_hop"][wi, k] * spec.hop / WAVE_SR - spec.signal_start_s
            freq = out["f0_bin"][wi, k] * spec.bin_hz
            r = DecodeResult(
                message=text,
                snr_db=round(float(out["snr"][wi, k]), 1),
                dt_s=round(float(dt), 2),
                freq_hz=round(float(freq), 1),
                score=float(out["score"][wi, k]),
                mode=mode,
                payload_bits=payload.copy(),
            )
            prev = seen.get(key)
            if prev is None or r.score > prev.score:
                seen[key] = r
        results.append(sorted(seen.values(), key=lambda r: -r.score))
    return results
