"""FT4: 4-GFSK, 7.5 s T/R, LDPC(174,91)+CRC14 — native batched device decoder.

The reference invokes ``jt9 -5`` with ntrperiod=7.5 (source/
DecoderPool.hpp:472-477,643); here FT4 is a parameterization of the shared
GFSK engine (gfsk_engine.py).

Physical layer (public FT4 parameters): 105 symbols x 576 samples @ 12 kHz
(20.833 baud, tone spacing = baud), 4-GFSK with Gray map [0,1,3,2]; four
4-symbol sync sequences at symbol offsets 0, 33, 66, 99; 2 ramp symbols
(first/last) and 87 data symbols carrying the 174 codeword bits, 2 per
symbol; same LDPC(174,91) + CRC-14 as FT8 (message payload codec:
message77.py).
"""

from __future__ import annotations

import numpy as np

from cwsl_digi_tpu.constants import Mode, WAVE_SR
from cwsl_digi_tpu.modes import message77
from cwsl_digi_tpu.modes.crc import ft8_crc, ft8_crc_matrix
from cwsl_digi_tpu.modes.gfsk import gfsk_modulate
from cwsl_digi_tpu.modes.gfsk_engine import GFSKDecoder, ModeSpec
from cwsl_digi_tpu.modes.ldpc import ft8_code, get_bp_decoder

SPS = 576
NSYM = 105
T_R = 7.5
GRAY = np.array([0, 1, 3, 2], dtype=np.int32)

# Four 4-symbol sync sequences ("4x4 Costas" arrays) after the leading ramp
# symbol; symbols 0 and 104 are ramp-only and carry neither sync nor data.
SYNC_SEQS = (
    (1, (0, 1, 3, 2)),
    (34, (1, 0, 2, 3)),
    (67, (2, 3, 1, 0)),
    (100, (3, 2, 0, 1)),
)
_sync_cells = tuple(
    (off + i, tone) for off, seq in SYNC_SEQS for i, tone in enumerate(seq)
)
_sync_syms = {s for s, _ in _sync_cells}
_RAMP_SYMS = (0, 104)
DATA_SYM = tuple(
    s for s in range(NSYM)
    if s not in _sync_syms and s not in _RAMP_SYMS
)
assert len(DATA_SYM) == 87

SPEC = ModeSpec(
    name="FT4",
    n_sym=NSYM,
    sps=SPS,
    n_tones=4,
    bits_per_sym=2,
    sync_cells=_sync_cells,
    data_syms=DATA_SYM,
    gray_map=tuple(GRAY.tolist()),
    trperiod=T_R,
    signal_start_s=0.5,
    top_k=192,
    bp_iters=30,
    snr_offset_db=-1.0,   # calibrated vs injected SNR (tools/snr_check.py)
    max_hops=320,     # dt search -0.77..+1.15 s (6 ms hops at os_t=8)
    pad_hops=128,
    os_t=8,
    os_f=4,
    refine=True,
    bt=1.0,
    # weak-candidate gates, from noise audits (tools/noise_audit.py): every
    # false decode came from OSD, with a hard sync count of 6-11 of 16 and
    # an SNR of -19.6 to -21.2 dB; true decodes at -17..-19 dB had 8-16
    # and -15 to -20.3 dB.  8 OSD candidates recall as many as 16.
    sync_min=6,       # jt9's FT4 floor: 20 of the 32 sync bits
    weak_sync=11,
    snr_floor_db=-20.4,
    osd_sync_min=9,
    osd_j=8,
)


def encode_payload(payload77: np.ndarray) -> np.ndarray:
    payload77 = np.asarray(payload77, np.uint8)
    info91 = np.concatenate([payload77, ft8_crc(payload77)])
    codeword = ft8_code().encode(info91)
    return SPEC.tones_from_codeword(codeword)


def encode_message(text: str) -> np.ndarray:
    return encode_payload(message77.pack77(text))


def synthesize(text: str, f0_hz: float = 1500.0, amplitude: float = 1.0,
               window_len: int = int(T_R * WAVE_SR),
               start_s: float = 0.5) -> np.ndarray:
    from cwsl_digi_tpu.modes.gfsk import place_burst

    burst = gfsk_modulate(encode_message(text), f0_hz, SPS, WAVE_SR,
                          SPEC.tone_spacing, bt=1.0)
    return place_burst(burst, window_len, start_s, amplitude)


class FT4Decoder(GFSKDecoder):
    def __init__(self, top_k: int | None = None, bp_iters: int | None = None,
                 depth: int | None = None, fmax_hz: float | None = None):
        import dataclasses as _dc

        spec = SPEC
        if top_k or bp_iters or depth or fmax_hz:
            # fmax_hz ≙ jt9 -H highestdecodefreq (DecoderPool.hpp:636-651)
            spec = _dc.replace(SPEC, top_k=top_k or SPEC.top_k,
                               bp_iters=bp_iters or SPEC.bp_iters,
                               depth=depth or SPEC.depth,
                               fmax_hz=fmax_hz or SPEC.fmax_hz)
        super().__init__(
            spec,
            get_bp_decoder("ft8", iters=spec.bp_iters),
            ft8_crc_matrix(),
            Mode.FT4,
            unpack=lambda bits: message77.unpack77_text(bits[:77]),
        )
