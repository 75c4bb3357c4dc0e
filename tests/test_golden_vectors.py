"""Spec-anchored known-answer vectors that do NOT pass through the
project's own encoders.

Every committed fixture and parity trial elsewhere in tests/ was produced
by this repo's encoders, so a systematic encode-side error would
round-trip invisibly.  The vectors here come from independent
transcriptions of the PUBLISHED coding processes, written in a different
style from modes/ (big-integer arithmetic, explicit long division), plus
hand-evaluated constants frozen into the assertions:

  - WSPR: G4JNT, "The WSPR Coding Process" — legacy char values
    ('0'-'9'->0-9, 'A'-'Z'->10-35, space->36; trailing positions -10),
    M1 grid formula, N2 = pwr+64, K=32 r=1/2 convolution with the
    Layland-Lushbaugh polynomials 0xF2D05351/0xE4613C47, 8-bit
    bit-reversal interleaver, tone = sync + 2*data.  The reference gets
    all of this from wsprd.exe (source/DecoderPool.hpp:1023-1026).
  - FT8: the QEX-2020 protocol description — 77-bit-era alphabets with
    space FIRST, NTOKENS=2063592, MAX22=4194304, g15 grid formula,
    CRC-14 poly 0x2757 over the payload zero-extended to 82 bits,
    Costas (3,1,4,0,6,5,2) at symbols 0/36/72, Gray map (0,1,3,2,5,6,4,7).
    (The published generator-matrix head rows are asserted against our
    derived generator in test_tables.py.)  Reference spawn site:
    jt9 -8, source/DecoderPool.hpp:634-659.
  - JT65: QEX 2005 / WSJT lib — legacy packcall/packgrid and the Karn
    RS(63,12) parameters init_rs_int(6, 0x43, fcr=3, prim=1, nroots=51).

The frozen integers below (e.g. packcall("G4JNT") = 258326623) were
hand-evaluated from the published formulas, independently of modes/.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Independent transcriptions (deliberately different structure from modes/)
# ---------------------------------------------------------------------------

def _nchar_legacy(ch: str) -> int:
    """G4JNT: '0'-'9' -> 0-9, 'A'-'Z' -> 10-35, space -> 36."""
    if ch.isdigit():
        return ord(ch) - ord("0")
    if "A" <= ch <= "Z":
        return ord(ch) - ord("A") + 10
    assert ch == " "
    return 36


def _packcall_legacy(call: str) -> int:
    """G4JNT / packjt N1: pad so char 3 is the digit, then the published
    base-37/36/10/27/27/27 accumulation with -10 on the last three."""
    c = call.upper()
    if not c[2:3].isdigit():
        c = " " + c
    c = c.ljust(6)
    n = _nchar_legacy(c[0])
    n = n * 36 + _nchar_legacy(c[1])
    n = n * 10 + _nchar_legacy(c[2])
    for ch in c[3:6]:
        n = n * 27 + (_nchar_legacy(ch) - 10)
    return n


def _packgrid_legacy(grid: str) -> int:
    """G4JNT M1 = (179 - 10*lonA - lonD)*180 + 10*latA + latD."""
    g = grid.upper()
    return ((179 - 10 * (ord(g[0]) - 65) - int(g[2])) * 180
            + 10 * (ord(g[1]) - 65) + int(g[3]))


def _wspr_symbols_independent(call: str, grid: str, dbm: int) -> np.ndarray:
    """Full G4JNT coding process -> 162 channel symbols (tones 0..3)."""
    n1 = _packcall_legacy(call)
    m1 = _packgrid_legacy(grid)
    n2 = m1 * 128 + dbm + 64              # G4JNT's M2 (22 bits)
    # 50-bit message as one big integer: N1 in the top 28, M2 below
    msg = (n1 << 22) | n2
    bits = [(msg >> (49 - i)) & 1 for i in range(50)] + [0] * 31
    # K=32 convolution, MSB of the register = oldest bit
    reg = 0
    coded = []
    for b in bits:
        reg = ((reg << 1) | b) & 0xFFFFFFFF
        for poly in (0xF2D05351, 0xE4613C47):
            coded.append(bin(reg & poly).count("1") & 1)
    # interleave: walk J = 0..255, bit-reverse to R, place next source bit
    dest = [0] * 162
    p = 0
    for j in range(256):
        r = int(format(j, "08b")[::-1], 2)
        if r < 162:
            dest[r] = coded[p]
            p += 1
    assert p == 162
    from cwsl_digi_tpu.modes.tables import WSPR_SYNC

    return np.asarray([s + 2 * d for s, d in zip(WSPR_SYNC, dest)], np.int32)


# ---------------------------------------------------------------------------
# WSPR
# ---------------------------------------------------------------------------

def test_wspr_legacy_packing_hand_values():
    """Frozen hand evaluations of the published formulas."""
    from cwsl_digi_tpu.modes import legacy72

    # " G4JNT": 36; *36+16; *10+4; *27+9; *27+13; *27+19 = 258326623
    assert _packcall_legacy("G4JNT") == 258326623
    assert legacy72.packcall("G4JNT") == 258326623
    # " K1ABC": 36; *36+20=1316; *10+1=13161; *27+0; *27+1; *27+2
    k1abc = ((13161 * 27 + 0) * 27 + 1) * 27 + 2
    assert legacy72.packcall("K1ABC") == _packcall_legacy("K1ABC") == k1abc
    # grid IO90: (179 - 80 - 9)*180 + 140 + 0 = 16340
    assert _packgrid_legacy("IO90") == 16340
    assert legacy72.packgrid15("IO90") == 16340
    # round-trip through the fixed alphabets
    for call in ("G4JNT", "K1ABC", "W9XYZ", "2E0ABC", "VK7AB"):
        assert legacy72.unpackcall(legacy72.packcall(call)) == call


def test_wspr_symbols_match_independent_encoder():
    from cwsl_digi_tpu.modes import wspr

    for call, grid, dbm in (("G4JNT", "IO90", 30), ("K1ABC", "FN42", 37),
                            ("W9XYZ", "EN50", 10)):
        ours = wspr.encode(call, grid, dbm)
        indep = _wspr_symbols_independent(call, grid, dbm)
        assert np.array_equal(ours, indep), (call, grid, dbm)


def test_wspr_decodes_tones_built_from_published_numbers():
    """Synthesize from the INDEPENDENT symbol sequence and decode."""
    from cwsl_digi_tpu.modes import wspr
    from cwsl_digi_tpu.modes.gfsk import gfsk_modulate

    tones = _wspr_symbols_independent("K1ABC", "FN42", 37)
    burst = gfsk_modulate(tones, 1500.0, 8192, 12000, 12000.0 / 8192,
                          bt=2.0)
    win = np.zeros(int(120.0 * 12000), np.float32)
    win[12000 : 12000 + len(burst)] += burst.astype(np.float32)
    rng = np.random.default_rng(7)
    win += 0.02 * rng.standard_normal(len(win)).astype(np.float32)
    res = wspr.WSPRDecoder().decode(win[None])[0]
    assert any(r.message == "K1ABC FN42 37" for r in res), res


# ---------------------------------------------------------------------------
# FT8 (77-bit era)
# ---------------------------------------------------------------------------

def _crc14_long_division(bits77) -> list[int]:
    """CRC-14, poly 0x2757, over the payload zero-extended to 82 bits —
    plain polynomial long division on a big integer."""
    msg = 0
    for b in bits77:
        msg = (msg << 1) | int(b)
    msg <<= 5                                  # 77 -> 82 bits
    msg <<= 14                                 # append CRC space
    divisor = (1 << 14) | 0x2757
    for shift in range(82 + 14 - 15, -1, -1):
        if (msg >> (shift + 14)) & 1:
            msg ^= divisor << shift
    return [(msg >> (13 - i)) & 1 for i in range(14)]


def test_ft8_crc14_against_long_division():
    from cwsl_digi_tpu.modes.crc import ft8_crc

    rng = np.random.default_rng(3)
    for _ in range(20):
        payload = rng.integers(0, 2, 77).astype(np.uint8)
        assert list(ft8_crc(payload)) == _crc14_long_division(payload)


def test_ft8_c28_g15_hand_values():
    """77-bit alphabets (space FIRST) + published token layout."""
    from cwsl_digi_tpu.modes import message77

    NTOKENS, MAX22 = 2_063_592, 4_194_304
    assert message77.NTOKENS == NTOKENS and message77.MAX22 == MAX22
    # tokens: DE=0, QRZ=1, CQ=2
    assert message77.pack_call28("DE") == 0
    assert message77.pack_call28("QRZ") == 1
    assert message77.pack_call28("CQ") == 2
    # " K1ABC" with space-first alphabets: i=(0,20,1,1,2,3)
    n = ((((0 * 36 + 20) * 10 + 1) * 27 + 1) * 27 + 2) * 27 + 3
    assert message77.pack_call28("K1ABC") == NTOKENS + MAX22 + n
    # grid EN37: (4*18 + 13)*100 + 37 = 8537
    g15, _ = message77.pack_grid15("EN37")
    assert g15 == 8537


def test_ft8_tone_assembly_published_structure():
    """Costas placement + Gray mapping vs an independent assembly."""
    from cwsl_digi_tpu.modes import ft8

    rng = np.random.default_rng(9)
    cw = rng.integers(0, 2, 174).astype(np.uint8)
    ours = ft8.SPEC.tones_from_codeword(cw)
    costas = (3, 1, 4, 0, 6, 5, 2)
    gray = (0, 1, 3, 2, 5, 6, 4, 7)
    indep = []
    k = 0
    for s in range(79):
        if s < 7:
            indep.append(costas[s])
        elif 36 <= s <= 42:
            indep.append(costas[s - 36])
        elif s >= 72:
            indep.append(costas[s - 72])
        else:
            v = 4 * cw[k] + 2 * cw[k + 1] + cw[k + 2]
            k += 3
            indep.append(gray[v])
    assert k == 174
    assert np.array_equal(ours, np.asarray(indep))


def test_ft8_codeword_satisfies_published_parity():
    """encode_message output must lie in the published LDPC(174,91) code
    (H from the FT8_LDPC_NM table; its generator head rows are checked
    against the published hex in test_tables.py)."""
    from cwsl_digi_tpu.modes import ft8
    from cwsl_digi_tpu.modes.crc import ft8_crc
    from cwsl_digi_tpu.modes.message77 import pack77
    from cwsl_digi_tpu.modes.tables import ft8_parity_matrix

    payload = pack77("K1ABC W9XYZ EN37")
    info = np.concatenate([payload, np.asarray(ft8_crc(payload), np.uint8)])
    cw = ft8.ft8_code().encode(info)
    assert cw.shape == (174,)
    assert np.array_equal(cw[:91], info)       # systematic, info first
    h = ft8_parity_matrix()
    assert not (h @ cw % 2).any()


# ---------------------------------------------------------------------------
# JT65 RS(63,12)
# ---------------------------------------------------------------------------

def _rs63_12_encode_independent(info: np.ndarray) -> np.ndarray:
    """Karn-parameter RS(63,12): GF(64) prim poly x^6+x+1 (0x43), fcr=3,
    prim=1, 51 roots — schoolbook polynomial remainder."""
    exp = [0] * 127
    log = [0] * 64
    x = 1
    for i in range(63):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x40:
            x ^= 0x43
    for i in range(63, 127):
        exp[i] = exp[i - 63]

    def mul(a, b):
        if a == 0 or b == 0:
            return 0
        return exp[(log[a] + log[b]) % 63]

    g = [1]
    for i in range(3, 3 + 51):                 # roots alpha^3..alpha^53
        root = exp[i % 63]
        ng = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            ng[j] ^= mul(c, root)
            ng[j + 1] ^= c
        g = ng                                 # lowest-degree first
    g = g[::-1]                                # highest first, monic
    assert g[0] == 1 and len(g) == 52
    rem = list(info) + [0] * 51
    for i in range(12):
        lead = rem[i]
        if lead:
            for j in range(52):
                rem[i + j] ^= mul(lead, g[j])
    return np.concatenate([info, np.asarray(rem[12:], np.uint8)])


def test_jt65_rs_codeword_matches_independent():
    from cwsl_digi_tpu.modes.rs64 import RS63

    rs = RS63(k=12, fcr=3)
    rng = np.random.default_rng(17)
    for _ in range(5):
        info = rng.integers(0, 64, 12).astype(np.uint8)
        ours = rs.encode(info)
        indep = _rs63_12_encode_independent(info)
        # order matters: both must be [info | parity]
        assert np.array_equal(ours, indep)
