"""External protocol-table loader (modes/tables_ext.py).

The four published tables that could not be reconstructed bit-exactly
(JT65 sync, JS8 Costas/LDPC, FST4 LDPC, Q65 QRA) are user-suppliable at
runtime.  These tests write well-formed substitute tables to a directory,
point CWSL_DIGI_TPU_TABLES_DIR at it in a SUBPROCESS (the tables are read
at module import), and assert every mode actually picked them up and
still encodes/validates self-consistently.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from cwsl_digi_tpu.modes import tables_ext
from cwsl_digi_tpu.modes.ldpc import make_ldpc_code
from cwsl_digi_tpu.modes.qra import build_qra_code


def _write_tables(d):
    # JT65 sync: alternating chips — 126 long, exactly 63 ones (the
    # validated invariants of the published vector)
    sync = np.zeros(126, np.int32)
    sync[::2] = 1
    (d / "jt65_sync.txt").write_text(
        "# substitute vector\n" + " ".join(map(str, sync)) + "\n")
    # JS8 costas: one row, expanded to all three blocks
    (d / "js8_costas.txt").write_text("0 1 2 3 4 5 6\n")
    # LDPC H matrices: same-profile codes at NON-DEFAULT seeds, so loading
    # them provably changes the constructed code
    h_js8 = make_ldpc_code(174, 87, seed=88).h
    (d / "js8_ldpc_174_87.txt").write_text(
        "\n".join(" ".join(map(str, r)) for r in h_js8) + "\n")
    h_fst4 = make_ldpc_code(240, 101, seed=241).h
    (d / "fst4_ldpc_240_101.txt").write_text(
        "\n".join(" ".join(map(str, r)) for r in h_fst4) + "\n")
    # Q65 QRA dense H from a non-default stand-in construction
    code = build_qra_code(63, 13, seed=66, info_w=4)
    dense = np.zeros((50, 63), np.int64)
    for i in range(50):
        for s in range(code.h_vars.shape[1]):
            if code.row_mask[i, s]:
                dense[i, code.h_vars[i, s]] = code.h_coeff[i, s]
    (d / "q65_qra_63_13.txt").write_text(
        "\n".join(" ".join(map(str, r)) for r in dense) + "\n")
    return sync, h_js8, h_fst4, dense


def test_loaders_pick_up_supplied_tables(tmp_path):
    sync, h_js8, h_fst4, dense = _write_tables(tmp_path)
    np.save(tmp_path / "expect_sync.npy", sync)
    np.save(tmp_path / "expect_js8.npy", h_js8)
    np.save(tmp_path / "expect_fst4.npy", h_fst4)
    np.save(tmp_path / "expect_qra.npy", dense)
    code = textwrap.dedent("""
        import os
        os.environ["JAX_PLATFORMS"] = "cpu"
        import numpy as np
        import jax; jax.config.update("jax_platforms", "cpu")
        d = os.environ["TD"]
        from cwsl_digi_tpu.modes import jt65, js8, q65
        from cwsl_digi_tpu.modes.ldpc import fst4_code

        assert np.array_equal(jt65.SYNC,
                              np.load(d + "/expect_sync.npy")), "jt65 sync"
        # provenance flag: this override differs from the embedded
        # published vector, so the flag must report False (advisor r3)
        assert not jt65.SYNC_IS_PUBLISHED
        assert js8.COSTAS_JS8 == (0, 1, 2, 3, 4, 5, 6), "js8 costas"
        assert (0, 0) in js8.SPEC.sync_cells
        assert np.array_equal(js8.js8_code().h,
                              np.load(d + "/expect_js8.npy")), "js8 H"
        assert np.array_equal(fst4_code().h,
                              np.load(d + "/expect_fst4.npy")), "fst4 H"
        # q65 code rebuilt from the dense file: encode/syndrome round-trip
        info = np.arange(13) % 64
        cw = q65._CODE.encode(info)
        assert q65._CODE.syndrome_ok(cw), "q65 syndrome"
        dense = np.load(d + "/expect_qra.npy")
        got = np.zeros_like(dense)
        c = q65._CODE
        for i in range(50):
            for s in range(c.h_vars.shape[1]):
                if c.row_mask[i, s]:
                    got[i, c.h_vars[i, s]] = c.h_coeff[i, s]
        assert np.array_equal(got, dense), "q65 H"
        # the supplied tables flow through the FULL pipeline:
        # synthesize -> sync -> demod -> FEC decode (-> subtract for the
        # second JS8 burst) -> message, proving a one-file drop of the
        # published tables needs no code change
        from cwsl_digi_tpu.modes import fst4
        from cwsl_digi_tpu.modes.gfsk import add_noise_at_snr
        from cwsl_digi_tpu.constants import Mode
        rng = np.random.default_rng(5)

        win = q65.synthesize("K1ABC W9XYZ EN37", 1000.0, start_s=0.6)
        res = q65.Q65Decoder().decode(
            add_noise_at_snr(win, -18.0, 12000, rng)[None])[0]
        assert any(r.message == "K1ABC W9XYZ EN37" for r in res), "q65 dec"

        w = fst4.synthesize("K1ABC FN42 30", Mode.FST4W_120, 1500.0)
        res = fst4.FST4Decoder(Mode.FST4W_120).decode(
            add_noise_at_snr(w, -26.0, 12000, rng)[None])[0]
        assert any(r.message == "K1ABC FN42 30" for r in res), "fst4w dec"

        # two JS8 bursts, strong over weak: the second only decodes after
        # the depth-2 subtraction pass rebuilds the residual with the
        # override LDPC's generator — exercising encode->decode->subtract
        win2 = (10.0 * js8.synthesize("HELLO WORLD", 1500.0, start_s=0.5)
                + 1.0 * js8.synthesize("73 DE K1ABC", 1560.0, start_s=0.6))
        res = js8.JS8Decoder().decode(
            add_noise_at_snr(win2, 10.0, 12000, rng)[None])[0]
        msgs = {r.message for r in res}
        assert "HELLO WORLD" in msgs, msgs
        assert "73 DE K1ABC" in msgs, ("js8 subtract pass", msgs)
        print("TABLES-OK")
    """)
    env = dict(os.environ)
    env["CWSL_DIGI_TPU_TABLES_DIR"] = str(tmp_path)
    env["TD"] = str(tmp_path)
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    assert "TABLES-OK" in p.stdout, p.stdout + p.stderr


def test_malformed_tables_raise(tmp_path, monkeypatch):
    monkeypatch.setenv(tables_ext.ENV_VAR, str(tmp_path))
    # wrong ones count -> rejected loudly, not silently substituted
    v = np.zeros(126, np.int32)
    v[:70] = 1
    (tmp_path / "jt65_sync.txt").write_text(" ".join(map(str, v)))
    tables_ext.jt65_sync.cache_clear()
    with pytest.raises(ValueError, match="63"):
        tables_ext.jt65_sync()
    (tmp_path / "js8_costas.txt").write_text("0 1 2 3 4 5 5\n")
    tables_ext.js8_costas.cache_clear()
    with pytest.raises(ValueError, match="distinct"):
        tables_ext.js8_costas()
    (tmp_path / "fst4_ldpc_240_101.txt").write_text("1 0 1\n")
    tables_ext.fst4_parity.cache_clear()
    with pytest.raises(ValueError, match="shape"):
        tables_ext.fst4_parity()


def test_absent_dir_yields_none(monkeypatch):
    monkeypatch.delenv(tables_ext.ENV_VAR, raising=False)
    tables_ext.jt65_sync.cache_clear()
    tables_ext.js8_parity.cache_clear()
    assert tables_ext.jt65_sync() is None
    assert tables_ext.js8_parity() is None
