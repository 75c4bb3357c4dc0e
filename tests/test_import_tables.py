"""tools/import_tables.py: WSJT-X / JS8Call source formats -> tables dir.

Feeds synthetic files in each upstream format (Fortran Nm/Mn data
statements, js8call varicode.cpp pair initializers) through the importer
and asserts the emitted tables load byte-identically through
modes/tables_ext — then decodes a JS8 signal end-to-end under the
imported tables.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

TOOLS = Path(__file__).resolve().parent.parent / "tools"
sys.path.insert(0, str(TOOLS))

from cwsl_digi_tpu.modes import tables_ext  # noqa: E402
from cwsl_digi_tpu.modes.ldpc import make_ldpc_code  # noqa: E402


def _h_to_params_f90(h: np.ndarray, name_n: int, name_k: int,
                     column_major: bool = True) -> str:
    """Format H the way ldpc_*_params.f90 stores it: Nm (per-check var
    indices, 1-based, zero-padded) + Mn (per-bit check indices)."""
    n_checks, n = h.shape
    deg_c = int(h.sum(axis=1).max())
    deg_b = int(h.sum(axis=0).max())
    nm = np.zeros((n_checks, deg_c), np.int64)
    for c in range(n_checks):
        idx = np.nonzero(h[c])[0] + 1
        nm[c, : len(idx)] = idx
    mn = np.zeros((n, deg_b), np.int64)
    for b in range(n):
        idx = np.nonzero(h[:, b])[0] + 1
        mn[b, : len(idx)] = idx
    def fmt(arr, decl):
        rows = []
        # Fortran data fills column-major for decl (deg, count): one
        # source row (= one check/bit) per line of ``deg`` values
        for r in arr:
            rows.append("  " + ", ".join(str(int(v)) for v in r) + ", &")
        body = "\n".join(rows).rstrip(", &") + " &"
        return f"integer {decl}\ndata {decl.split('(')[0]}/ &\n{body}\n/\n"
    return ("! synthetic test file in the upstream params format\n"
            + fmt(nm, f"Nm({deg_c},{n_checks})")
            + fmt(mn, f"Mn({deg_b},{n})"))


def test_import_ldpc_params_f90(tmp_path, monkeypatch):
    import import_tables

    h_js8 = make_ldpc_code(174, 87, seed=89).h
    h_fst4 = make_ldpc_code(240, 101, seed=242).h
    src = tmp_path / "src"
    src.mkdir()
    (src / "ldpc_174_87_params.f90").write_text(
        _h_to_params_f90(h_js8, 174, 87))
    (src / "ldpc_240_101_params.f90").write_text(
        _h_to_params_f90(h_fst4, 240, 101))
    out = tmp_path / "tables"
    emitted = import_tables.import_tree(src, out)
    assert set(emitted) == {"js8_ldpc_174_87.txt", "fst4_ldpc_240_101.txt"}

    monkeypatch.setenv(tables_ext.ENV_VAR, str(out))
    tables_ext.js8_parity.cache_clear()
    tables_ext.fst4_parity.cache_clear()
    try:
        assert np.array_equal(tables_ext.js8_parity(), h_js8)
        assert np.array_equal(tables_ext.fst4_parity(), h_fst4)
    finally:
        monkeypatch.delenv(tables_ext.ENV_VAR)
        tables_ext.js8_parity.cache_clear()
        tables_ext.fst4_parity.cache_clear()


def test_import_nm_mn_mismatch_raises(tmp_path):
    import import_tables

    h = make_ldpc_code(174, 87, seed=89).h
    h2 = make_ldpc_code(174, 87, seed=90).h
    text = _h_to_params_f90(h, 174, 87)
    text2 = _h_to_params_f90(h2, 174, 87)
    # splice h's Nm with h2's Mn -> must be rejected, not emitted
    nm_part = text[: text.index("integer Mn")]
    mn_part = text2[text2.index("integer Mn"):]
    (tmp_path / "ldpc_174_87_params.f90").write_text(nm_part + mn_part)
    with pytest.raises(ValueError, match="different matrices"):
        import_tables.import_file(
            tmp_path / "ldpc_174_87_params.f90", tmp_path)


def test_import_varicode_cpp(tmp_path, monkeypatch):
    import import_tables

    from cwsl_digi_tpu.modes import js8_varicode as vc

    # synthesize a varicode.cpp carrying the default table as js8call
    # writes it: {"char", "bits"} initializer pairs (EOT as \x04)
    pairs = []
    for ch, bits in vc.default_table().items():
        tok = {"\x04": "\\x04", '"': '\\"', "\\": "\\\\"}.get(ch, ch)
        pairs.append(f'    {{"{tok}", "{bits}"}},')
    cpp = ("// synthetic js8call varicode.cpp\n"
           "QList<QPair<QString, QString>> Varicode::huffTable = {\n"
           + "\n".join(pairs) + "\n};\n")
    src = tmp_path / "varicode.cpp"
    src.write_text(cpp)
    out = tmp_path / "tables"
    out.mkdir()
    emitted = import_tables.import_file(src, out)
    assert emitted == ["js8_varicode.txt"]

    monkeypatch.setenv(tables_ext.ENV_VAR, str(out))
    tables_ext.js8_varicode.cache_clear()
    vc._active.cache_clear()
    try:
        assert vc.is_external()
        assert vc.table() == vc.default_table()
        text = "IMPORTED OK"
        assert vc.decode(vc.encode(text, budget=None)) == text
    finally:
        monkeypatch.delenv(tables_ext.ENV_VAR)
        tables_ext.js8_varicode.cache_clear()
        vc._active.cache_clear()


def test_import_varicode_without_eot_rejected(tmp_path):
    import import_tables

    cpp = 'x = {\n  {"A", "01"},\n  {"B", "10"},\n};\n'
    (tmp_path / "varicode.cpp").write_text(cpp)
    with pytest.raises(ValueError, match="EOT"):
        import_tables.import_file(tmp_path / "varicode.cpp", tmp_path)


def test_imported_tables_decode_end_to_end(tmp_path):
    """Full pipeline under imported tables: synthesize a JS8 signal with
    the imported LDPC + codebook, decode it in a subprocess whose
    CWSL_DIGI_TPU_TABLES_DIR points at the importer's output."""
    import import_tables

    from cwsl_digi_tpu.modes import js8_varicode as vc

    h_js8 = make_ldpc_code(174, 87, seed=89).h
    src = tmp_path / "src"
    src.mkdir()
    (src / "ldpc_174_87_params.f90").write_text(
        _h_to_params_f90(h_js8, 174, 87))
    pairs = []
    for ch, bits in vc.default_table().items():
        tok = {"\x04": "\\x04", '"': '\\"', "\\": "\\\\"}.get(ch, ch)
        pairs.append(f'    {{"{tok}", "{bits}"}},')
    (src / "varicode.cpp").write_text("{\n" + "\n".join(pairs) + "\n};\n")
    out = tmp_path / "tables"
    emitted = import_tables.import_tree(src, out)
    assert len(emitted) == 2

    code = textwrap.dedent("""
        import os
        os.environ["JAX_PLATFORMS"] = "cpu"
        import numpy as np
        import jax; jax.config.update("jax_platforms", "cpu")
        from cwsl_digi_tpu.modes import js8
        from cwsl_digi_tpu.modes.gfsk import add_noise_at_snr
        rng = np.random.default_rng(6)
        win = js8.synthesize("HELLO WORLD", 1500.0)
        res = js8.JS8Decoder(top_k=32, bp_iters=25).decode(
            add_noise_at_snr(win, -10.0, 12000, rng)[None])[0]
        assert any(r.message == "HELLO WORLD" for r in res), res
        print("IMPORT-DECODE-OK")
    """)
    env = dict(os.environ)
    env["CWSL_DIGI_TPU_TABLES_DIR"] = str(out)
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    assert "IMPORT-DECODE-OK" in p.stdout, p.stdout + p.stderr
