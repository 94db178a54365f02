"""Where the port's output codec (``csrc/fastio.c``) cannot be built or
loaded, ``utils/io.py`` reads and writes the deck files in Python: the
process says so once on stderr, with the reason, and the bytes are the
codec's."""

import numpy as np
import pytest

from advanced_hpc_lbm_tpu_torch import LBMParams
from advanced_hpc_lbm_tpu_torch.utils import io, native

WARNING = "the output codec is not available"


def _case():
    rng = np.random.default_rng(11)
    params = LBMParams(nx=11, ny=13, max_iters=1, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    f = (rng.random((9, 13, 11)) * 0.02 + 0.005).astype(np.float32)
    mask = rng.random((13, 11)) < 0.2
    av = (rng.random(17) * 1e-2).astype(np.float32)
    return params, f, mask, av


def _write_all(d, deck):
    """Both output files and an obstacle deck read back, twice over."""
    params, f, mask, av = _case()
    yy, xx = np.nonzero(mask)
    deck.write_text("".join(f"{x} {y} 1\n" for x, y in zip(xx.tolist(), yy.tolist())))
    for _ in range(2):
        io.write_final_state(d / "final_state.dat", f, mask, params)
        io.write_av_vels(d / "av_vels.dat", av)
        np.testing.assert_array_equal(io.load_obstacles(deck, params), mask)
    return (d / "final_state.dat").read_bytes(), (d / "av_vels.dat").read_bytes()


@pytest.fixture(scope="module")
def codec_bytes(tmp_path_factory):
    native._library.cache_clear()
    if not native.available():
        pytest.skip("cc cannot build the codec here")
    d = tmp_path_factory.mktemp("codec")
    return _write_all(d, d / "deck.dat")


def _no_source(mp, tmp):
    mp.setattr(native, "SRC", tmp / "absent.c")
    return "no source"


def _no_cc(mp, tmp):
    mp.setattr(native, "BUILD_DIR", tmp / "build")
    mp.setattr(native, "_cc", lambda: None)
    return "no C compiler"


def _unwritable_dir(mp, tmp):
    (tmp / "a_file").write_text("")
    mp.setattr(native, "BUILD_DIR", tmp / "a_file" / "build")
    return "cannot write the build directory"


def _compiler_error(mp, tmp):
    (tmp / "bad.c").write_text("int broken(void) { return }\n")
    mp.setattr(native, "SRC", tmp / "bad.c")
    mp.setattr(native, "BUILD_DIR", tmp / "build")
    return "error"


def _unloadable(mp, tmp):
    mp.setattr(native, "BUILD_DIR", tmp / "build")
    (tmp / "build").mkdir()
    native.library_path().write_bytes(b"not a shared object")
    return str(native.library_path())  # the loader's message names the file


@pytest.mark.parametrize("breaks", [_no_source, _no_cc, _unwritable_dir, _compiler_error,
                                    _unloadable],
                         ids=["no-source", "no-cc", "unwritable-dir", "compiler-error",
                              "unloadable"])
def test_codec_failure_warns_once_and_keeps_the_bytes(breaks, codec_bytes, monkeypatch,
                                                      tmp_path, capsys):
    reason = breaks(monkeypatch, tmp_path)
    native._library.cache_clear()
    try:
        capsys.readouterr()
        out = tmp_path / "out"
        out.mkdir()
        got = _write_all(out, tmp_path / "deck.dat")
        err = capsys.readouterr().err
    finally:
        native._library.cache_clear()
    warned = [ln for ln in err.splitlines() if WARNING in ln]
    assert len(warned) == 1, err
    assert reason in warned[0]
    assert got == codec_bytes


def test_compiler_error_names_the_compilers_error_line(monkeypatch, tmp_path):
    if native._cc() is None:
        pytest.skip("no cc here")
    _compiler_error(monkeypatch, tmp_path)
    with pytest.raises(OSError, match=r"bad\.c.*error"):
        native.build()
    assert not any((tmp_path / "build").iterdir())  # no library, no scratch left


def test_a_built_codec_says_nothing(codec_bytes, tmp_path, capsys):
    native._library.cache_clear()
    capsys.readouterr()
    assert _write_all(tmp_path, tmp_path / "deck.dat") == codec_bytes
    assert WARNING not in capsys.readouterr().err
