"""The ctypes signatures of ``ops/_build.py`` against the C entry points of
``csrc/*.cu``: a missing argtype makes ctypes pass the next argument (the
stream pointer) as a 32-bit int, which only fails on the card."""

import ctypes
import re
import sys

import pytest

pytest.importorskip("torch")

from dwarf_bench_tpu_torch.ops import _build

_ENTRY = re.compile(r'extern "C" [\w\s\*]+?\b(dbt_\w+)\(([^)]*)\)', re.S)


def _params():
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for name, params in _ENTRY.findall(path.read_text()):
            params = params.strip()
            found[name] = [] if params in ("", "void") else \
                [p.strip() for p in params.split(",")]
    return found


def _entry_points():
    return {name: len(params) for name, params in _params().items()}


def test_every_entry_point_has_a_signature():
    assert set(_entry_points()) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_counts_every_parameter(name):
    assert len(_build._SIGNATURES[name][0]) == _entry_points()[name]


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_pointers_and_the_stream_are_void_pointers(name):
    """Every pointer parameter, the trailing stream included, is a
    c_void_p, and every int64_t a c_int64."""
    for param, argtype in zip(_params()[name], _build._SIGNATURES[name][0]):
        if "*" in param:
            assert argtype is ctypes.c_void_p, (name, param)
        elif param.startswith("int64_t"):
            assert argtype is ctypes.c_int64, (name, param)


def _fake_nvcc(tmp_path, fail_on=None):
    """An nvcc stand-in that logs its arguments and writes its -o file, or
    fails for the source named ``fail_on``."""
    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        f"open({str(log)!r}, 'a').write(' '.join(args) + '\\n')\n"
        f"if {fail_on!r} and args[-1].endswith({fail_on!r}):\n"
        "    print('error: no such luck'); sys.exit(2)\n"
        "open(args[args.index('-o') + 1], 'w').write('x')\n"
    )
    fake.chmod(0o755)
    return fake, log


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    fake, log = _fake_nvcc(tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build_seconds", None)
    target = _build.build()
    assert target.exists() and target.parent == tmp_path / "build"
    calls = log.read_text().splitlines()
    units = sorted(str(p) for p in _build.CSRC.glob("*.cu"))
    compiles = [c.split() for c in calls if " -c " in c]
    assert sorted(c[-1] for c in compiles) == units
    assert len(calls) == len(units) + 1
    assert "-shared" in calls[-1].split() and " -c " not in calls[-1]
    assert sorted((tmp_path / "build").iterdir()) == [target]
    assert _build.build() == target  # cached: nvcc is not called again
    assert len(log.read_text().splitlines()) == len(calls)


def test_build_failure_raises_with_nvcc_output(tmp_path, monkeypatch):
    fake, _ = _fake_nvcc(tmp_path, fail_on="vadd.cu")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)vadd.cu.*no such luck"):
        _build.build()
    assert list((tmp_path / "build").iterdir()) == []
