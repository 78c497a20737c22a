"""The ctypes signatures of ``ops/_build.py`` against the C entry points of
``csrc/*.cu``: a missing argtype makes ctypes pass the next argument (the
stream pointer) as a 32-bit int, which only fails on the card."""

import re

import pytest

from dwarf_bench_tpu_torch.ops import _build

_ENTRY = re.compile(r'extern "C" [\w\s\*]+?\b(dbt_\w+)\(([^)]*)\)', re.S)


def _entry_points():
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for name, params in _ENTRY.findall(path.read_text()):
            params = params.strip()
            found[name] = 0 if params in ("", "void") else \
                params.count(",") + 1
    return found


def test_every_entry_point_has_a_signature():
    assert set(_entry_points()) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_counts_every_parameter(name):
    assert len(_build._SIGNATURES[name][0]) == _entry_points()[name]
