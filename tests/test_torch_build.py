"""The ctypes signatures in ``repro_torch/kernels/build.py`` against the C
entry points of ``repro_torch/csrc/*.cu``.

ctypes passes an argument by the class ``build.SIGNATURES`` gives it: a
pointer declared ``c_int`` is cut to 32 bits, and a missing or extra
argument shifts every one after it, with no error at the call. Each
``extern "C"`` function is parsed from its source, and its parameter list
is held to its entry: the count, and each parameter's class (a pointer ->
``c_void_p``, ``long long`` -> ``c_longlong``, ``int`` -> ``c_int``,
``float`` -> ``c_float``). Runs on the CPU: it reads the sources, it
builds nothing.
"""
import ctypes
import re

import pytest

from repro_torch.kernels import build

CLASS_OF = {"long long": ctypes.c_longlong, "int": ctypes.c_int,
            "float": ctypes.c_float}
FUNCS = [(stem, name) for stem, fns in sorted(build.SIGNATURES.items())
         for name in sorted(fns)]


def _extern_c(stem):
    """{name: (return type, [parameter declarations])} of the functions
    in the ``extern "C" { ... }`` block of ``csrc/<stem>.cu``."""
    src = (build.CSRC / f"{stem}.cu").read_text()
    src = re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)
    start = src.index('extern "C" {') + len('extern "C" {')
    block = src[start:]
    out = {}
    for m in re.finditer(r"(\w+)\s+(\w+)\s*\(([^)]*)\)\s*\{", block):
        params = [" ".join(p.split()) for p in m.group(3).split(",")]
        out[m.group(2)] = (m.group(1), [p for p in params if p])
    return out


def _ctype(decl):
    """The ctypes class a C parameter declaration needs."""
    if "*" in decl:
        return ctypes.c_void_p
    base = re.sub(r"\b(const|unsigned)\b", "", decl).split()
    base = " ".join(base[:-1])               # drop the parameter name
    if base not in CLASS_OF:
        raise AssertionError(f"no ctypes class for C parameter {decl!r}")
    return CLASS_OF[base]


@pytest.mark.parametrize("stem", sorted(build.SIGNATURES))
def test_every_extern_c_function_has_a_signature(stem):
    """Each source's C entry points are exactly the names its
    ``SIGNATURES`` entry lists, and each returns the ``int`` error code
    ``build.load`` declares."""
    funcs = _extern_c(stem)
    assert sorted(funcs) == sorted(build.SIGNATURES[stem])
    assert {ret for ret, _ in funcs.values()} == {"int"}


@pytest.mark.parametrize("stem,name", FUNCS,
                         ids=[f"{s}.{n}" for s, n in FUNCS])
def test_signature_matches_the_c_parameters(stem, name):
    _, params = _extern_c(stem)[name]
    want = [_ctype(p) for p in params]
    got = build.SIGNATURES[stem][name]
    assert len(got) == len(want), (name, len(got), len(want))
    for i, (g, w, decl) in enumerate(zip(got, want, params)):
        assert g is w, f"{name} parameter {i} ({decl}): {g.__name__}, " \
                       f"needs {w.__name__}"


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """A library's file name hashes its source and every header it
    includes, directly or through another header, so an edited header
    rebuilds each source that includes it; an unrelated file does not."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <math.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// other\n")
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = build._lib_path("k")
    (tmp_path / "other.cuh").write_text("// other, edited\n")
    assert build._lib_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = build._lib_path("k")
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// a\n')
    assert build._lib_path("k") not in (first, second)


def test_the_sm90_sources_share_one_header():
    """Both tensor-core sources include the shared helpers, so the hash
    of each covers them."""
    for stem in ("flash_attention_sm90", "cascade_phase1_sm90"):
        assert "sm90_common.cuh" in [p.name for p in build.sources(stem)]


def test_the_parser_sees_every_parameter_kind():
    """The parse is not vacuous: across the sources it finds pointers,
    ``long long``, ``int`` and ``float`` parameters, and the one stream."""
    kinds = set()
    for stem, name in FUNCS:
        params = _extern_c(stem)[name][1]
        kinds |= {_ctype(p) for p in params}
        assert params[-1].replace(" ", "") == "void*stream"
    assert kinds == {ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_float}
