"""The C entries of the port's CUDA sources against the argument types that
``ops/_build.bind`` declares for them, read without nvcc and without
loading the library.

ctypes passes each argument as its declared type: a pointer declared as an
int is cut to 32 bits and a missing argument shifts every later one, and
either shows only on the card.  So each ``extern "C"`` entry of
``csrc/*.cu`` is parsed from the source and its parameters (a pointer, an
``int``, a ``long long`` or a ``float``) are held to ``bind``'s argtypes,
one by one.
"""

import ctypes
import re
import types

import pytest

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu_torch.ops import _build


ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _c_type(param: str):
    """The ctypes type a C parameter is passed as."""
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    kind = decl.rsplit(" ", 1)[0].replace("const ", "")
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}[kind]


def _entries() -> dict:
    """name -> the ctypes types of its parameters, from every source."""
    out = {}
    for name in _build.SOURCES:
        text = (_build.CSRC / name).read_text()
        for m in ENTRY.finditer(text):
            out[m.group(1)] = [_c_type(p) for p in m.group(2).split(",")]
    return out


class _Library:
    """What ``bind`` sees of a library: an object per entry it names."""

    def __getattr__(self, name):
        entry = types.SimpleNamespace(argtypes=None, restype=None)
        setattr(self, name, entry)
        return entry


SOURCE_ENTRIES = _entries()


def _bound() -> _Library:
    return _build.bind(_Library())


def test_every_entry_is_bound_and_every_binding_has_an_entry():
    bound = {n for n, v in vars(_bound()).items()
             if isinstance(v, types.SimpleNamespace)}
    assert set(SOURCE_ENTRIES) == bound


@pytest.mark.parametrize("name", sorted(SOURCE_ENTRIES))
def test_argtypes_match_the_c_signature(name):
    entry = getattr(_bound(), name)
    assert entry.restype is ctypes.c_int
    assert entry.argtypes == SOURCE_ENTRIES[name]
