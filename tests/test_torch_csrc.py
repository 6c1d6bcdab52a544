"""The C entry points of fspt_tpu_torch/csrc/ against the ctypes
declarations that their loaders hand ops/_build.py `load`.

ctypes passes what it is told: an int where the C side takes a pointer, or
one argument too few, reaches the card as garbage, and the kernels are built
only where there is a card.  So each entry point's `extern "C"` signature,
read from its source, must match its declaration parameter by parameter: a
pointer for a pointer (c_void_p or a POINTER type), and for a scalar the
ctypes type of its C type.  The loaders run here against a stand-in for the
library: nothing is built.
"""

import ctypes
import glob
import os
import re

import pytest

from fspt_tpu_torch.ops import _build

# the C scalar types of the entry points' parameters
SCALARS = {"int": ctypes.c_int, "unsigned int": ctypes.c_uint,
           "long long": ctypes.c_longlong}
ENTRY_POINTS = ["fspt_traverse4", "fspt_walk3", "fspt_walk1",
                "fspt_walk1_geometry", "fspt_walk5", "fspt_walk5_geometry",
                "fspt_dense_mt", "fspt_micro", "fspt_pcg4d_uniforms"]


def _loaders():
    """Every function of the package that loads a kernel library."""
    from fspt_tpu_torch.ops.pcg4d import load_pcg4d
    from fspt_tpu_torch.ops.traverse import kernel_geometry, load_walk1
    from fspt_tpu_torch.ops.traverse3 import load_walk
    from fspt_tpu_torch.ops.traverse4 import load_traverse4
    from fspt_tpu_torch.scripts.perf_r5_treelet import load_dense_mt
    from fspt_tpu_torch.scripts.perf_r5d import load_micro
    from fspt_tpu_torch.scripts.traverse5_proto import (load_walk5,
                                                        walk5_kernel_geometry)
    return [load_traverse4, load_walk, load_walk1, lambda: kernel_geometry(1),
            load_walk5, lambda: walk5_kernel_geometry(1), load_dense_mt,
            load_micro, load_pcg4d]


@pytest.fixture(scope="module")
def declared():
    """[(source, {function: argtypes})] of every call the loaders make to
    `_build.load`."""
    class Library:
        def __getattr__(self, name):
            return lambda *args: 0

    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "load", lambda name, argtypes: (
            calls.append((name, dict(argtypes))), Library())[1])
        for load in _loaders():
            load()
    return calls


@pytest.fixture(scope="module")
def exported():
    """{function: (source, [C parameter types])} of the `extern "C"`
    functions of every csrc/*.cu but `fspt_cuda_error_string`, which every
    source exports and `_build.load` declares."""
    out = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu"))):
        source = os.path.basename(path)[:-3]
        with open(path) as f:
            text = f.read()
        block = text[text.index('extern "C" {'):]
        for m in re.finditer(r"^(?:int|const char\*) (fspt_\w+)\(([^)]*)\)",
                             block, re.M):
            params = [re.fullmatch(r"(.*?)\s*\w+", p.strip()).group(1)
                      for p in m.group(2).split(",")]
            if m.group(1) != "fspt_cuda_error_string":
                assert m.group(1) not in out, m.group(1)
                out[m.group(1)] = (source, params)
    return out


def _matches(c_type, ctype):
    if "*" in c_type:
        return ctype is ctypes.c_void_p or issubclass(ctype, ctypes._Pointer)
    return SCALARS[c_type.replace("const ", "")] is ctype


@pytest.mark.parametrize("fn", ENTRY_POINTS)
def test_entry_point_matches_its_declaration(declared, exported, fn):
    source, params = exported[fn]
    (argtypes,) = [types[fn] for name, types in declared if fn in types
                   and name == source]
    assert len(argtypes) == len(params), (fn, len(argtypes), len(params))
    for i, (c_type, ctype) in enumerate(zip(params, argtypes)):
        assert _matches(c_type, ctype), (fn, i, c_type, ctype)


def test_every_source_built_and_every_entry_point_declared_once(declared,
                                                                exported):
    sources = {os.path.basename(p)[:-3]
               for p in glob.glob(os.path.join(_build.CSRC, "*.cu"))}
    assert {name for name, _ in declared} == sources
    functions = [fn for _, types in declared for fn in types]
    assert sorted(functions) == sorted(exported)
