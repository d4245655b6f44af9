"""`ops._build.build_shared` names each library after its source, the
headers that source includes and the flags, so that an edited header
builds anew instead of loading a stale library from ``build/``.

It builds a small C++ source with g++ (no nvcc needed) into a temporary
build directory, edits the header it includes, and builds again.
"""

import ctypes

from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

from zelll_tpu_torch.ops import _build


def test_header_edit_builds_anew(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    header = csrc / "value.cuh"
    header.write_text("#pragma once\nconstexpr int kValue = 1;\n")
    src = csrc / "probe.cpp"
    src.write_text('#include <cstdint>\n#include "value.cuh"\n\n'
                   'extern "C" int probe_value() { return kValue; }\n')
    assert _build.sources(src) == [src, header]

    first, _ = _build.build_shared(src, "g++", _build.GXX_FLAGS, "probe")
    assert ctypes.CDLL(str(first)).probe_value() == 1
    assert _build.build_shared(src, "g++", _build.GXX_FLAGS, "probe")[0] == first

    header.write_text("#pragma once\nconstexpr int kValue = 2;\n")
    second, _ = _build.build_shared(src, "g++", _build.GXX_FLAGS, "probe")
    assert second != first
    assert ctypes.CDLL(str(second)).probe_value() == 2
