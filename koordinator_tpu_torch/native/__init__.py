"""Native (C++) components and their ctypes bindings.

The reference's only native code is the cgo+libpfm4 perf-group CPI reader
(pkg/koordlet/util/perf_group/perf_group_linux.go); here it is a small
C++ shared library (perf_group.cpp) built on demand with g++ and bound
via ctypes — no pybind11 required.

Counterpart of ``koordinator_tpu/native/__init__.py``: host work, bit
for bit the reference's.
"""

from koordinator_tpu_torch.native.perf import (  # noqa: F401
    PerfGroup,
    PerfUnavailable,
    ensure_built,
)
