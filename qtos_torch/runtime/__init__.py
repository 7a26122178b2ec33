"""Native host runtime: C++ A* and trajectory ring buffer with ctypes
bindings (python fallbacks when the toolchain is unavailable)."""

from qtos_torch.runtime.bindings import RingBuffer, native_astar, native_available  # noqa: F401
