"""Builds a kernel's CUDA source for the CPU against the stand-in in
`qtos_torch/csrc/emu/`, with the host compiler's command that
`qtos_torch.ops.cuda_lib.Kernel.cxx_argv` gives for the kernel."""

import subprocess

import pytest

from qtos_torch.ops import cuda_lib


def build(kernel: cuda_lib.Kernel, entry, out, defines=(), opt="-O2", include=cuda_lib.EMU_DIR) -> str:
    """Builds the stand-in's `entry` (a `*_emu.cpp`, which includes the
    kernel's source) into `out`; returns its path.  Skips without g++."""
    cxx = cuda_lib.host_cxx()
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the kernel's source for the CPU")
    subprocess.run(kernel.cxx_argv(cxx, entry, out, defines, opt, include),
                   check=True, capture_output=True, text=True, timeout=300)
    return str(out)
