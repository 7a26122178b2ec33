"""How a hand-written kernel's CUDA source becomes a loaded library.

Each kernel is one `Kernel` declared beside its wrapper: its source, the
stem of its library's name, its `load_library(path)` (the C entry points'
argument types) and the nvcc flags it adds (README.md's table).  This module
alone knows the rest: the build directory, where nvcc is, the common nvcc
argv, the cache name `{stem}_{sha256 of the source[:16]}.so` and its atomic
write, the lazy locked load, the parse of ptxas's report, the registry of
the wrappers' launch counters, and the CPU stand-in's g++ argv, with
`-ffp-contract=off` exactly where nvcc has `--fmad=false`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Callable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
EMU_DIR = os.path.join(PKG_DIR, "csrc", "emu")


def csrc(name: str) -> str:
    """The path of the kernel source `name` in `qtos_torch/csrc/`."""
    return os.path.join(PKG_DIR, "csrc", name)


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def host_cxx() -> str | None:
    """The host C++ compiler, or None where there is none."""
    return shutil.which("g++") or shutil.which("c++")


def cache_path(source: str, stem: str) -> str:
    """Where the library of `source` named from `stem` lives in the build
    directory (whether or not it is built yet)."""
    with open(source, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{stem}_{tag}.so")


def compile_to(out: str, argv_of: Callable[[str], list], timeout: float | None = None):
    """Runs the compiler command `argv_of(tmp)` and moves the file `tmp` onto
    `out` in one step, so that no process loads a half-written library.
    Returns the process; raises RuntimeError with its output on failure."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    argv = argv_of(tmp)
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(argv[0])} failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return proc


def ptxas_registers(report: str, kernel: str) -> tuple:
    """(registers, spill store bytes) of the kernel whose entry name holds
    `kernel` in nvcc's `-Xptxas -v` report; (None, None) where it is not
    there."""
    m = re.search(r"Compiling entry function '[^']*" + kernel + r"[^']*'.*?(\d+) bytes spill stores.*?"
                  r"Used (\d+) registers", report, re.S)
    return (int(m.group(2)), int(m.group(1))) if m else (None, None)


# (wrapper, attribute) of every hand kernel's launch counter, registered by
# `count_launches` where the wrapper is declared.
LAUNCH_COUNTERS: list = []


def count_launches(wrapper, *names: str):
    """Sets the launch counters `wrapper.<name>` to 0 and registers them in
    `LAUNCH_COUNTERS`, where a CUDA graph finds every counter its capture
    moved (`control/graphs.py`) with no list of its own."""
    for name in names:
        setattr(wrapper, name, 0)
        if (wrapper, name) not in LAUNCH_COUNTERS:
            LAUNCH_COUNTERS.append((wrapper, name))


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A CUDA source, the stem of its library's name, the nvcc flags it adds
    to the common ones, and `load_library(path)`, which opens a library of
    the source (the card's build or the stand-in's) with its entry points'
    argument types set."""

    source: str
    stem: str
    load_library: Callable
    flags: tuple = ()
    _loaded: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock, init=False, repr=False,
                                              compare=False)

    def nvcc_argv(self, out: str, source: str | None = None, verbose: bool = False) -> list:
        """The nvcc command that builds `source` (default: the kernel's own)
        into the shared library `out` with the kernel's flags."""
        return [nvcc(), *(["-Xptxas", "-v"] if verbose else []), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", *self.flags, "-shared", "-Xcompiler", "-fPIC", "-o", out,
                source or self.source]

    def cxx_argv(self, cxx: str, entry: str, out: str, defines=(), opt: str = "-O2",
                 include: str = EMU_DIR) -> list:
        """The host compiler's command that builds the stand-in's `entry` (a
        `csrc/emu/*_emu.cpp`, which includes the CUDA source) against the
        headers in `include` into `out`, with a test's `defines` and `opt`."""
        contract = ["-ffp-contract=off"] if "--fmad=false" in self.flags else []
        return [cxx, "-std=c++17", opt, *contract, "-pthread", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                *defines, "-I", include, "-o", str(out), str(entry)]

    def build(self, verbose: bool = False, source: str | None = None) -> str:
        """Compile the kernel's source (or another `source` with its flags)
        into the build directory, if not built yet, and return the library's
        path.  ``verbose`` builds again with ``-Xptxas -v`` and prints its
        report."""
        source = source or self.source
        out = cache_path(source, self.stem)
        if os.path.exists(out) and not verbose:
            return out
        proc = compile_to(out, lambda tmp: self.nvcc_argv(tmp, source, verbose))
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        return out

    def load(self):
        """The library of the kernel's own source, built and loaded once."""
        with self._lock:
            if "lib" not in self._loaded:
                self._loaded["lib"] = self.load_library(self.build())
            return self._loaded["lib"]
