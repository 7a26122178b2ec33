"""The build-and-load seam of the hand kernels (`qtos_torch/ops/cuda_lib.py`)
and the card tools' core (`qtos_torch/tools/kit.py`), on the CPU.  Each
kernel's nvcc argv is held token for token to its wrapper's before the seam
(the last field of a `KERNELS` row: whether it had `--fmad=false`), and its
cache name to the form libraries built before it have."""

import hashlib
import os
import pathlib
import sys
import threading
import time

import pytest

from qtos_torch.ops import assemble, btd, cuda_lib, lm_restore, tick
from qtos_torch.tools import kit, tick_floor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (declaration, library stem, source in the repo, built with --fmad=false)
KERNELS = {
    "btd": (btd.KERNEL, "libqtos_btd", "qtos_torch/csrc/btd.cu", False),
    "tick": (tick.KERNEL, "libqtos_tick", "qtos_torch/csrc/tick.cu", True),
    "assemble": (assemble.KERNEL, "libqtos_assemble", "qtos_torch/csrc/assemble.cu", True),
    "lm_restore": (lm_restore.KERNEL, "libqtos_lm_restore", "qtos_torch/csrc/lm_restore.cu", True),
    "op_cycles": (tick_floor.PROBE, "libqtos_op_cycles", "qtos_torch/tools/op_cycles.cu", True),
}


@pytest.fixture
def fake_nvcc(monkeypatch):
    monkeypatch.setattr(cuda_lib, "nvcc", lambda: "nvcc")


@pytest.mark.parametrize("name", list(KERNELS))
@pytest.mark.parametrize("verbose", [False, True])
def test_nvcc_command_is_the_wrappers_before(fake_nvcc, name, verbose):
    kernel, _, source, fmad = KERNELS[name]
    assert kernel.source == os.path.join(REPO, source)
    assert kernel.nvcc_argv("OUT", verbose=verbose) == (
        ["nvcc"] + ["-Xptxas", "-v"] * verbose + ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
        + ["--fmad=false"] * fmad + ["-shared", "-Xcompiler", "-fPIC", "-o", "OUT", kernel.source])
    assert kernel.nvcc_argv("OUT", source="v.cu")[-1] == "v.cu"


@pytest.mark.parametrize("name", list(KERNELS))
def test_cache_name_keeps_its_form(name):
    kernel, stem, _, _ = KERNELS[name]
    with open(kernel.source, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    assert cuda_lib.cache_path(kernel.source, kernel.stem) == os.path.join(
        REPO, "qtos_torch", "_build", f"{stem}_{tag}.so")


@pytest.mark.parametrize("name", list(KERNELS))
def test_stand_in_command_contracts_as_the_card_build(name):
    kernel, fmad = KERNELS[name][0], KERNELS[name][3]
    common = ["-pthread", "-shared", "-fPIC", "-Wno-unknown-pragmas"]
    assert kernel.cxx_argv("g++", "e.cpp", "o.so") == (
        ["g++", "-std=c++17", "-O2"] + ["-ffp-contract=off"] * fmad + common
        + ["-I", cuda_lib.EMU_DIR, "-o", "o.so", "e.cpp"])
    assert kernel.cxx_argv("g++", "e.cpp", "o.so", ["-DX=1"], "-O1", "inc") == (
        ["g++", "-std=c++17", "-O1"] + ["-ffp-contract=off"] * fmad + common
        + ["-DX=1", "-I", "inc", "-o", "o.so", "e.cpp"])


def _tmp_kernel(tmp_path, monkeypatch, load_library=lambda path: path):
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path / "_build"))
    (tmp_path / "k.cu").write_text("// a kernel\n")
    return cuda_lib.Kernel(str(tmp_path / "k.cu"), "libqtos_k", load_library, flags=("--fmad=false",))


def test_build_compiles_once_through_a_temporary_file(tmp_path, monkeypatch, fake_nvcc):
    """nvcc writes a temporary file, moved onto the cache name once it
    succeeded; a cached library is not built again; a failure leaves no
    library and raises with the compiler's output."""
    kernel = _tmp_kernel(tmp_path, monkeypatch)
    out = cuda_lib.cache_path(kernel.source, kernel.stem)
    runs = []

    def run(argv, **kw):
        runs.append(argv)
        assert argv[:-3] == kernel.nvcc_argv("x")[:-3] and argv[-2].endswith(".tmp") and not os.path.exists(out)
        open(argv[-2], "w").close()
        return cuda_lib.subprocess.CompletedProcess(argv, 0, "", "")

    monkeypatch.setattr(cuda_lib.subprocess, "run", run)
    assert kernel.build() == out and kernel.build() == out and len(runs) == 1
    assert os.listdir(os.path.dirname(out)) == [os.path.basename(out)]
    os.remove(out)
    monkeypatch.setattr(cuda_lib.subprocess, "run", lambda argv, **kw: cuda_lib.subprocess.CompletedProcess(
        argv, 2, "out", "err"))
    with pytest.raises(RuntimeError, match=r"nvcc failed \(2\):\nout\nerr"):
        kernel.build()
    assert not os.path.exists(out)


def test_load_builds_and_loads_once(tmp_path, monkeypatch):
    """The lazy load of a kernel's library, from more threads than cores at
    once and with the interpreter switching threads often: one build, one
    load, one library for every caller."""
    calls = []
    kernel = _tmp_kernel(tmp_path, monkeypatch, load_library=lambda path: calls.append(path) or object())
    monkeypatch.setattr(cuda_lib.Kernel, "build", lambda self: time.sleep(0.01) or "lib.so")
    got = []
    threads = [threading.Thread(target=lambda: got.append(kernel.load())) for _ in range(4 * (os.cpu_count() or 1))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert calls == ["lib.so"] and len(got) == len(threads) and all(g is got[0] for g in got)


REPORT = """ptxas info    : Compiling entry function '_Z10btd_kernelPKf' for 'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z16btd_small_kernelPKf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers
"""


@pytest.mark.parametrize("kernel,want", [("btd_kernel", (96, 8)), ("btd_small_kernel", (128, 0)),
                                         ("tick_kernel", (None, None))])
def test_ptxas_report_parse(kernel, want):
    assert cuda_lib.ptxas_registers(REPORT, kernel) == want


def test_versions_are_copies_and_ablations(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("a = 1;\nb = 2;\nc = 3;\n")
    paths = kit.sources([f"cur={src}", f"no_b={src}!^b", "two=no_b!= \\d!= 9"], str(tmp_path))
    assert paths["cur"] == str(src)
    assert [pathlib.Path(paths[k]).read_text() for k in ("no_b", "two")] == ["a = 1;\nc = 3;\n", "a = 9;\nc = 9;\n"]


def test_card_raises_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvidia-smi failed"):
        kit.card()
