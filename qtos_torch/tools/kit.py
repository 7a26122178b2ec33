"""The common core of the card tools (`qtos_torch/tools/`, `chip_smoke.py`,
`bench_torch.py`, `scripts/main_torch.py`).

A version of a kernel's source is `NAME=PATH[!REGEX[!TEXT]]`: PATH, or with
`!REGEX` a copy without the lines matching REGEX, or with `!REGEX!TEXT` one
in which each match is replaced by TEXT (an ablation: its answers are wrong,
its time says what the removed work costs).  PATH may name an earlier
version.  A version must have its kernel's current C entry points: the
tools load it with the wrapper's own `load_library`.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import time
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from qtos_torch.ops import cuda_lib


def sources(specs: list, out_dir: str) -> dict:
    """NAME -> path of each version's source (`NAME=PATH[!REGEX[!TEXT]]`),
    edited copies written to `out_dir`."""
    paths = {}
    for spec in specs:
        name, _, rest = spec.partition("=")
        src, *edit = rest.split("!", 2)
        src = paths.get(src, src)
        if edit:
            pattern = re.compile(edit[0])
            with open(src) as f:
                lines = f.readlines()
            if len(edit) == 1:
                lines = [line for line in lines if not pattern.search(line)]
            else:
                lines = [pattern.sub(lambda _: edit[1], line) for line in lines]
            src = os.path.join(out_dir, f"{name}.cu")
            with open(src, "w") as f:
                f.writelines(lines)
        paths[name] = src
    return paths


def build_version(kernel: cuda_lib.Kernel, name: str, src: str, out_dir: str) -> tuple:
    """Builds the version `src` with `kernel`'s flags and `-Xptxas -v` into
    `out_dir`; returns (library path, report lines): ptxas's registers, stack
    frame and spills and, where the toolkit has `cuobjdump`, each kernel's
    SASS instructions and local-memory instructions (LDL, STL)."""
    out = os.path.join(out_dir, f"lib_{name}.so")
    proc = subprocess.run(kernel.nvcc_argv(out, source=src, verbose=True), capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    report = [f"{name}: " + line.strip() for line in (proc.stdout + proc.stderr).splitlines()
              if re.search(r"Compiling entry|registers|stack frame", line)]
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(cuda_lib.nvcc()), "cuobjdump")
    if os.path.exists(tool):
        sass = subprocess.run([tool, "-sass", out], capture_output=True, text=True).stdout
        for part in sass.split("Function : ")[1:]:
            fn = part.split("\n", 1)[0].strip()
            ldl = len(re.findall(r"\bLDL\b", part))
            stl = len(re.findall(r"\bSTL\b", part))
            instr = len(re.findall(r"/\*[0-9a-f]{4,}\*/", part))
            report.append(f"{name}: SASS {fn}: {instr} instructions, {ldl} LDL, {stl} STL")
    else:
        report.append(f"{name}: no cuobjdump in the toolkit: local-memory instructions not counted")
    return out, report


def event_ms(fn, reps: int) -> float:
    """ms per call of `fn` over `reps` calls after a warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_ms_calls(fn, reps: int) -> list:
    """ms of each of `reps` calls after a warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def synced(dev) -> float:
    """The host clock once the device has drained its queue."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def card(fields=("name", "power.limit"), index=None, units: bool = True) -> str:
    """The card's `fields` (of `nvidia-smi --query-gpu`) as nvidia-smi
    prints them, comma-separated: card `index`, or the first.  Raises
    RuntimeError when nvidia-smi cannot be run or fails."""
    argv = ["nvidia-smi", f"--query-gpu={','.join(fields)}", "--format=csv,noheader" + ("" if units else ",nounits")]
    if index is not None:
        argv += ["-i", str(index)]
    try:
        proc = subprocess.run(argv, capture_output=True, text=True, timeout=60, check=True)
        return proc.stdout.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        raise RuntimeError(f"nvidia-smi failed: {getattr(e, 'stderr', None) or e}") from e


class CountOps(TorchDispatchMode):
    """Counts the aten operations dispatched inside it, by name (views
    included)."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def function_body(text: str, name: str) -> str:
    """The body of the function `name` (a `DEV`, `__device__` or
    `__global__` function, or a kernel whose name starts its line) of the
    CUDA source `text`, without its comments."""
    m = re.search(r"^(?:DEV|__global__|__device__)\b[^;{]*?\b" + re.escape(name) + r"\(", text, re.M)
    if m is None:
        m = re.search(r"^" + re.escape(name) + r"\(", text, re.M)
    if m is None:
        raise KeyError(f"no function {name} in the source")
    start = re.compile(r"\)\s*\{").search(text, m.end()).end() - 1  # past a default argument's braces
    depth = 0
    for i in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return re.sub(r"//[^\n]*", "", text[start:i + 1])
    raise ValueError(f"the body of {name} does not end")
