"""The tick kernel's design floor: the least time its dependent chain can
take, from the latencies of the chain's operations as a small probe measures
them on the card and the chain's operations as `qtos_torch/csrc/tick.cu`
computes them.

A tick's values feed the next tick's, but nothing holds one tick's work back
until the whole tick before it is done: only its inputs must be ready.  So
the floor of a recurrence is the largest mean over its loop-carried cycles:
a cycle leaves a carried value, runs through one or more ticks and comes
back to it, and its mean is its latency over the ticks it spans.  The floor
of T ticks is T times that mean.

The paths are counted by hand from the source, as the functions of tick.cu
they run through and the operations they take in each.  `SOURCE_CALLS`
records the calls of the counted operations that each of those functions
holds (`source_calls` reads them from the source), and
`tests/test_torch_tick_floor.py` holds it to tick.cu: an edit that adds or
removes one fails there until the paths are counted again.  The simple
operations (adds, products, comparisons, selects, conversions) are counted
by hand only.

The probe, `op_cycles.cu` beside this module, is built with the kernel's own
nvcc flags into `qtos_torch/_build/`; `op_cycles` runs it on the card.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess

from qtos_torch.ops import tick

PROBE_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "op_cycles.cu")
# The operations of the probe, in its order.
OPS = ("fadd", "fmul", "div", "sqrt", "sin", "cos", "atan2", "acos", "shfl", "load")
# The calls in tick.cu that stand for an operation of `OPS` ("/" a division).
CALLS = {"sinf": "sin", "cosf": "cos", "atan2f": "atan2", "acosf": "acos", "sqrtf": "sqrt",
         "__shfl_sync": "shfl", "/": "div"}

# Dependent paths through one tick of the chain in the hybrid frame with the
# force feed-forward (the runner's controller), each from a carried value to
# the value the next tick reads: (function of tick.cu, its operations on the
# path).  "simple" is an add, product, comparison, select or conversion, at
# the slower of fadd and fmul; "acos" the arccosine with the product after
# it; of a sine and a cosine of one argument the path takes the cosine.
PATHS = {
    # the yaw of R -> the yaw error, its filter -> the foot's target -> IK ->
    # PD -> the joint update
    "quat -> q": (
        ("quat_to_rot", dict(simple=9, div=1)),       # |q|^2, 2 / |q|^2, x x s, 1 - (yy + zz)
        ("rot_to_euler", dict(atan2=1)),              # the yaw
        ("controller", dict(simple=15, cos=2, atan2=1)),  # yaw error, filter, clamp, cos(yawc) - 1, rotz_delta,
                                                      # delta, the correction's filter, target
        ("leg_ik", dict(simple=16, div=1, sqrt=1, acos=1, cos=2, atan2=2)),  # zeta, c2, q2, k1, q1
        ("pd_torque", dict(simple=6)),
        ("step", dict(simple=6, div=1)),              # qdd, qd, q
    ),
    # the leg's FK -> the world foot -> its terrain height -> contact -> the
    # moment, shuffled and summed -> w -> the quaternion's step
    "q -> quat": (
        ("leg_fk", dict(simple=5, cos=1)),            # cos(q1 + q2), z, f[1]
        ("leg_kinematics", dict(simple=5)),           # feet_b, arm_w, feet_w
        ("height_at", dict(simple=15, div=1, load=1)),
        ("step", dict(simple=23, div=2, shfl=1)),     # contact force, its moment, T, wd, w
        ("norm3", dict(simple=3, sqrt=1)),            # |w|
        ("quat_integrate", dict(simple=11, div=1, sqrt=1, cos=1)),  # half, cos, x1, product, norm, q / n
    ),
    # R -> the lever arm -> the world foot -> ... as "q -> quat"
    "quat -> quat": (
        ("quat_to_rot", dict(simple=9, div=1)),
        ("leg_kinematics", dict(simple=4)),           # arm_w, feet_w
        ("height_at", dict(simple=15, div=1, load=1)),
        ("step", dict(simple=23, div=2, shfl=1)),
        ("norm3", dict(simple=3, sqrt=1)),
        ("quat_integrate", dict(simple=11, div=1, sqrt=1, cos=1)),
    ),
    # the leg's FK -> contact -> its reaction on the joints -> the joint update
    "q -> q": (
        ("leg_fk", dict(simple=5, cos=1)),
        ("leg_kinematics", dict(simple=5)),
        ("height_at", dict(simple=15, div=1, load=1)),
        ("step", dict(simple=24, div=3)),             # contact force, fb, tc, qdd, qd, q
    ),
}
# The loop-carried cycles: the paths each runs through, one per tick.  The
# yaw reaches the joints in one tick and the joints the quaternion in the
# next; the other carried values (pos, v, w, qd, the anchors and filters)
# close shorter cycles through the same functions.
CYCLES = {
    "quat -> q -> quat": ("quat -> q", "q -> quat"),
    "quat -> quat": ("quat -> quat",),
    "q -> q": ("q -> q",),
}
# The calls of `CALLS` in each function the paths run through, as tick.cu
# holds them.
SOURCE_CALLS = {
    "quat_to_rot": dict(div=1),
    "rot_to_euler": dict(atan2=3, sqrt=1),
    "controller": dict(sin=3, cos=3, atan2=1),
    "leg_ik": dict(sin=3, cos=3, atan2=6, acos=1, sqrt=1, div=1),
    "pd_torque": dict(),
    "step": dict(sqrt=1, shfl=2, div=6),
    "leg_fk": dict(sin=3, cos=3),
    "leg_kinematics": dict(),
    "height_at": dict(div=2),
    "norm3": dict(sqrt=1),
    "quat_integrate": dict(sin=1, cos=1, sqrt=1, div=4),
}


def function_body(text: str, name: str) -> str:
    """The body of the device function `name` in the CUDA source `text`,
    without its comments."""
    m = re.search(r"^DEV\b[^;{]*?\b" + re.escape(name) + r"\(", text, re.M)
    if m is None:
        raise KeyError(f"no device function {name} in the source")
    start = text.index("{", m.end())
    depth = 0
    for i in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return re.sub(r"//[^\n]*", "", text[start:i + 1])
    raise ValueError(f"the body of {name} does not end")


def source_calls(text: str, name: str) -> dict:
    """The calls of `CALLS` in the device function `name` of `text`, by the
    operation each stands for."""
    body = function_body(text, name)
    counts = {}
    for call, op in CALLS.items():
        n = body.count("/") if call == "/" else len(re.findall(r"\b" + re.escape(call) + r"\(", body))
        if n:
            counts[op] = n
    return counts


def path_ops(path: str) -> dict:
    """The operations of one of `PATHS`, summed over its functions."""
    total = {}
    for _, ops in PATHS[path]:
        for op, n in ops.items():
            total[op] = total.get(op, 0) + n
    return total


def design_floor(cycles: dict, T: int, clock_mhz: float) -> tuple:
    """This design's floor for T ticks at the probe's `cycles` per operation
    and the SM clock: T times the largest mean of `CYCLES`.  Returns (ms,
    cycles per tick, the cycle's name)."""
    per = dict(cycles, simple=max(cycles["fadd"], cycles["fmul"]))
    paths = {name: sum(n * per[op] for op, n in path_ops(name).items()) for name in PATHS}
    means = {name: sum(paths[p] for p in legs) / len(legs) for name, legs in CYCLES.items()}
    name = max(means, key=means.get)
    return T * means[name] / (clock_mhz * 1e3), means[name], name


def build_probe(verbose: bool = False) -> str:
    """Compile the probe (if not built yet) and return its library's path."""
    return tick.build(verbose, source=PROBE_SOURCE, stem="libqtos_op_cycles")


def load_probe(path: str):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.op_cycles.argtypes = [ci, ci, vp, vp]
    lib.op_cycles.restype = ci
    return lib


def op_cycles(lib, reps: int = 4096) -> dict:
    """Clock cycles of one dependent repetition of each operation in `OPS`,
    measured on the card by the probe's library `lib`."""
    import torch

    out = torch.zeros(64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cycles = {}
    for op, name in enumerate(OPS):
        for n in (16, reps):                  # the first launch warms the instruction cache
            err = lib.op_cycles(op, n, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"op probe {name} failed with CUDA error {err}")
        cycles[name] = float(out[0]) / reps
    return cycles


def sm_clock_mhz() -> float:
    """The SM clock as `nvidia-smi` reads it now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    return float(out.split()[0])
