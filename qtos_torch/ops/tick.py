"""Wrapper of the CUDA tick kernel (`qtos_torch/csrc/tick.cu`): the 1 kHz
control loop, one launch per chunk.

`tick_scan(table, state0, terrain, params, n_valid)` plays (..., T, 37)
tables and returns `(final SimState, traces)` like
`qtos_torch.control.loop._scan_ticks`; `tick_hold(state, terrain, params,
n_steps)` runs `stance_warmup`'s hold like `control.loop._hold_ticks`.  On a
CUDA tensor each launches the hand-written kernel once (or raises); on a CPU
tensor each runs that plain version.

The kernel is compiled with `nvcc` for sm_90a at first use into
`qtos_torch/_build/` (keyed by the source's hash), with `--fmad=false` and
without fast math, and loaded with ctypes.  Its constants (the SOLO12
geometry and inertia, `SimParams`, `MotorParams`, the `ControlParams`
scalars, the terrain's grid) are taken from those Python objects at each
call, in the layout the library reports (`tick_param_layout`).

The kernel reads the state as one (B, 45) row per episode and writes the
traces as one (B, T, 56) tensor; the returned state leaves and trace entries
are views of those two tensors.  A playback also gives the kernel a (B, T,
`tick_scratch_floats()`) scratch for its table pass (the planned joints and
desired joint velocities of every row) and the chain's quaternions, which
its trace pass reads.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading

import numpy as np
import torch

from qtos_torch.models.solo12 import _L_LOW, _L_UP, Solo12
from qtos_torch.ops.btd import BUILD_DIR, _nvcc
from qtos_torch.sim.engine import CONTACT_DAMP_DEPTH, SimState, _constants

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "tick.cu")
ROW = 37
# The state row and the trace row of the kernel: (name, first column, shape).
STATE_LAYOUT = (("pos", 0, (3,)), ("quat", 3, (4,)), ("v", 7, (3,)), ("w", 10, (3,)),
                ("q", 13, (12,)), ("qd", 25, (12,)), ("anchor", 37, (4, 2)))
TRACE_LAYOUT = (("com_err", 0, ()), ("ee_err", 1, ()), ("pos", 2, (3,)), ("feet", 5, (4, 3)),
                ("q", 17, (12,)), ("qd", 29, (12,)), ("tau", 41, (12,)), ("eul", 53, (3,)))
STATE_FLOATS, TRACE_FLOATS = 45, 56
FRAMES = {"live": 0, "hybrid": 1}   # any other frame is "plan", as in `_tick`

_lib = None
_lib_lock = threading.Lock()


def nvcc_command(src: str, out: str, verbose: bool = False) -> list:
    """The nvcc command that builds the kernel source `src` into the shared
    library `out`: sm_90a, `--fmad=false`, no fast math; ``verbose`` adds
    ``-Xptxas -v`` (registers, stack frame and spills of each kernel)."""
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
        "-shared", "-Xcompiler", "-fPIC", "-o", out, src,
    ]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build(verbose: bool = False, source: str = SOURCE, stem: str = "libqtos_tick") -> str:
    """Compile `csrc/tick.cu` (or another `source` with the same flags) into
    a shared library named from `stem` and the source's hash, if not built
    yet, and return its path.  ``verbose`` adds ``-Xptxas -v`` and prints its
    report."""
    with open(source, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{stem}_{tag}.so")
    if os.path.exists(out) and not verbose:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(nvcc_command(source, tmp, verbose), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)
    return out


def load_library(path: str):
    """The kernel's library at `path` (built by `build`, or the CPU build of
    the same source in the tests) with its functions' argument types set."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tick_run.argtypes = [vp, ci, ci, ci, vp, vp, vp, vp, ci, ci, vp, vp, vp, ci, ci, ci, vp]
    lib.tick_run.restype = ci
    lib.tick_param_layout.argtypes = []
    lib.tick_param_layout.restype = ctypes.c_char_p
    for name in ("tick_state_floats", "tick_trace_floats", "tick_scratch_floats"):
        getattr(lib, name).restype = ci
    if (lib.tick_state_floats(), lib.tick_trace_floats()) != (STATE_FLOATS, TRACE_FLOATS):
        raise RuntimeError("tick library's state or trace row differs from qtos_torch.ops.tick's layout")
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_library(build())
    return _lib


def param_values(params, terrain) -> dict:
    """Every constant the kernel takes, by its name in `tick_param_layout`,
    from the Python objects: float32 as the plain version's operations see
    them (a Python number meets a float32 tensor cast to float32)."""
    sim, motor = params.sim, params.motor
    dt = sim.dt
    model = Solo12.tensors("cpu")
    H, W = terrain.height.shape
    vals = dict(
        dt=dt, contact_kp=sim.contact_kp, contact_kd=sim.contact_kd, friction=sim.friction,
        tangent_kp=sim.tangent_kp, tangent_kd=sim.tangent_kd, joint_inertia=sim.joint_inertia,
        joint_damping=sim.joint_damping, inertia_scale=sim.inertia_scale, base_radius=sim.base_radius,
        damp_pen=CONTACT_DAMP_DEPTH, kp=motor.kp, kd=motor.kd, t_max=motor.t_max,
        ee_shift=params.ee_shift, base_corr=params.base_corr, max_corr=params.max_corr,
        vel_corr=params.vel_corr, yaw_corr=params.yaw_corr, max_yaw_corr=params.max_yaw_corr,
        beta=dt / max(params.vel_tau, dt), gamma=dt / max(params.yaw_tau, dt),
        alpha=dt / max(params.corr_tau, dt), one_minus_base_corr=1.0 - params.base_corr,
        l_up=_L_UP, l_low=_L_LOW, ik_l1l1=_L_UP * _L_UP, ik_l2l2=_L_LOW * _L_LOW,
        ik_2l1l2=2 * _L_UP * _L_LOW, mass=Solo12.mass, weight_z=float(_constants("cpu").weight[2]),
        terrain_x0=terrain.origin[0], terrain_y0=terrain.origin[1], terrain_res=terrain.resolution,
        terrain_cx_max=W - 1.001, terrain_cy_max=H - 1.001,
        hips=model.hips.reshape(-1).tolist(), lateral=model.lateral.tolist(), knee=model.knee.tolist(),
        inertia=torch.diagonal(model.inertia).tolist(),
        inertia_inv=torch.diagonal(model.inertia_inv).tolist(),
        gain=motor.gain_vector("cpu").tolist(),
    )
    return {k: np.atleast_1d(np.asarray(v, np.float64)).astype(np.float32) for k, v in vals.items()}


def param_array(lib, params, terrain) -> np.ndarray:
    """`param_values` packed in the library's layout."""
    vals = param_values(params, terrain)
    parts = []
    for item in lib.tick_param_layout().decode().strip(",").split(","):
        name, count = item.split(":")
        if name not in vals or vals[name].size != int(count):
            raise RuntimeError(f"tick kernel constant {name}[{count}] has no value of that size in Python")
        parts.append(vals.pop(name))
    if vals:
        raise RuntimeError(f"tick kernel takes no constants named {sorted(vals)}")
    return np.concatenate(parts)


def _check(x: torch.Tensor, name: str, dev) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"tick kernel takes float32, got {x.dtype} for {name}")
    if x.device != dev:
        raise ValueError(f"tick kernel inputs on different devices: {name} on {x.device}, the launch on {dev}")


def _pack_state(state: SimState, batch, dev) -> torch.Tensor:
    rows = []
    for name, _, shape in STATE_LAYOUT:
        leaf = getattr(state, name)
        _check(leaf, f"state.{name}", dev)
        if tuple(leaf.shape) != tuple(batch) + shape:
            raise ValueError(f"state.{name} has shape {tuple(leaf.shape)}, the batch needs "
                             f"{tuple(batch) + shape}")
        rows.append(leaf.reshape(-1, math.prod(shape)))
    return torch.cat(rows, dim=1).contiguous()


def _unpack_state(x: torch.Tensor, batch) -> SimState:
    return SimState(**{name: x[:, i:i + math.prod(shape)].reshape(tuple(batch) + shape)
                       for name, i, shape in STATE_LAYOUT})


def run(lib, state0: SimState, terrain, params, table=None, n_valid=None, hold_steps=0, stream=None,
        scratch=None):
    """One launch of the kernel in `lib` on the tensors' own memory: the
    playback of `table` (..., T, 37) when it is given, else `hold_steps`
    steps of the stance hold.  Returns (final state, traces or None).  The
    caller gives the stream (None: the default one) and counts the launch,
    and may give the playback's (B, T, `tick_scratch_floats()`) scratch
    (None: a new one)."""
    if table is not None:
        if table.dim() < 2 or table.shape[-1] != ROW or table.shape[-2] < 1:
            raise ValueError(f"tick kernel takes a (..., T, {ROW}) table with T >= 1, got {tuple(table.shape)}")
        if not table.is_contiguous():
            raise ValueError("tick kernel takes a contiguous table")
        dev, batch, T = table.device, tuple(table.shape[:-2]), table.shape[-2]
        _check(table, "table", dev)
    else:
        if hold_steps < 0:
            raise ValueError(f"hold_steps must be >= 0, got {hold_steps}")
        dev, batch, T = state0.pos.device, tuple(state0.pos.shape[:-1]), int(hold_steps)
    h = terrain.height
    _check(h, "terrain.height", dev)
    if h.dim() != 2 or min(h.shape) < 2 or not h.is_contiguous():
        raise ValueError(f"tick kernel takes a contiguous (rows, cols) height grid, rows and cols >= 2, "
                         f"got {tuple(h.shape)}")
    B = math.prod(batch)
    state = _pack_state(state0, batch, dev)
    out = torch.empty_like(state)
    traces = nv = None
    if table is not None:
        traces = torch.empty((B, T, TRACE_FLOATS), dtype=torch.float32, device=dev)
        shape = (B, T, lib.tick_scratch_floats())
        if scratch is None:
            scratch = torch.empty(shape, dtype=torch.float32, device=dev)
        elif tuple(scratch.shape) != shape or not scratch.is_contiguous():
            raise ValueError(f"tick kernel takes a contiguous {shape} scratch, got {tuple(scratch.shape)}")
        _check(scratch, "scratch", dev)
        if n_valid is None:
            n_valid = T
        if isinstance(n_valid, torch.Tensor):
            nv = torch.broadcast_to(n_valid.to(dev), batch).reshape(B).clamp(0, T).to(torch.int32)
        else:
            nv = torch.full((B,), min(max(int(n_valid), 0), T), dtype=torch.int32, device=dev)
        nv = nv.contiguous()
    if B > 0:
        consts = param_array(lib, params, terrain)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = lib.tick_run(
            consts.ctypes.data, consts.size, FRAMES.get(params.frame, 2), int(bool(params.use_force_ff)),
            ptr(table), state.data_ptr(), ptr(nv), h.data_ptr(), h.shape[0], h.shape[1],
            out.data_ptr(), ptr(traces), ptr(scratch), B, T, 0 if table is not None else 1, stream,
        )
        if err != 0:
            raise RuntimeError(f"tick kernel launch failed: CUDA error {err}")
    return _unpack_state(out, batch), (None if traces is None else _split_traces(traces, batch, T))


def _split_traces(traces: torch.Tensor, batch, T) -> dict:
    return {name: traces[:, :, i:i + math.prod(shape)].reshape(tuple(batch) + (T,) + shape)
            for name, i, shape in TRACE_LAYOUT}


def _cuda_launch(state0, terrain, params, **kw):
    dev = kw["table"].device if kw.get("table") is not None else state0.pos.device
    if dev.type != "cuda":
        raise ValueError(f"the tick kernel runs on cuda (and its plain version on cpu), not {dev}")
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return run(lib, state0, terrain, params, stream=stream, **kw)


def tick_scan(table: torch.Tensor, state0: SimState, terrain, params, n_valid=None):
    """Play (..., T, 37) tables from `state0` with the controller of `params`.
    Ticks at index >= `n_valid` (a Python int, or a tensor with one count per
    episode) leave the carry as it was and still write their trace row.
    Returns (final state, traces dict with a T axis after the batch axes).

    `tick_scan.launches` counts kernel launches."""
    if table.device.type == "cpu":
        from qtos_torch.control.loop import _scan_ticks

        return _scan_ticks(table, state0, terrain, params, n_valid)
    final, traces = _cuda_launch(state0, terrain, params, table=table, n_valid=n_valid)
    tick_scan.launches += int(math.prod(table.shape[:-2]) > 0)
    return final, traces


def tick_hold(state: SimState, terrain, params, n_steps: int) -> SimState:
    """`n_steps` ticks of PD to the state's own joints with zero desired
    velocity (the stance warm-up).

    `tick_hold.launches` counts kernel launches."""
    if state.pos.device.type == "cpu":
        from qtos_torch.control.loop import _hold_ticks

        return _hold_ticks(state, terrain, params, n_steps)
    final, _ = _cuda_launch(state, terrain, params, hold_steps=n_steps)
    tick_hold.launches += int(state.pos[..., 0].numel() > 0)
    return final


tick_scan.launches = 0
tick_hold.launches = 0
