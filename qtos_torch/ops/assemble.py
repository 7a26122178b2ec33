"""Wrapper of the CUDA assembly kernel (`qtos_torch/csrc/assemble.cu`): the
Gauss-Newton system of one LM iteration, one launch per call.

`assemble_kernel(x, spec, terrain, cfg, aux, slope)` returns `(D, L, g,
merit)` like `qtos_torch.solver.assemble.assemble`, whose plain version
(`knot_normal` + `interval_normal`) it replaces on the card: x (B, K, 36) ->
D (B, K, 36, 36), L (B, K-1, 36, 36), g (B, K, 36), merit (B,).  It takes
CUDA tensors only and raises on anything the kernel does not take;
`solver.assemble.assemble` sends CPU tensors to the plain version.  `slope`
is `slope_terrain(terrain, cfg.slope_probe_d)`, which the solver builds once
per pass.

The kernel runs one block of 8 warps per window, its work staged by kind
(every knot's endpoint terms and family blocks once, then the Gram products
as 4 x 4 register tiles); csrc/assemble.cu's note says how.  It is built at
first use by `qtos_torch.ops.cuda_lib`, with `--fmad=false` and without
fast math, and loaded with ctypes.  Its constants (the weights and
margins of the `SolverConfig`, the spec's dt, the SOLO12 mass, inertia and
nominal feet, the terrain's grid) are taken from the Python objects at each
call, in the layout the library reports (`assemble_param_layout`); its
tensors are passed as one array of pointers in the order
`assemble_tensor_layout` names.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from qtos_torch.models.solo12 import Solo12
from qtos_torch.ops import cuda_lib
from qtos_torch.solver.spec import FORCE_SCALE, NV
from qtos_torch.solver.transcription import GRAVITY_Z

SOURCE = cuda_lib.csrc("assemble.cu")
# no-penetration margin of `knot_normal`: h - 0.005 - p_z
PEN_MARGIN = 0.005


def load_library(path: str):
    """The kernel's library at `path` (built by `build`, or the CPU build of
    the same source in the tests) with its functions' argument types set."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.assemble_run.argtypes = [vp, ci, vp, ci, ci, ci, ci, ci, vp]
    lib.assemble_run.restype = ci
    for name in ("assemble_param_layout", "assemble_tensor_layout"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_char_p
    for name in ("assemble_chunk", "assemble_smem_bytes", "assemble_blocks_per_sm"):
        getattr(lib, name).argtypes = [ci]
        getattr(lib, name).restype = ci
    return lib


KERNEL = cuda_lib.Kernel(SOURCE, "libqtos_assemble", load_library, flags=("--fmad=false",))
build = KERNEL.build


def param_values(dt: float, terrain, cfg) -> dict:
    """Every constant the kernel takes, by its name in
    `assemble_param_layout`, from the Python objects: float32 as the plain
    version's operations see them (a product of Python numbers is taken in
    double precision first, as `normal_eq` writes it)."""
    W = cfg.weights
    model = Solo12.tensors("cpu")
    H, Wd = terrain.height.shape
    k = -0.5 * dt * W.dyn_w
    vals = dict(
        half_dt=0.5 * dt, m_half_dt=-0.5 * dt, c_vr=-0.5 * dt * W.dyn_r,
        c_fv=-0.5 * dt * FORCE_SCALE / Solo12.mass * W.dyn_v, c_kw=k, c_kwf=k * FORCE_SCALE,
        dyn_r=W.dyn_r, dyn_th=W.dyn_th, dyn_v=W.dyn_v, dyn_w=W.dyn_w, stat=W.stat, terr=W.terr,
        fzero=W.fzero, init=W.init, goal=W.goal, fric=W.fric, rom=W.rom, clear=W.clear, body=W.body,
        acc_reg=W.acc_reg, f_reg=W.f_reg, footvel_reg=W.footvel_reg, post_reg=W.post_reg, slope=W.slope,
        acc_reg2=W.acc_reg**2, f_reg2=W.f_reg**2, post_reg2=W.post_reg**2,
        mu_t=cfg.mu_friction / math.sqrt(2.0), fz_max=cfg.f_max / FORCE_SCALE,
        swing_clearance=cfg.swing_clearance, body_clearance=cfg.body_clearance,
        slope_margin=cfg.slope_margin, force_scale=FORCE_SCALE, mass=Solo12.mass, gravity_z=GRAVITY_Z,
        pi=math.pi, pen_margin=PEN_MARGIN,
        terrain_x0=terrain.origin[0], terrain_y0=terrain.origin[1], terrain_res=terrain.resolution,
        terrain_cx_max=Wd - 1.001, terrain_cy_max=H - 1.001,
        nominal_feet=model.nominal_feet.reshape(-1).tolist(), rom_box=list(cfg.rom_box),
        inertia=torch.diagonal(model.inertia).tolist(),
        inertia_inv=torch.diagonal(model.inertia_inv).tolist(),
    )
    return {k: np.atleast_1d(np.asarray(v, np.float64)).astype(np.float32) for k, v in vals.items()}


def param_array(lib, dt: float, terrain, cfg) -> np.ndarray:
    """`param_values` packed in the library's layout."""
    vals = param_values(dt, terrain, cfg)
    parts = []
    for item in lib.assemble_param_layout().decode().strip(",").split(","):
        name, count = item.split(":")
        if name not in vals or vals[name].size != int(count):
            raise RuntimeError(f"assembly kernel constant {name}[{count}] has no value of that size in Python")
        parts.append(vals.pop(name))
    if vals:
        raise RuntimeError(f"assembly kernel takes no constants named {sorted(vals)}")
    return np.concatenate(parts)


_packed: dict = {}


def _param_array_once(lib, dt: float, terrain, cfg) -> np.ndarray:
    """`param_array`, packed once per library layout, dt, terrain grid and
    (frozen, hashable) `SolverConfig`: packing takes ~0.26 ms of host time,
    more than the kernel at small B, and an LM loop repeats it every
    iteration.  The array is read only."""
    key = (lib.assemble_param_layout(), float(dt), float(terrain.resolution), tuple(terrain.origin),
           tuple(terrain.height.shape), cfg)
    consts = _packed.get(key)
    if consts is None:
        if len(_packed) >= 64:
            _packed.clear()
        consts = _packed[key] = param_array(lib, dt, terrain, cfg)
    return consts


def _inputs(x, spec, terrain, aux, slope) -> dict:
    """The kernel's input tensors by name, with the shape each must have."""
    B, K, _ = x.shape
    st = spec.start
    hw = tuple(terrain.height.shape)
    return dict(
        x=(x, (B, K, NV)), contact=(aux.contact, (B, K, 4)), swing_prog=(aux.swing_prog, (B, K, 4)),
        terr_slack=(aux.terr_slack, (B, K, 4)), box_widen=(aux.box_widen, (B, K, 4, 3)),
        first_stance=(aux.first_stance, (B, K, 4)), is_first=(aux.is_first, (K,)), is_last=(aux.is_last, (K,)),
        interval_contact=(spec.schedule.contact, (B, K, 4)), start_r=(st.r, (B, 3)), start_eul=(st.eul, (B, 3)),
        start_v=(st.v, (B, 3)), start_omega=(st.omega, (B, 3)), start_feet=(st.feet, (B, 4, 3)),
        goal_r=(spec.goal_r, (B, 3)), goal_yaw=(spec.goal_yaw, (B,)), height=(terrain.height, hw),
        slope_height=(slope.height, hw),
    )


def prepare(lib, x, spec, terrain, cfg, aux, slope):
    """Checks and packs one launch of the kernel in `lib` on the system of
    x (B, K, 36) and allocates its outputs.  Returns (launch, (D, L, g,
    merit)): `launch(stream)` launches the kernel on the packed inputs and
    fills the outputs; the caller gives the stream (None: the default one)
    and counts the launch.  A timing loop calls `launch` alone, so it times
    the kernel and not this packing."""
    if x.dim() != 3 or x.shape[-1] != NV:
        raise ValueError(f"assembly kernel takes x of shape (B, K, {NV}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("assembly kernel takes a contiguous x")
    B, K, _ = x.shape
    if K < 2:
        raise ValueError(f"assembly kernel takes K >= 2 knots, got {K}")
    if terrain.height.dim() != 2 or min(terrain.height.shape) < 2:
        raise ValueError(f"assembly kernel takes a (rows, cols) height grid, rows and cols >= 2, "
                         f"got {tuple(terrain.height.shape)}")
    if (slope.resolution, tuple(slope.origin)) != (terrain.resolution, tuple(terrain.origin)):
        raise ValueError("the slope grid's resolution and origin must be the terrain's")
    dev = x.device
    ptrs = {}
    for name, (t, shape) in _inputs(x, spec, terrain, aux, slope).items():
        if t.dtype != torch.float32:
            raise TypeError(f"assembly kernel takes float32, got {t.dtype} for {name}")
        if t.device != dev:
            raise ValueError(f"assembly kernel inputs on different devices: {name} on {t.device}, x on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"assembly kernel: {name} has shape {tuple(t.shape)}, the batch needs {shape}")
        ptrs[name] = t.contiguous()
    if ptrs["x"].data_ptr() % 16:  # the kernel copies x into shared memory 16 bytes at a time
        ptrs["x"] = ptrs["x"].clone()
    out = (torch.empty((B, K, NV, NV), dtype=torch.float32, device=dev),
           torch.empty((B, K - 1, NV, NV), dtype=torch.float32, device=dev),
           torch.empty((B, K, NV), dtype=torch.float32, device=dev),
           torch.empty((B,), dtype=torch.float32, device=dev))
    if B == 0:
        return (lambda stream=None: None), out
    ptrs.update(zip(("D", "L", "g", "merit"), out))
    names = lib.assemble_tensor_layout().decode().strip(",").split(",")
    if sorted(names) != sorted(ptrs):
        raise RuntimeError(f"assembly kernel takes tensors {names}, the wrapper has {sorted(ptrs)}")
    arr = (ctypes.c_void_p * len(names))(*(ptrs[n].data_ptr() for n in names))
    consts = _param_array_once(lib, spec.dt, terrain, cfg)
    H, Wd = terrain.height.shape

    def launch(stream=None):
        # `ptrs` keeps the packed tensors alive as long as `launch` is
        err = lib.assemble_run(consts.ctypes.data, consts.size, ctypes.addressof(arr), len(ptrs), B, K, H, Wd,
                               stream)
        if err != 0:
            raise RuntimeError(f"assembly kernel launch failed: CUDA error {err}")

    return launch, out


def run(lib, x, spec, terrain, cfg, aux, slope, stream=None):
    """One launch of the kernel in `lib` on the tensors' own memory: the
    system of x (B, K, 36).  Returns (D, L, g, merit).  The caller gives the
    stream (None: the default one) and counts the launch."""
    launch, out = prepare(lib, x, spec, terrain, cfg, aux, slope)
    launch(stream)
    return out


def assemble_kernel(x, spec, terrain, cfg, aux, slope):
    """The Gauss-Newton system of x (B, K, 36) on the card, one launch of
    the hand-written kernel: (D, L, g, merit).

    `assemble_kernel.launches` counts kernel launches,
    `assemble_kernel.chunked_launches` those of them whose windows are
    longer than one chunk of the kernel's shared memory."""
    if x.device.type != "cuda":
        raise ValueError(f"the assembly kernel runs on cuda (solver.assemble.assemble runs the plain version "
                         f"on cpu), not {x.device}")
    lib = KERNEL.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        out = run(lib, x, spec, terrain, cfg, aux, slope, stream=stream)
    B, K = x.shape[0], x.shape[1]
    assemble_kernel.launches += int(B > 0)
    assemble_kernel.chunked_launches += int(B > 0 and lib.assemble_chunk(K) < K)
    return out


cuda_lib.count_launches(assemble_kernel, "launches", "chunked_launches")
