"""The CUDA source of the assembly kernel, run on the CPU.

`qtos_torch/csrc/assemble.cu` is compiled with the host C++ compiler against
the CUDA stand-in in `qtos_torch/csrc/emu/` (`-ffp-contract=off`, as nvcc's
`--fmad=false` on the card) and driven through `qtos_torch.ops.assemble.run`,
the wrapper's own packing of the constants and tensors.  It is held against
the plain version, `qtos_torch.solver.assemble.assemble` on the CPU, on the
same inputs, and once against `qtos_tpu`'s `_assemble` itself.

The problem is tests/test_torch_normal_eq.py's (3 windows of K=13 started 8
cm to the side on the `step` tile, so the left feet stand on the riser's
ramp, perturbed off the initial guess), with the `feasibility` tile beside
it and a few knots moved so that every hinge family is active somewhere: a
stance foot on a pillar's edge (slope), a swing foot below the ground
(no-penetration), a foot far from its hip (range of motion), forces outside
the friction pyramid and above the cap, a base below its clearance.  Batches
of B=3 with K=13, B=5 with K=9 and K=2 (one interval), B=2 with K=17 and K=45
(two chunks of the kernel's shared memory) and B=1 with K=154 (the one-shot
plan's window: four chunks of 39 knots) cover its walk over the knots in
groups of four; a second build whose chunks hold at most 5 knots
(`-DASM_MAX_CHUNK=5`) hands the halo from chunk to chunk at every shape.

Both builds equal the kernel's first design (one warp per knot, commit
5a6d09c) bit for bit on stored inputs (`tests/data/assemble_first_design.npz`,
the digests below), with the block's threads running at once and one at a
time in either order (`QTOS_EMU_THREAD_ORDER`).  Copies of the source
without one of its block barriers, without its copy's wait, without the
halo's endpoint terms, or with L_k taken from the mirrored tile must fail.

Tolerance atol=rtol=2e-4, tests/test_torch_assemble.py's: float32 blocks
with entries up to ~1e6 here, the plain version's batched products summed in
the order the BLAS chooses.  Over 64 windows a few entries whose terms cancel
part by more than that; there the test adds 1e-6 of the entry's rounding
scale (`qtos_torch.tools.check_assemble.rounding_scales`), a tenth of the
card's gate.  The kernel's speed and its build by nvcc are
checked on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import importlib
import inspect
import json
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.solver import SolverConfig as JConfig
from qtos_tpu.solver import default_spec as j_default_spec
from qtos_tpu.solver.solve import _assemble
from qtos_tpu.terrain import make_terrain as j_make_terrain

from helpers import emu
from qtos_torch.convert import config_from_reference, spec_from_reference
from qtos_torch.ops import assemble as asm
from qtos_torch.solver import SolverConfig, default_spec, solve_batch
from qtos_torch.solver.assemble import assemble
from qtos_torch.solver.jacobians import knot_system
from qtos_torch.solver.transcription import knot_aux
from qtos_torch.terrain import make_terrain
from qtos_torch.tools import check_assemble

TOL = dict(atol=2e-4, rtol=2e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMU_DIR = os.path.join(REPO, "qtos_torch", "csrc", "emu")
KERNEL_SRC = os.path.join(REPO, "qtos_torch", "csrc", "assemble.cu")
OUTPUTS = ("D", "L", "g", "merit")
# the module, not the function `qtos_torch.solver.solve` that shadows it
solve_mod = importlib.import_module("qtos_torch.solver.solve")
# Copies of assemble.cu that must fail: (pattern, replacement, matches).
MUTANTS = {
    "no_slope_hinge": (r"const float w_sl = c \* \(1\.0f - fst\) \* p\.slope;", "const float w_sl = 0.0f;", 1),
    "no_init_block": (r"t\.is_first\[k\] \* p\.init", "0.0f", 3),
    "wa_wb_swapped": (r"wa \? -1\.0f : 1\.0f", "wa ? 1.0f : -1.0f", 1),
}
# Copies that break the kernel's chunks, its L tiles or its copy of x must
# fail, each run in a subprocess of the chunked build (a copy may abort):
# (pattern, replacement, matches).
DESIGN_MUTANTS = {
    # the next chunk's first knot no longer computed by the chunk before it
    "halo_unset": (r"const int nE = kx - e0 \+ 1;", "const int nE = min(k0 + n, K) - e0;", 1),
    # L_k = Wa(x_k)^T Wb(x_{k+1}), the mirror of Lba, as if it were symmetric like D_k
    "lba_mirrored": (r"l_tile\(WB \+ \(j \+ 1\) \* kWFloats, WA \+ j \* kWFloats",
                     "l_tile(WA + j * kWFloats, WB + (j + 1) * kWFloats", 1),
    # the copy of x into shared memory not waited for
    "no_cp_wait": (r"__pipeline_wait_prior\(0\);", "", 1),
}
with open(KERNEL_SRC) as _f:
    KERNEL_LINES = _f.read().splitlines(keepends=True)
# The kernel's block barriers, by line.
BARRIERS = [i for i, line in enumerate(KERNEL_LINES) if re.fullmatch(r"\s*__syncthreads\(\);\s*", line)]
MAX_CHUNK = 5  # the chunked build's knots per chunk

# The stored inputs, and the first design's outputs on them (SHA-256 of D,
# L, g and merit, each NaN written as one bit pattern): its source under this
# stand-in, from the repository's root,
#   git archive 5a6d09c qtos_torch/csrc | tar -x -C SRC
#   python tests/test_torch_assemble_emu.py --record SRC
INPUTS = os.path.join(REPO, "tests", "data", "assemble_first_design.npz")
CASES = {"steps_3x13": (3, 13), "steps_5x9": (5, 9), "steps_5x2": (5, 2), "steps_2x17": (2, 17),
         "steps_2x45": (2, 45), "nonfinite_3x13": (3, 13)}
FIRST_DESIGN_DIGESTS = {
    "steps_3x13": dict(
        D="9851cee6ce7481eab09042733d52cb256273f594c35bcd36128d2f4dc42ceebe",
        L="6a477cfbc19bb66a281acc429d9ecd4ff187f21cc59daf0caa7a883b0e7fed6e",
        g="5eebd190ea2b1689d54d0e46c7d861b20c081856ff2d6e0307403085344252aa",
        merit="52e27f98acf395ff839bdc50eba43322857f569054f3b7e30beb1e399c668ae5",
    ),
    "steps_5x9": dict(
        D="ad4b939215aaedbbfb0d935eb4f25bc88992bd36152e800ec61d066c4900fcd4",
        L="95684a9e8034e11e8792560c0bb58183952d2324d3913a02861b8d5a76663c34",
        g="17828ebd00742d4f9866956dcca1687bfb153815c8ec6318a598d58caf8da54e",
        merit="b249bd0b96e304bf5faa65d176db510b0610cef2ee1ca6d2cecbf5e97b660bbf",
    ),
    "steps_5x2": dict(
        D="300d40eb5abcdc1c7569d5d6d59a8eef6c222311d044edecb79f9e8320fcfd46",
        L="ccbad0b7b6647c138eb5bf9142b6444ef4cc0feb374c073b9272efdd1cab6da6",
        g="447e746d0960346487045281d831861e8de38badf902a0c8e0f19775d30a2071",
        merit="98d212281aa41b886abc4ec8f7c0d2310819037cb9b9ae5d82bd092f0b8e743f",
    ),
    "steps_2x17": dict(
        D="49ee92fc3916848102e012db1a2040b0b842ca0f7b4acd1d49d10af80918b564",
        L="f615c08209190f9bb1a0960ccedfd42db3f85e44ca09b81cffc96d793fe3194f",
        g="ea11e519dc461d428b5560bb136eed3c7c7a27d276bcd513e3b7a7d9ff58f478",
        merit="c89d41d827379f2c98d0587d4ddf199f36e1e4ccd84c53c6b8af53dae9db4942",
    ),
    "steps_2x45": dict(
        D="58c0db080684622a14a2249500e919a529b2355bc88a0433c845c307b18b3cca",
        L="6a624a68f17c6fb3065b1fa263b18aac5c82fcc8da9c3c7e8eeae0e5462f1ae8",
        g="48cab3acba8c504e20f1ed9b7e570aebfd4ef8525f0e0aac31bb1cdbc8f4d3a8",
        merit="f9e9a0e99eefa9e2f222141f4932c59ae0f923da4a24696413a416e67659c1b8",
    ),
    "nonfinite_3x13": dict(
        D="84179578341e8739eee87772037030a8b28d8d3f461ca024b31653cc851a7a70",
        L="f7990caa668c6d5c97f4c8ddbebc90e907dbc0b15ec58b54c59bd07819e98166",
        g="c754189a94286f3eff3383ec2b1c3d9b8f151d970038196483954fa1375e6547",
        merit="79a48569b1efb0d9bf9bacd0c802a2d672630bdb412759ea5d35e15042b7116f",
    ),
}


def _build(src_dir, out, defines=()):
    """Builds `src_dir`/emu/assemble_emu.cpp against this stand-in into `out` and loads it."""
    return asm.load_library(emu.build(asm.KERNEL, os.path.join(src_dir, "emu", "assemble_emu.cpp"), out, defines))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(os.path.dirname(EMU_DIR), tmp_path_factory.mktemp("assemble_emu") / "libassemble_emu.so")


@pytest.fixture(scope="module")
def chunked_lib_path(tmp_path_factory):
    """The source built with chunks of at most MAX_CHUNK knots."""
    out = tmp_path_factory.mktemp("assemble_emu_chunked") / "libassemble_emu_chunked.so"
    return emu.build(asm.KERNEL, os.path.join(EMU_DIR, "assemble_emu.cpp"), out, [f"-DASM_MAX_CHUNK={MAX_CHUNK}"])


SHAPES = [(3, 13), (5, 9), (5, 2), (2, 17), (2, 45), (1, 154)]


@pytest.fixture(scope="module")
def systems(lib):
    """Per shape: the problem, the emulated kernel's system and the plain one."""
    out = {}
    for B, K in SHAPES:
        p = check_assemble.problem("steps", B, K, "cpu")
        args = (p["x"], p["specs"], p["terrain"], p["cfg"], p["aux"], p["slope"])
        out[(B, K)] = (p, asm.run(lib, *args), assemble(*args))
    return out


def test_cases_activate_every_hinge(systems):
    p = systems[(3, 13)][0]
    res, _ = knot_system(p["x"], p["aux"], p["specs"], p["terrain"], p["cfg"])
    families = {"no-penetration": (8, 12), "friction": (24, 48), "range of motion": (48, 72), "slope": (84, 88),
                "base clearance": (88, 89)}
    for name, (lo, hi) in families.items():
        assert float(res[..., lo:hi].abs().max()) > 0.0, name
    c = p["specs"].schedule.contact
    assert bool((c[:, 1:] != c[:, :-1]).any())                          # a foot lifts or lands


@pytest.mark.parametrize("name", OUTPUTS)
@pytest.mark.parametrize("shape", SHAPES, ids=[f"B{B}K{K}" for B, K in SHAPES])
def test_emulated_kernel_matches_plain(systems, shape, name):
    _, out, ref = systems[shape]
    o, r = out[OUTPUTS.index(name)], ref[OUTPUTS.index(name)]
    assert o.shape == r.shape
    err = (o - r).abs()
    print(f"{name} {tuple(o.shape)}: max |kernel - plain| {float(err.max()):.3e} of max |plain| "
          f"{float(r.abs().max()):.3e}; largest share of the tolerance "
          f"{float((err / (TOL['atol'] + TOL['rtol'] * r.abs())).max()):.3f}")
    np.testing.assert_allclose(o.numpy(), r.numpy(), err_msg=name, **TOL)


def test_emulated_kernel_within_the_rounding_scale(lib):
    """B=64, K=41: over more windows a few entries whose terms reach 1e6 and
    cancel part from the plain version by more than 2e-4 of their size; the
    gate of the card's comparison (tools/check_assemble.py) adds 1e-5 of
    each entry's rounding scale, and the stand-in stays within 1e-6 of it."""
    p = check_assemble.problem("steps", 64, 41, "cpu")
    out = asm.run(lib, p["x"], p["specs"], p["terrain"], p["cfg"], p["aux"], p["slope"])
    ref = assemble(p["x"], p["specs"], p["terrain"], p["cfg"], p["aux"], p["slope"])
    for o, r, sc, name in zip(out, ref, check_assemble.rounding_scales(ref), OUTPUTS):
        d = (o - r).abs()
        print(f"{name}: largest |kernel - plain| over its rounding scale {float((d / sc.clamp(min=1e-30)).max()):.2e}")
        assert bool((d <= TOL["atol"] + TOL["rtol"] * r.abs() + 1e-6 * sc).all()), name


def test_emulated_kernel_matches_the_reference(lib, systems):
    """Three ways on one input: the kernel's source, the plain version and
    `qtos_tpu`'s `_assemble` (vmapped over the batch)."""
    p, out, _ = systems[(3, 13)]
    jterr = j_make_terrain(["step", "feasibility"])
    np.testing.assert_array_equal(np.asarray(jterr.height), p["terrain"].height.numpy())
    jcfg = JConfig(max_iters=3, rescue_iters=12)
    goals = jnp.asarray(np.linspace(0.3, 0.6, 3).astype(np.float32))
    jspecs = jax.vmap(lambda g: j_default_spec(jterr, start_xy=(0.0, 0.08), goal_xy=(g, 0.08), K=13,
                                               duration=1.5))(goals)
    ref = jax.vmap(lambda xx, s: _assemble(xx, s, jterr, jcfg))(jnp.asarray(p["x"].numpy()), jspecs)
    specs = spec_from_reference(jax.tree_util.tree_map(np.asarray, jspecs), device="cpu")
    cfg = config_from_reference(jax.tree_util.tree_map(np.asarray, jcfg))
    mine = asm.run(lib, p["x"], specs, p["terrain"], cfg, knot_aux(specs, p["terrain"], cfg), p["slope"])
    for o, o_port, r, name in zip(mine, out, ref, OUTPUTS):
        np.testing.assert_array_equal(o.numpy(), o_port.numpy(), err_msg=f"{name}: the two specs differ")
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name, **TOL)


def test_emulated_kernel_is_repeatable(lib, systems):
    p, out, _ = systems[(3, 13)]
    again = asm.run(lib, p["x"], p["specs"], p["terrain"], p["cfg"], p["aux"], p["slope"])
    for a, b, name in zip(out, again, OUTPUTS):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def _mutant_source(tmp_path, src):
    """Writes the kernel source `src` with the stand-in's entry file under
    `tmp_path`; returns the entry file's path."""
    (tmp_path / "emu").mkdir()
    (tmp_path / "assemble.cu").write_text(src)
    shutil.copy(os.path.join(EMU_DIR, "assemble_emu.cpp"), tmp_path / "emu" / "assemble_emu.cpp")
    return str(tmp_path / "emu" / "assemble_emu.cpp")


def _mutant(tmp_path, pattern, text, count):
    """assemble.cu with its `count` matches of `pattern` replaced by `text`, built."""
    with open(KERNEL_SRC) as f:
        src = f.read()
    assert len(re.findall(pattern, src)) == count, f"assemble.cu has {pattern} in {count} places"
    _mutant_source(tmp_path, re.sub(pattern, text, src))
    return _build(str(tmp_path), tmp_path / "libassemble_mutant.so")


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_emulated_kernel_mutants_fail(systems, tmp_path, mutant):
    """Copies of assemble.cu without the slope hinge, without the init
    block, and with every interval's Wa and Wb swapped: each must leave the
    plain version's tolerance."""
    p, _, ref = systems[(3, 13)]
    lib = _mutant(tmp_path, *MUTANTS[mutant])
    out = asm.run(lib, p["x"], p["specs"], p["terrain"], p["cfg"], p["aux"], p["slope"])
    assert not all(np.allclose(o.numpy(), r.numpy(), **TOL) for o, r in zip(out, ref))


def test_param_layout_is_the_libraries(lib, systems):
    """Every constant the kernel names comes from Python, once; so does
    every tensor."""
    p = systems[(3, 13)][0]
    vals = asm.param_values(p["specs"].dt, p["terrain"], p["cfg"])
    names = [item.split(":")[0] for item in lib.assemble_param_layout().decode().strip(",").split(",")]
    assert sorted(names) == sorted(vals) and len(set(names)) == len(names)
    assert asm.param_array(lib, p["specs"].dt, p["terrain"], p["cfg"]).dtype == np.float32
    tensors = lib.assemble_tensor_layout().decode().strip(",").split(",")
    inputs = asm._inputs(p["x"], p["specs"], p["terrain"], p["aux"], p["slope"])
    assert sorted(tensors) == sorted(list(inputs) + list(OUTPUTS))


def test_run_rejects_bad_inputs(lib, systems):
    p = systems[(3, 13)][0]
    rest = (p["specs"], p["terrain"], p["cfg"], p["aux"], p["slope"])
    with pytest.raises(ValueError, match="contiguous x"):
        asm.run(lib, p["x"].transpose(0, 1).contiguous().transpose(0, 1), *rest)
    with pytest.raises(ValueError, match="B, K, 36"):
        asm.run(lib, p["x"][..., :35].contiguous(), *rest)
    with pytest.raises(TypeError, match="float32"):
        asm.run(lib, p["x"].double(), *rest)
    with pytest.raises(ValueError, match="the batch needs"):
        asm.run(lib, p["x"][:2].contiguous(), *rest)
    with pytest.raises(ValueError, match="cuda"):
        asm.assemble_kernel(p["x"], *rest)


def test_run_copies_a_misaligned_x(lib, systems):
    """The kernel copies x into shared memory 16 bytes at a time; `run`
    hands it an aligned copy of an x that starts elsewhere (the stand-in
    aborts on a misaligned copy)."""
    p, out, _ = systems[(3, 13)]
    buf = torch.empty(p["x"].numel() + 1)
    x = buf[1:].view_as(p["x"])
    x.copy_(p["x"])
    assert x.is_contiguous() and x.data_ptr() % 16
    again = asm.run(lib, x, p["specs"], p["terrain"], p["cfg"], p["aux"], p["slope"])
    for a, b, name in zip(out, again, OUTPUTS):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def test_constants_are_packed_once_per_config(lib, systems):
    """The wrapper packs the constants once per layout, dt, grid and
    `SolverConfig`; another config packs (and assembles) anew."""
    p, out, _ = systems[(3, 13)]
    first = asm._param_array_once(lib, p["specs"].dt, p["terrain"], p["cfg"])
    assert asm._param_array_once(lib, p["specs"].dt, p["terrain"], p["cfg"]) is first
    np.testing.assert_array_equal(first, asm.param_array(lib, p["specs"].dt, p["terrain"], p["cfg"]))
    cfg = p["cfg"].replace(slope_margin=p["cfg"].slope_margin + 0.05)
    assert not np.array_equal(asm._param_array_once(lib, p["specs"].dt, p["terrain"], cfg), first)
    again = asm.run(lib, p["x"], p["specs"], p["terrain"], cfg, p["aux"], p["slope"])
    assert not torch.equal(again[2], out[2])


def test_solve_pass_builds_the_slope_grid_once(monkeypatch):
    """`_solve_pass` builds the slope grid once and hands it to every
    assembly; the plain path then never rebuilds it."""
    import qtos_torch.solver.assemble as asm_mod
    import qtos_torch.solver.normal_eq as ne_mod

    calls = {"n": 0}
    inner = solve_mod.slope_terrain

    def counted(*a, **k):
        calls["n"] += 1
        return inner(*a, **k)

    def refused(*a, **k):
        raise AssertionError("the slope grid was rebuilt inside the LM loop")

    monkeypatch.setattr(solve_mod, "slope_terrain", counted)
    monkeypatch.setattr(asm_mod, "slope_terrain", refused)
    monkeypatch.setattr(ne_mod, "slope_terrain", refused)
    terr = make_terrain(["plane"], device="cpu")
    specs = default_spec(terr, goal_xy=(np.array([0.2, 0.3], np.float32), 0.0), K=9, duration=1.0, device="cpu")
    before = asm.assemble_kernel.launches
    res = solve_batch(specs, terr, SolverConfig(max_iters=2))
    assert calls["n"] == 1 and asm.assemble_kernel.launches == before
    assert bool(torch.isfinite(res.x).all())


# ---- bit for bit the first design; the chunked build; the design's mutants -------


def _emu_digests(lib_path, npz_path, case):
    """Runs the kernel library at `lib_path` once on the stored inputs of
    `case` through `assemble_run` and returns the SHA-256 of each output,
    every NaN written as one bit pattern.  numpy and ctypes only, so that a
    subprocess runs it quickly."""
    import ctypes
    import hashlib

    import numpy as np

    data = np.load(npz_path)
    lib = ctypes.CDLL(lib_path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.assemble_run.argtypes = [vp, ci, vp, ci, ci, ci, ci, ci, vp]
    lib.assemble_run.restype = ci
    lib.assemble_tensor_layout.restype = ctypes.c_char_p
    B, K, H, W = (int(v) for v in data[f"{case}/shape"])
    shapes = dict(D=(B, K, 36, 36), L=(B, K - 1, 36, 36), g=(B, K, 36), merit=(B,))
    arrays = {}
    for name in lib.assemble_tensor_layout().decode().strip(",").split(","):
        arrays[name] = (np.full(shapes[name], np.nan, np.float32) if name in shapes
                        else np.array(data[f"{case}/{name}"], np.float32, order="C"))
    ptrs = (ctypes.c_void_p * len(arrays))(*(a.ctypes.data for a in arrays.values()))
    params = np.array(data[f"{case}/params"], np.float32)
    err = lib.assemble_run(params.ctypes.data, params.size, ctypes.addressof(ptrs), len(arrays), B, K, H, W, None)
    if err:
        raise RuntimeError(f"assemble_run returned {err}")
    out = {}
    for name in shapes:
        a = arrays[name].copy()
        a[np.isnan(a)] = np.nan
        out[name] = hashlib.sha256(a.tobytes()).hexdigest()
    return out


# argv: library, inputs, then (case, thread order) pairs; prints a JSON list of digests.
_RUN = inspect.getsource(_emu_digests) + """
import json, os, sys
runs = sys.argv[3:]
out = []
for case, order in zip(runs[::2], runs[1::2]):
    os.environ["QTOS_EMU_THREAD_ORDER"] = order
    out.append(_emu_digests(sys.argv[1], sys.argv[2], case))
print(json.dumps(out))
"""


def _emu_digests_in_subprocess(lib_path, runs):
    """`_emu_digests` of each (case, thread order) of `runs` in one
    subprocess (a faulty copy may abort or hang), the block's threads run at
    once (order "") or one at a time ("1", "-1"); None when the subprocess
    failed."""
    args = [v for run in runs for v in run]
    proc = subprocess.run([sys.executable, "-c", _RUN, lib_path, INPUTS, *args], capture_output=True, text=True,
                          timeout=600)
    return json.loads(proc.stdout.strip().splitlines()[-1]) if proc.returncode == 0 else None


def _record_inputs(path):
    """The stored inputs: `check_assemble.problem("steps", B, K)` for each of
    `CASES` on this stand-in's host, and a copy of the 3 x 13 one with a NaN
    and two infinities in x."""
    from qtos_torch.ops import assemble as asm_ops

    arrays = {}
    for case, (B, K) in CASES.items():
        p = check_assemble.problem("steps", B, K, "cpu")
        x = p["x"].clone()
        if case.startswith("nonfinite"):
            x[0, 3, 4] = float("nan")
            x[1, 6, 27] = float("inf")
            x[2, 12, 14] = -float("inf")
        for name, (t, _) in asm_ops._inputs(x, p["specs"], p["terrain"], p["aux"], p["slope"]).items():
            arrays[f"{case}/{name}"] = t.contiguous().numpy()
        H, W = p["terrain"].height.shape
        arrays[f"{case}/shape"] = np.array([B, K, H, W], np.int64)
        arrays[f"{case}/params"] = np.concatenate(
            [np.atleast_1d(v) for v in asm_ops.param_values(p["specs"].dt, p["terrain"], p["cfg"]).values()])
    np.savez_compressed(path, **arrays)


def test_stored_inputs_activate_every_hinge():
    """The stored steps problems are `check_assemble.problem`'s (the hinge
    test above runs on it), with the constants in the kernel's layout."""
    data = np.load(INPUTS)
    for case, (B, K) in CASES.items():
        assert tuple(data[f"{case}/x"].shape) == (B, K, 36)
        assert tuple(data[f"{case}/shape"][:2]) == (B, K)
    assert not np.isfinite(data["nonfinite_3x13/x"]).all() and np.isfinite(data["steps_3x13/x"]).all()


@pytest.mark.parametrize("order", ["", "1", "-1"], ids=["parallel", "ascending", "descending"])
@pytest.mark.parametrize("build", ["whole", "chunked"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernel_equals_the_first_design(lib, chunked_lib_path, monkeypatch, case, build, order):
    """D, L, g and merit equal the first design's bit for bit (NaN where it
    had NaN), in one chunk per window and in chunks of at most MAX_CHUNK
    knots, with the block's threads at once and one at a time."""
    monkeypatch.setenv("QTOS_EMU_THREAD_ORDER", order)
    path = lib._name if build == "whole" else chunked_lib_path
    assert _emu_digests(path, INPUTS, case) == FIRST_DESIGN_DIGESTS[case]


def test_chunks_and_shared_memory(lib, chunked_lib_path):
    """A window of up to 41 knots runs in one chunk within two blocks' share
    of an H100 SM's shared memory; longer ones in even chunks; the chunked
    build's windows cross chunks at every tested K."""
    assert lib.assemble_chunk(41) == 41 and lib.assemble_chunk(13) == 13 and lib.assemble_chunk(2) == 2
    assert lib.assemble_chunk(45) == 23 and lib.assemble_chunk(83) == 28 and lib.assemble_chunk(154) == 39
    smem = lib.assemble_smem_bytes
    assert smem(41) == 113376 and smem(45) < smem(41) and 2 * (smem(41) + 1024) <= 233472
    chunked = asm.load_library(chunked_lib_path)
    assert [chunked.assemble_chunk(K) for K in (13, 17, 45, 2)] == [5, 5, 5, 2]


def _design_mutant(tmp_path, src):
    """The chunked build of the kernel source `src` (at -O1: it only has to
    build and run quickly); returns its path."""
    return emu.build(asm.KERNEL, _mutant_source(tmp_path, src), tmp_path / "libassemble_mutant.so",
                     [f"-DASM_MAX_CHUNK={MAX_CHUNK}"], opt="-O1")


@pytest.mark.parametrize("mutant", list(DESIGN_MUTANTS))
def test_emulated_design_mutants_fail(tmp_path, mutant):
    """A copy whose chunks leave the halo knot's endpoint terms unset, whose
    L_k is the mirror of Lba, or whose copy of x is not waited for (the
    stand-in leaves NaN in a copy's destination until the wait, and aborts
    a thread that ends with copies outstanding) must abort or differ from
    the first design."""
    pattern, text, count = DESIGN_MUTANTS[mutant]
    src = "".join(KERNEL_LINES)
    assert len(re.findall(pattern, src)) == count, f"assemble.cu has {pattern} in {count} places"
    path = _design_mutant(tmp_path, re.sub(pattern, text, src))
    cases = ("steps_3x13", "steps_2x17")
    digests = _emu_digests_in_subprocess(path, [(case, "") for case in cases])
    assert digests is None or all(d != FIRST_DESIGN_DIGESTS[c] for d, c in zip(digests, cases))


def test_kernel_source_has_its_barriers():
    assert len(BARRIERS) == 5, "assemble.cu's stages: x, endpoints and feet, shared blocks and intervals, rows, tiles"


def test_emulated_design_mutants_harness_passes_the_source(tmp_path):
    """The mutants' harness (the chunked build at -O1, run in a subprocess
    at once and one thread at a time) gives the unchanged source the first
    design's digests, so a mutant fails by its change alone."""
    path = _design_mutant(tmp_path, "".join(KERNEL_LINES))
    runs = [("steps_3x13", ""), ("steps_2x17", ""), ("steps_3x13", "1"), ("steps_3x13", "-1")]
    assert _emu_digests_in_subprocess(path, runs) == [FIRST_DESIGN_DIGESTS[c] for c, _ in runs]


@pytest.mark.parametrize("line", [pytest.param(i, id=f"assemble.cu:{i + 1}") for i in BARRIERS])
def test_emulated_kernel_needs_each_barrier(tmp_path, line):
    """A copy without the block barrier on `line`, its threads run one at a
    time in ascending and in descending order: in one of the two a thread
    reads what a later one has not written yet (or overwrites what it has not
    read), so the outputs must differ from the first design's."""
    path = _design_mutant(tmp_path, "".join(KERNEL_LINES[:line] + KERNEL_LINES[line + 1:]))
    digests = _emu_digests_in_subprocess(path, [("steps_3x13", "1"), ("steps_3x13", "-1")])
    assert digests is None or any(d != FIRST_DESIGN_DIGESTS["steps_3x13"] for d in digests)


if __name__ == "__main__":
    # --record SRC: store the inputs and print the digests of the kernel
    # source under SRC/qtos_torch/csrc (built against its own stand-in).
    import argparse
    import tempfile

    ap = argparse.ArgumentParser()
    ap.add_argument("--record", required=True, metavar="SRC")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(INPUTS), exist_ok=True)
    _record_inputs(INPUTS)
    emu_dir = os.path.join(args.record, "qtos_torch", "csrc", "emu")
    with tempfile.TemporaryDirectory() as d:
        path = emu.build(asm.KERNEL, os.path.join(emu_dir, "assemble_emu.cpp"), os.path.join(d, "lib.so"),
                         include=emu_dir)
        print(json.dumps({case: _emu_digests(path, INPUTS, case) for case in CASES}, indent=4))
