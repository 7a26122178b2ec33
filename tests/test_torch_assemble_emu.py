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
of B=3 with K=13 (7 warps, one of them with a single knot) and B=5 with K=9
(5 warps) and K=2 (one interval) cover the kernel's walk over the knots.

Tolerance atol=rtol=2e-4, tests/test_torch_assemble.py's: float32 blocks
with entries up to ~1e6 here, the plain version's batched products summed in
the order the BLAS chooses.  Over 64 windows a few entries whose terms cancel
part by more than that; there the test adds 1e-6 of the entry's rounding
scale (`qtos_torch.tools.check_assemble.rounding_scales`), a tenth of the
card's gate.  The kernel's speed and its build by nvcc are
checked on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import importlib
import os
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.solver import SolverConfig as JConfig
from qtos_tpu.solver import default_spec as j_default_spec
from qtos_tpu.solver.solve import _assemble
from qtos_tpu.terrain import make_terrain as j_make_terrain

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
    "no_init_block": (r"t\.is_first\[k\] \* p\.init", "0.0f", 2),
    "wa_wb_swapped": (r"q == 1 \? -1\.0f : 1\.0f", "q == 1 ? 1.0f : -1.0f", 1),
}


def _build(src_dir, out):
    """Builds `src_dir`/emu/assemble_emu.cpp (which includes ../assemble.cu) into `out`."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the kernel's source for the CPU")
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-pthread", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         "-I", EMU_DIR, "-o", str(out), os.path.join(src_dir, "emu", "assemble_emu.cpp")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    return asm.load_library(str(out))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(os.path.dirname(EMU_DIR), tmp_path_factory.mktemp("assemble_emu") / "libassemble_emu.so")


SHAPES = [(3, 13), (5, 9), (5, 2)]


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


def _mutant(tmp_path, pattern, text, count):
    """assemble.cu with its `count` matches of `pattern` replaced by `text`, built."""
    with open(KERNEL_SRC) as f:
        src = f.read()
    assert len(re.findall(pattern, src)) == count, f"assemble.cu has {pattern} in {count} places"
    (tmp_path / "emu").mkdir()
    (tmp_path / "assemble.cu").write_text(re.sub(pattern, text, src))
    shutil.copy(os.path.join(EMU_DIR, "assemble_emu.cpp"), tmp_path / "emu" / "assemble_emu.cpp")
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
    assert lib.assemble_warps(41) == lib.assemble_warps(13) == 7 and lib.assemble_warps(2) == 2


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
