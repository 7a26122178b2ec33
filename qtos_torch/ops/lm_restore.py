"""Wrapper of the CUDA restore kernel (`qtos_torch/csrc/lm_restore.cu`): the
LM loop's keep-the-best step, one launch per LM iteration.

`restore_rejected(accept, (D, L, g), kept)` writes, in place in the freshly
assembled D (B, K, n, n), L (B, K-1, n, n) and g (B, K, n), the kept system
`kept` = (D_b, L_b, g_b) of every window w whose step was rejected
(`accept[w]` False), or zeros there when `kept` is None (no point accepted
yet).  Accepted windows keep the fresh system.  The result is
`torch.where(accept, fresh, kept)` bit for bit, without a third copy: the
caller then keeps the fresh tensors themselves as the best point's system.

On a CUDA tensor it launches the hand-written kernel once (or raises; the
kernel takes 16-byte aligned tensors, as assembly's fresh outputs are); on a
CPU tensor it runs the plain version, `restore_rejected_plain`.  The kernel
is built at first use by `qtos_torch.ops.cuda_lib`, with `--fmad=false`,
and loaded with ctypes; it launches on PyTorch's current stream and reads
the accept mask on the device, so the host waits for nothing.
"""

from __future__ import annotations

import ctypes

import torch

from qtos_torch.ops import cuda_lib

SOURCE = cuda_lib.csrc("lm_restore.cu")


def load_library(path: str):
    """The kernel's library at `path` (built by `build`, or the CPU build of
    the same source in the tests) with its functions' argument types set."""
    lib = ctypes.CDLL(path)
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lm_restore_f32.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, cll, cll, cll, vp]
    lib.lm_restore_f32.restype = ci
    return lib


KERNEL = cuda_lib.Kernel(SOURCE, "libqtos_lm_restore", load_library, flags=("--fmad=false",))
build = KERNEL.build


def _check(accept, dst, kept):
    if accept.dtype != torch.bool or accept.dim() != 1 or not accept.is_contiguous():
        raise ValueError(f"restore takes a contiguous (B,) bool accept mask, got {accept.dtype} "
                         f"of shape {tuple(accept.shape)}")
    B, dev = accept.shape[0], accept.device
    if len(dst) != 3 or (kept is not None and len(kept) != 3):
        raise ValueError("restore takes the three tensors (D, L, g) and their kept copies, or None")
    for i, t in enumerate(dst):
        if t.dtype != torch.float32:
            raise TypeError(f"restore takes float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"restore inputs on different devices: {t.device}, accept on {dev}")
        if t.dim() < 1 or t.shape[0] != B:
            raise ValueError(f"restore: a tensor of shape {tuple(t.shape)} for a batch of {B}")
        if not t.is_contiguous():
            raise ValueError("restore takes contiguous tensors")
        if kept is not None:
            k = kept[i]
            if k.dtype != t.dtype or k.device != dev or k.shape != t.shape or not k.is_contiguous():
                raise ValueError(f"restore: the kept tensor ({k.dtype}, {tuple(k.shape)}, {k.device}) is not "
                                 f"a contiguous copy of the fresh one ({t.dtype}, {tuple(t.shape)}, {dev})")


def _check_aligned(dst, kept):
    """The kernel copies 16 bytes at a time: every tensor starts on a 16-byte
    boundary and each window is a multiple of 4 floats (assembly's fresh
    outputs are)."""
    for t in dst + (() if kept is None else kept):
        if t.data_ptr() % 16 or (t.numel() // max(t.shape[0], 1)) % 4:
            raise ValueError(f"the restore kernel takes 16-byte aligned tensors of whole float4s per window, got "
                             f"{tuple(t.shape)} at address {t.data_ptr():#x}")


def restore_rejected_plain(accept, dst, kept):
    """The plain version: the rejected windows of each tensor in `dst` set
    from `kept`, or to zero when `kept` is None, in place."""
    rejected = ~accept
    for i, t in enumerate(dst):
        t[rejected] = 0.0 if kept is None else kept[i][rejected]


def run(lib, accept, dst, kept, stream=None):
    """One launch of the kernel in `lib` on the tensors' own memory (checked
    by the caller).  The caller gives the stream (None: the default one) and
    counts the launch."""
    B = accept.shape[0]
    if B == 0:
        return
    D, L, g = dst
    Db, Lb, gb = (None, None, None) if kept is None else (t.data_ptr() for t in kept)
    err = lib.lm_restore_f32(accept.data_ptr(), D.data_ptr(), Db, L.data_ptr(), Lb, g.data_ptr(), gb,
                             int(kept is not None), B, D.numel() // B, L.numel() // B, g.numel() // B, stream)
    if err != 0:
        raise RuntimeError(f"restore kernel launch failed at B={B}: CUDA error {err}")


def restore_rejected(accept: torch.Tensor, dst: tuple, kept: tuple | None) -> None:
    """In place in `dst` = (D, L, g): every window w with `accept[w]` False
    takes `kept`'s window w, or zeros when `kept` is None.

    Args:
      accept: (B,) bool, the LM steps accepted.
      dst: the fresh D (B, K, n, n), L (B, K-1, n, n), g (B, K, n), float32.
      kept: the best point's (D, L, g) of the same shapes, or None.

    `restore_rejected.launches` counts kernel launches (one per call on
    CUDA with B > 0)."""
    _check(accept, dst, kept)
    if accept.device.type == "cpu":
        return restore_rejected_plain(accept, dst, kept)
    if accept.device.type != "cuda":
        raise ValueError(f"restore runs on cuda or cpu, not {accept.device}")
    _check_aligned(dst, kept)
    lib = KERNEL.load()
    with torch.cuda.device(accept.device):
        run(lib, accept, dst, kept, torch.cuda.current_stream(accept.device).cuda_stream)
    restore_rejected.launches += int(accept.shape[0] > 0)


cuda_lib.count_launches(restore_rejected, "launches")
