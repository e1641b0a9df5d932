"""The probes' hand kernels (``csrc/micro.cu``): counted wrappers, each
with its plain PyTorch version beside it.

- :func:`row_gather_sum` (kernel 8): per step, the sum of the B rows its
  indices name, through a ring of ``depth`` row copies a warp; the
  counterpart of the TPU's DMA-ring gathers (``micro_dma_u16.m3_final``,
  ``micro_tpu.m3_row_dma``).
- :func:`smem_probe` (kernel 9): x copied through a shared-memory scratch
  of a given size (``micro_tpu.m6_vmem_probe``).
- :func:`slab_gather` (kernel 10): rows of a slab by index, the slab read
  through L2 or held in a cluster's shared memory
  (``micro_vmem_gather``).
- :func:`ell_reduce` (kernel 11): out[c] = Σ_j v[c, j]·Bg[c, j, :]
  (``micro_ellreduce``).
- :func:`window_step_bf16` (kernel 12, ``csrc/winstep_bf16.cu``): kernel
  1's window step at the TPU's DEFAULT precision, A and B rounded to bf16
  on the tensor cores with f32 sums (``micro_winstep``'s ``"default"``
  rows): a TMA ring and ``wgmma`` on a per-call bf16 copy of B.  No plan
  reaches it: the plans stay exact f32.

CUDA tensors launch the kernel and count the launch in the wrapper's
``launches``; CPU tensors take the plain version; any other device
raises.  Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes

import torch

from flex_tpu_torch.ops.operands import check_kernel_operands

GATHER_WARPS = 8                 # warps of a kernel 8 block (GWARPS)
RING_DEPTHS = (8, 16)            # kernel 8: E2's ring, E1's ring
PLACEMENTS = ("l2", "cluster")   # kernel 10: slab in L2, or in a cluster


def _device_of(**tensors) -> torch.device:
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"arguments lie on several devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no micro kernel for device {dev}")
    return dev


def _check(name: str, t: torch.Tensor, dtype, dim: int) -> None:
    if t.dtype != dtype or t.dim() != dim:
        raise ValueError(f"{name} must be a {dim}-D {dtype} tensor, got "
                         f"{t.dim()}-D {t.dtype}")


def _check_width(k: int) -> None:
    """The row kernels' lanes own one float4 column each: k % 4 == 0,
    0 < k <= 128."""
    if not 0 < k <= 128 or k % 4:
        raise ValueError(f"the kernel takes 0 < k <= 128, k % 4 == 0; "
                         f"got k={k}")


# -- kernel 8 -----------------------------------------------------------------

def row_gather_sum_plain(B: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_gather_sum`, in the kernel's order:
    warp w of a step's block sums the step's rows w, w + 8, ... in turn,
    then the eight warp sums are added in warp order."""
    S, n = idx.shape
    G = B.index_select(0, idx.reshape(-1).long()).view(S, n, B.shape[1])
    acc = B.new_zeros((S, GATHER_WARPS, B.shape[1]))
    for t0 in range(0, n, GATHER_WARPS):
        c = min(GATHER_WARPS, n - t0)
        acc[:, :c] += G[:, t0:t0 + c]
    out = acc[:, 0].clone()
    for w in range(1, GATHER_WARPS):
        out += acc[:, w]
    return out


def row_gather_sum(B: torch.Tensor, idx: torch.Tensor,
                   depth: int = 16) -> torch.Tensor:
    """out[s, :] = Σ_i B[idx[s, i], :] (f32 [n_steps, k]) for B f32 [m, k]
    and idx i32 [n_steps, rows], every index in [0, m).  CUDA tensors
    launch kernel 8 (one block a step, ``depth`` rows in flight a warp;
    ``depth`` in :data:`RING_DEPTHS`, k % 4 == 0, k <= 128), counted in
    ``row_gather_sum.launches``; CPU tensors take
    :func:`row_gather_sum_plain`."""
    _check("B", B, torch.float32, 2)
    _check("idx", idx, torch.int32, 2)
    if depth not in RING_DEPTHS:
        raise ValueError(f"depth must be one of {RING_DEPTHS}, got {depth}")
    dev = _device_of(B=B, idx=idx)
    if dev.type == "cpu":
        return row_gather_sum_plain(B, idx)
    _check_width(B.shape[1])
    check_kernel_operands(("B",), B=B, idx=idx)
    from flex_tpu_torch import kernels

    S, n = idx.shape
    out = torch.empty((S, B.shape[1]), dtype=torch.float32, device=dev)
    kernels.launch("micro", "flex_row_gather_sum", dev, B.data_ptr(),
                   idx.data_ptr(), out.data_ptr(), S, n, B.shape[1], depth)
    row_gather_sum.launches += 1
    return out


row_gather_sum.launches = 0


# -- kernel 9 -----------------------------------------------------------------

def _check_probe(x: torch.Tensor, nbytes: int) -> None:
    _check("x", x, torch.float32, 2)
    if x.numel() != 1024:
        raise ValueError(f"x must hold 1024 floats ([8, 128]), got "
                         f"{tuple(x.shape)}")
    if nbytes < 4096 or nbytes % 4:
        raise ValueError(f"nbytes must be a multiple of 4, at least 4096; "
                         f"got {nbytes}")


def smem_probe_plain(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Plain version of :func:`smem_probe`: x through the last 4 KB of a
    scratch of ``nbytes``.  The host has no limit to find."""
    _check_probe(x, nbytes)
    scratch = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
    scratch[-1024:] = x.reshape(-1)
    return scratch[-1024:].clone().view_as(x)


def smem_probe(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """x (f32, 1024 elements) copied through the last 4 KB of a dynamic
    shared-memory scratch of ``nbytes``.  CUDA tensors launch kernel 9,
    counted in ``smem_probe.launches`` when the card takes the launch; a
    size above the card's limit a block raises RuntimeError with the
    launch's error.  CPU tensors take :func:`smem_probe_plain`."""
    _check_probe(x, nbytes)
    dev = _device_of(x=x)
    if dev.type == "cpu":
        return smem_probe_plain(x, nbytes)
    check_kernel_operands(x=x)
    from flex_tpu_torch import kernels

    out = torch.empty_like(x)
    kernels.launch("micro", "flex_smem_probe", dev, x.data_ptr(),
                   out.data_ptr(), nbytes)
    smem_probe.launches += 1
    return out


smem_probe.launches = 0


def _query(symbol: str, device, *args) -> int:
    from flex_tpu_torch import kernels

    val = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = getattr(kernels.load("micro"), symbol)(*args, ctypes.byref(val))
    if err:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")
    return val.value


def empty_probe(nbytes: int, device="cuda") -> None:
    """Kernel 9's launch (one block of 256 threads, ``nbytes`` of dynamic
    shared memory) of a kernel that does nothing: the floor under kernel
    9's time on the card.  A yardstick for the timings only, so it is not
    counted and has no plain version."""
    from flex_tpu_torch import kernels

    kernels.launch("micro", "flex_empty_probe", torch.device(device),
                   nbytes)


def smem_optin(device="cuda") -> int:
    """The card's opt-in shared memory a block, in bytes
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``)."""
    return _query("flex_smem_optin", device)


# -- kernel 10 ----------------------------------------------------------------

def slab_gather_plain(slab: torch.Tensor, idx: torch.Tensor,
                      round_bf16: bool = False) -> torch.Tensor:
    """Plain version of :func:`slab_gather`."""
    src = slab.to(torch.bfloat16).float() if round_bf16 else slab
    return src.index_select(0, idx.reshape(-1).long())


def slab_gather(slab: torch.Tensor, idx: torch.Tensor, placement: str = "l2",
                round_bf16: bool = False) -> torch.Tensor:
    """out[r, :] = slab[idx.flat[r], :] (f32 [idx.numel(), k]) for slab f32
    [U, k] and idx i32 of any shape, every index in [0, U); with
    ``round_bf16`` the rows of bf16(slab) widened back (the one-hot bf16
    product's function).  CUDA tensors launch kernel 10 with the slab read
    through L2 (``placement="l2"``) or spread over the shared memory of a
    16-block cluster (``"cluster"``), counted in
    ``slab_gather.launches``; CPU tensors take :func:`slab_gather_plain`
    for either placement."""
    _check("slab", slab, torch.float32, 2)
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, got "
                         f"{placement!r}")
    dev = _device_of(slab=slab, idx=idx)
    if dev.type == "cpu":
        return slab_gather_plain(slab, idx, round_bf16)
    _check_width(slab.shape[1])
    check_kernel_operands(("slab",), slab=slab, idx=idx)
    from flex_tpu_torch import kernels

    U, k = slab.shape
    n = idx.numel()
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    kernels.launch("micro", "flex_slab_gather", dev, slab.data_ptr(),
                   idx.data_ptr(), out.data_ptr(), n, U, k,
                   PLACEMENTS.index(placement), int(bool(round_bf16)))
    slab_gather.launches += 1
    return out


slab_gather.launches = 0


def cluster_occupancy(U: int, k: int, device="cuda") -> int:
    """How many of kernel 10's 16-block clusters fit on the card at once
    for a slab of U rows of k floats (``cudaOccupancyMaxActiveClusters``);
    the cluster placement launches that many."""
    return _query("flex_slab_cluster_occupancy", device, U, k)


# -- kernel 11 ----------------------------------------------------------------

def ell_reduce_plain(v: torch.Tensor, Bg: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ell_reduce`: the product, then the sum over
    j (the JAX script's ``xla_reduce``)."""
    return (v[:, :, None] * Bg).sum(dim=1)


def ell_reduce(v: torch.Tensor, Bg: torch.Tensor) -> torch.Tensor:
    """out[c, :] = Σ_j v[c, j]·Bg[c, j, :] (f32 [N, k]) for v f32 [N, w] and
    Bg f32 [N, w, k].  CUDA tensors launch kernel 11 (exact f32 FMA, j in
    order; k % 4 == 0), counted in ``ell_reduce.launches``; CPU tensors
    take :func:`ell_reduce_plain`."""
    _check("v", v, torch.float32, 2)
    _check("Bg", Bg, torch.float32, 3)
    if tuple(Bg.shape[:2]) != tuple(v.shape):
        raise ValueError(f"Bg {tuple(Bg.shape)} does not match v "
                         f"{tuple(v.shape)}")
    dev = _device_of(v=v, Bg=Bg)
    if dev.type == "cpu":
        return ell_reduce_plain(v, Bg)
    N, w, k = Bg.shape
    if k == 0 or k % 4:
        raise ValueError(f"the kernel takes k % 4 == 0, k > 0; got k={k}")
    check_kernel_operands(("Bg",), v=v, Bg=Bg)
    from flex_tpu_torch import kernels

    out = torch.empty((N, k), dtype=torch.float32, device=dev)
    kernels.launch("micro", "flex_ell_reduce", dev, v.data_ptr(),
                   Bg.data_ptr(), out.data_ptr(), N, w, k)
    ell_reduce.launches += 1
    return out


ell_reduce.launches = 0


# -- kernel 12 ----------------------------------------------------------------

def window_step_bf16_plain(first, out_panel, win_step, A, B, *, n_panels,
                           W):
    """Plain version of :func:`window_step_bf16`: kernel 1's plain version
    on A and B rounded to bf16 (nearest even) and widened back, TF32 off,
    so the products are exact and the sums f32."""
    from flex_tpu_torch.experiments import exact_f32
    from flex_tpu_torch.ops.window_spmm import window_spmm_fwd_plain

    with exact_f32():
        return window_spmm_fwd_plain(
            first, out_panel, win_step, A.to(torch.bfloat16).float(),
            B.to(torch.bfloat16).float(), n_panels=n_panels, W=W)


def window_step_bf16(first, out_panel, win_step, A, B, *, n_panels, W,
                     panel_step_ptr, units=None):
    """out[p] = Σ over used panel p's steps s and windows g of
    bf16(A[s][:, g·W:(g+1)·W]) · bf16(B[win_step[s·G+g]·W : +W]), products
    exact and sums in f32: the TPU's DEFAULT dot on kernel 1's step tables
    (:func:`..ops.window_spmm.window_spmm_fwd`'s arguments, with the same
    operand rules: W % 16 == 0, any k, A 16-byte aligned, B of any
    alignment).  Returns f32 [n_panels·TM, k].

    CUDA tensors cast B once, inside the call, into a bf16 buffer with
    16-byte rows (:func:`..ops.gespmm.to_bf16_padded`, nearest even: the
    plain version's rounding) and launch kernel 12
    (``csrc/winstep_bf16.cu``: a TMA ring of f32 A and bf16 B stages,
    ``wgmma`` with A rounded in registers, f32 accumulators, in kernel 1's
    work units) and, where a panel has several units, kernel 1's pass that
    adds the partial tiles in unit order; counted in
    ``window_step_bf16.launches``.  CPU tensors take
    :func:`window_step_bf16_plain`; any other device raises."""
    from flex_tpu_torch.ops.gespmm import to_bf16_padded
    from flex_tpu_torch.ops.window_spmm import (
        check_step_operands, launch_step_kernel,
    )

    kw = dict(n_panels=n_panels, W=W)
    check_step_operands(first, out_panel, win_step, A, B, **kw,
                        panel_step_ptr=panel_step_ptr, units=units)
    if _device_of(A=A, B=B).type == "cpu":
        return window_step_bf16_plain(first, out_panel, win_step, A, B, **kw)
    if not B.shape[0]:  # one zero row: every window reads zero either way
        B = B.new_zeros((1, B.shape[1]))
    Bb = to_bf16_padded(B)
    out = launch_step_kernel("winstep_bf16", "flex_winstep_bf16", win_step,
                             A, B, **kw, panel_step_ptr=panel_step_ptr,
                             units=units, kernel_B=Bb,
                             extra=(A.shape[0], Bb.stride(0)))
    window_step_bf16.launches += 1
    return out


window_step_bf16.launches = 0


def winstep_layout(W: int) -> dict:
    """Kernel 12's stages at window width W, as the kernel sets them: the
    contraction rows of a stage (``bk``), the ring's ``stages`` and the
    dynamic shared memory of a block (``smem_bytes``)."""
    from flex_tpu_torch import kernels

    vals = [ctypes.c_int(0) for _ in range(3)]
    err = kernels.load("winstep_bf16").flex_winstep_bf16_layout(
        W, *(ctypes.byref(v) for v in vals))
    if err:
        raise ValueError(f"kernel 12 takes W % 16 == 0, got W={W}")
    return dict(zip(("bk", "stages", "smem_bytes"), (v.value for v in vals)))


def wrappers() -> list:
    """Kernels 8-12's wrappers.  They count their launches as the
    package's do, but stay out of :func:`flex_tpu_torch.kernels.wrappers`:
    no path of the package launches them."""
    return [row_gather_sum, smem_probe, slab_gather, ell_reduce,
            window_step_bf16]


def launch_counts() -> dict[str, int]:
    """Wrapper name -> kernel launches in this process so far."""
    return {fn.__name__: fn.launches for fn in wrappers()}


def reset_launch_counts() -> None:
    for fn in wrappers():
        fn.launches = 0
