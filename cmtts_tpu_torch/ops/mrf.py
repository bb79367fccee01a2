"""Fused multi-receptive-field (MRF) vocoder stage: the CUDA kernel's
wrappers, their plain PyTorch versions and the weight packers.

Counterparts of ``cmtts_tpu/ops/mrf_pallas.py``:

- :func:`fused_mrf_stage` replaces ``fused_mrf_stage`` (the VMEM-resident
  Pallas kernel, C <= 128, with the optional fused generator head);
- :func:`fused_mrf_stage_streamed` replaces ``fused_mrf_stage_streamed``
  (the weight-streaming Pallas kernel for the C = 256 stage).

Both launch ``mrf_stage`` of ``csrc/mrf.cu`` (hand-written CUDA C++ for
sm_90a; its header says what bounds it on an H100 and how the design deals
with that).  The library is built with ``nvcc`` into ``build/`` at the
repository root on first use and loaded with ``ctypes``.

Layout is channels-first (B, C, L), the kernel's and ``Conv1d``'s layout;
x and the output are float32, and ``compute_dtype`` (float32 or bfloat16)
is the type of the activations inside the stage and of the conv operands,
with float32 accumulation, as the Pallas kernels' ``compute_dtype`` /
``dot_dtype``.  A wrapper runs the plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1
POST_SLOPE = 0.01
SMEM_LIMIT = 232448          # dynamic shared memory a block may use (H100)
MAX_TILE = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCE = os.path.join(_ROOT, "cmtts_tpu_torch", "csrc", "mrf.cu")
_LIBRARY = os.path.join(_ROOT, "build", "libcmtts_mrf.so")
_lib = None
_lib_lock = threading.Lock()


def receptive_radius(kernel_sizes, dilations) -> int:
    """Receptive radius of the widest ResBlock (60 for k=11, d=1/3/5)."""
    return max(sum((k - 1) // 2 * d + (k - 1) // 2 for d in dilations)
               for k in kernel_sizes)


# -- build and load ---------------------------------------------------------

def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_kernels(force: bool = False) -> float:
    """Compile ``csrc/mrf.cu`` into ``build/libcmtts_mrf.so`` for sm_90a
    unless an up-to-date library exists.  Returns the seconds spent."""
    if (not force and os.path.exists(_LIBRARY)
            and os.path.getmtime(_LIBRARY) >= os.path.getmtime(_SOURCE)):
        return 0.0
    os.makedirs(os.path.dirname(_LIBRARY), exist_ok=True)
    tmp = f"{_LIBRARY}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, _SOURCE],
        check=True)
    os.replace(tmp, _LIBRARY)
    return time.perf_counter() - t0


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            build_kernels()
            lib = ctypes.CDLL(_LIBRARY)
            p, i = ctypes.c_void_p, ctypes.c_int
            ip = ctypes.POINTER(ctypes.c_int)
            lib.mrf_stage.argtypes = [i, p, p, p, p, p, p, p,
                                      i, i, i, i, i, i, i, i, ip, ip, i, i, p]
            lib.mrf_stage.restype = ctypes.c_int
            _lib = lib
    return _lib


# -- packers ----------------------------------------------------------------

def pack_mrf_params(generator, stage: int, dtype=torch.float32):
    """Pack the ``res_{stage}_{j}`` convs of a port ``HiFiGANGenerator`` into
    the kernel's layout: ``(w, b)`` with ``w`` the concatenation, per
    ResBlock, pair and conv (conv1, conv2), of the weight as
    [tap][c_in][c_out] in ``dtype``, and ``b`` the float32 biases
    [block][pair][conv][C].  Counterpart of ``pack_mrf_params`` and of
    ``pack_mrf_params_streamed``: both kernels take this one layout."""
    ws, bs = [], []
    for j in range(len(generator.cfg.resblock_kernel_sizes)):
        block = getattr(generator, f"res_{stage}_{j}")
        for p in range(len(block.dilations)):
            for name in (f"conv1_{p}", f"conv2_{p}"):
                conv = getattr(block, name)
                ws.append(conv.weight.detach().permute(2, 1, 0).reshape(-1))
                bs.append(conv.bias.detach().float())
    return torch.cat(ws).to(dtype).contiguous(), torch.cat(bs).contiguous()


def pack_post_params(generator, dtype=torch.float32):
    """``conv_post`` as the fused head's ``(w [tap][C] in dtype, b (1,) f32)``.
    Counterpart of ``pack_post_params``."""
    conv = generator.conv_post
    w = conv.weight.detach()[0].t().contiguous().to(dtype)
    return w, conv.bias.detach().float().reshape(1).contiguous()


# -- plain PyTorch versions -------------------------------------------------

def _lrelu(x, slope):
    return torch.maximum(x, x * slope)


def _unpacked(w, b, C, kernel_sizes, n_pairs):
    """Yield (k, [(w1, b1, w2, b2) per pair]) with Conv1d weights (C, C, k)."""
    off = boff = 0
    for k in kernel_sizes:
        pairs = []
        for _ in range(n_pairs):
            convs = []
            for _ in range(2):
                convs.append(w[off: off + k * C * C].view(k, C, C)
                             .permute(2, 1, 0))
                convs.append(b[boff: boff + C])
                off += k * C * C
                boff += C
            pairs.append(convs)
        yield k, pairs


def mrf_stage_plain(x, w, b, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5),
                    compute_dtype=torch.float32, post=None):
    """The fused stage in plain PyTorch, with the kernel's roundings:
    activations in ``compute_dtype``, conv operands in ``compute_dtype``,
    float32 accumulation, the ResBlock sum in float32.

    x (B, C, L) float32 -> (B, C, L) float32, or (B, L) with ``post``."""
    cdt = compute_dtype
    C = x.shape[1]
    acc = None
    for k, pairs in _unpacked(w, b, C, kernel_sizes, len(dilations)):
        half = (k - 1) // 2
        y = x.to(cdt)
        for (w1, b1, w2, b2), d in zip(pairs, dilations):
            h = F.conv1d(_lrelu(y, LRELU_SLOPE).float(), w1.float(), b1,
                         padding=half * d, dilation=d).to(cdt)
            h = _lrelu(h, LRELU_SLOPE)
            h = F.conv1d(h.float(), w2.float(), b2, padding=half).to(cdt)
            y = (y.float() + h.float()).to(cdt)
        acc = y.float() if acc is None else acc + y.float()
    out = acc / len(kernel_sizes)
    if post is None:
        return out
    w_post, b_post = post
    k_post = w_post.shape[0]
    h = _lrelu(out.to(cdt), POST_SLOPE)
    wav = F.conv1d(h.float(), w_post.t().float()[None], b_post,
                   padding=(k_post - 1) // 2).to(cdt)
    return torch.tanh(wav.float())[:, 0]


# -- kernel wrappers --------------------------------------------------------

def plan_tile(C: int, L: int, itemsize: int, halo: int, pad: int):
    """(tile, in_shared): the largest length tile (a multiple of 32, at most
    512) whose y/h buffers (and, with the head, f32 ResBlock sum) fit in
    shared memory; when none does, a 256 tile whose buffers live in a
    global-memory scratch.  ``pad`` > 0 means the head is fused."""
    cap = min(MAX_TILE, -(-L // 32) * 32)
    for tile in range(cap, 0, -32):
        if _smem_bytes(C, tile, itemsize, halo, pad, True) <= SMEM_LIMIT:
            return tile, True
    return min(256, cap), False


def _smem_bytes(C, tile, itemsize, halo, pad, in_shared):
    ab = 2 * C * (tile + 2 * halo) * itemsize if in_shared else 0
    head = C * (tile + 2 * pad) * 4 if pad else 0
    return ab + head


def _launch(x, w, b, kernel_sizes, dilations, compute_dtype, post):
    if compute_dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported compute dtype {compute_dtype}")
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError("x must be a float32 (B, C, L) tensor")
    B, C, L = x.shape
    n_conv = 2 * len(kernel_sizes) * len(dilations)
    if C % 8 or len(kernel_sizes) > 4 or len(dilations) > 4:
        raise ValueError(f"unsupported stage shape C={C} "
                         f"kernel_sizes={kernel_sizes} dilations={dilations}")
    n_weights = 2 * len(dilations) * sum(kernel_sizes) * C * C
    if w.dtype != compute_dtype or w.numel() != n_weights:
        raise ValueError("packed weights do not match the stage")
    if b.dtype != torch.float32 or b.numel() != n_conv * C:
        raise ValueError("packed biases do not match the stage")
    tensors = [x, w, b] + (list(post) if post is not None else [])
    if any(t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError("all tensors must be contiguous and on one device")
    pad = 0
    if post is not None:
        w_post, b_post = post
        if (w_post.dtype != compute_dtype or w_post.dim() != 2
                or w_post.shape[1] != C or b_post.dtype != torch.float32
                or b_post.numel() != 1):
            raise ValueError("packed head does not match the stage")
        pad = (w_post.shape[0] - 1) // 2
    halo = receptive_radius(kernel_sizes, dilations) + pad
    itemsize = torch.tensor([], dtype=compute_dtype).element_size()
    tile, in_shared = plan_tile(C, L, itemsize, halo, pad)
    n_tiles = -(-L // tile)
    scratch = None
    if not in_shared:
        scratch = torch.empty(B * n_tiles * 2 * C * (tile + 2 * halo),
                              dtype=compute_dtype, device=x.device)
    out = torch.empty((B, L) if post is not None else (B, C, L),
                      dtype=torch.float32, device=x.device)
    ks = (ctypes.c_int * len(kernel_sizes))(*kernel_sizes)
    ds = (ctypes.c_int * len(dilations))(*dilations)
    err = _library().mrf_stage(
        _DTYPE_CODE[compute_dtype], x.data_ptr(), out.data_ptr(),
        w.data_ptr(), b.data_ptr(),
        post[0].data_ptr() if post is not None else None,
        post[1].data_ptr() if post is not None else None,
        scratch.data_ptr() if scratch is not None else None,
        B, C, L, tile, halo, pad, len(kernel_sizes), len(dilations), ks, ds,
        post[0].shape[0] if post is not None else 0,
        _smem_bytes(C, tile, itemsize, halo, pad, in_shared),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mrf_stage launch failed: cudaError_t {err}")
    return out


def fused_mrf_stage(x, packed, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5),
                    compute_dtype=torch.float32, post=None):
    """One MRF stage with its weights read from L2 by the CUDA kernel
    (counterpart of ``mrf_pallas.fused_mrf_stage``).

    x: (B, C, L) float32.  packed: ``(w, b)`` from :func:`pack_mrf_params`
    in ``compute_dtype``.  post: optional ``(w, b)`` from
    :func:`pack_post_params` — fuses leaky_relu(0.01) -> conv_post -> tanh
    and returns the (B, L) waveform instead of the (B, C, L) stage output.
    """
    w, b = packed
    if x.device.type == "cpu":
        return mrf_stage_plain(x, w, b, kernel_sizes, dilations,
                               compute_dtype, post)
    if x.device.type != "cuda":
        raise ValueError(f"no MRF kernel for device {x.device}")
    out = _launch(x, w, b, kernel_sizes, dilations, compute_dtype, post)
    fused_mrf_stage.launches += 1
    return out


fused_mrf_stage.launches = 0


def fused_mrf_stage_streamed(x, w, b, kernel_sizes=(3, 7, 11),
                             dilations=(1, 3, 5),
                             compute_dtype=torch.bfloat16):
    """The wide (C = 256) MRF stage, no head (counterpart of
    ``mrf_pallas.fused_mrf_stage_streamed``).  On the TPU its weights did
    not fit in VMEM and were streamed from HBM; on Hopper no stage's weights
    fit in shared memory, and the kernel reads them from L2 for every
    stage.  Where its activation buffers do not fit in shared memory (C =
    256 in float32), they live in a global-memory scratch."""
    if x.device.type == "cpu":
        return mrf_stage_plain(x, w, b, kernel_sizes, dilations,
                               compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no MRF kernel for device {x.device}")
    out = _launch(x, w, b, kernel_sizes, dilations, compute_dtype, None)
    fused_mrf_stage_streamed.launches += 1
    return out


fused_mrf_stage_streamed.launches = 0
