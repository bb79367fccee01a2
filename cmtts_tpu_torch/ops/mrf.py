"""Fused multi-receptive-field (MRF) vocoder stage: the CUDA kernel's
wrappers, their plain PyTorch versions and the weight packers.

Counterparts of ``cmtts_tpu/ops/mrf_pallas.py``:

- :func:`fused_mrf_stage` replaces ``fused_mrf_stage`` (the VMEM-resident
  Pallas kernel, C <= 128, with the optional fused generator head);
- :func:`fused_mrf_stage_streamed` replaces ``fused_mrf_stage_streamed``
  (the weight-streaming Pallas kernel for the C = 256 stage).

Both launch ``mrf_stage`` of the hand-written CUDA C++ for sm_90a in
``csrc/``: in float32 the SIMT kernel of ``csrc/mrf.cu``, in bfloat16 (the
main path) the tensor-core kernel of ``csrc/mrf_tc.cu``, which reads its
weights in ``mma.sync`` B-fragment order (:func:`pack_mrf_fragments`; a
stage's pack carries both layouts and the wrapper picks one).  The
sources' headers say what bounds the kernels on an H100 and how their
designs deal with that.  The library is built with ``nvcc`` into ``build/``
at the repository root on first use, under a name that hashes every file of
``csrc/`` and the flags, and loaded with ``ctypes``.

Layout is channels-first (B, C, L), the kernel's and ``Conv1d``'s layout;
x and the output are float32, and ``compute_dtype`` (float32 or bfloat16)
is the type of the activations inside the stage and of the conv operands,
with float32 accumulation, as the Pallas kernels' ``compute_dtype`` /
``dot_dtype``.  A wrapper runs the plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1
POST_SLOPE = 0.01
SMEM_LIMIT = 232448          # dynamic shared memory a block may use (H100)
MAX_TILE = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_ROOT, "cmtts_tpu_torch", "csrc")
_BUILD = os.path.join(_ROOT, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
ROW_PAD = 8                  # bf16 pad of a position's activation row
# the bf16 kernel's work split (kWarps of csrc/mrf.cuh, kMT of
# csrc/mrf_tc.cu): warps of a block, m16 tiles of a warp pass
WARPS, PASS_TILES = 8, 8
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


def library_path(csrc: str = _CSRC, flags=NVCC_FLAGS) -> str:
    """Where the library built from ``csrc`` with ``flags`` lives: its name
    hashes the name and bytes of every file of ``csrc`` (sources and
    headers) and the flags, so that any change to them asks for a build."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    h.update("\0".join(flags).encode())
    return os.path.join(_BUILD, f"libcmtts_mrf-{h.hexdigest()[:16]}.so")


def compile_library(lib: str) -> str:
    """Compile each ``.cu`` file of ``csrc/`` to an object with an ``nvcc``
    of its own, all started together, and link the objects into the shared
    library ``lib``.  Returns the compiler's output (ptxas registers and
    spills per kernel); raises if a step fails."""
    nvcc = _nvcc()
    sources = [os.path.join(_CSRC, n) for n in sorted(os.listdir(_CSRC))
               if n.endswith(".cu")]
    objs = [f"{lib}.{os.path.basename(s)}.o" for s in sources]

    def run(cmd):
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
        return res.stdout + res.stderr

    with ThreadPoolExecutor(len(sources)) as pool:
        logs = list(pool.map(
            run, [[nvcc, *NVCC_FLAGS, "-c", s, "-o", o]
                  for s, o in zip(sources, objs)]))
    logs.append(run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib, *objs]))
    for o in objs:
        os.remove(o)
    return "".join(logs)


def build_kernels(force: bool = False) -> float:
    """Build the library of ``csrc/`` for sm_90a (:func:`compile_library`)
    unless the library of these sources and flags exists.  The compiler's
    output is kept beside it in ``<library>.log``.  Returns the seconds
    spent."""
    lib = library_path()
    if not force and os.path.exists(lib):
        return 0.0
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    log = compile_library(tmp)
    with open(lib + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, lib)
    return time.perf_counter() - t0


def load_library(path: str):
    """The built library at ``path``, with ``mrf_stage``'s C signature."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.mrf_stage.argtypes = [i, p, p, p, p, p, p, p,
                              i, i, i, i, i, i, i, i, ip, ip, i, i, p]
    lib.mrf_stage.restype = ctypes.c_int
    return lib


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            build_kernels()
            _lib = load_library(library_path())
    return _lib


# -- packers ----------------------------------------------------------------

def pack_mrf_params(generator, stage: int, dtype=torch.float32):
    """Pack the ``res_{stage}_{j}`` convs of a port ``HiFiGANGenerator`` for
    both entry points: ``(w, b, w_frag)`` with ``w`` the concatenation, per
    ResBlock, pair and conv (conv1, conv2), of the weight as
    [tap][c_in][c_out] in ``dtype``, ``b`` the float32 biases
    [block][pair][conv][C], and ``w_frag`` the same weights in the bfloat16
    kernel's order (:func:`pack_mrf_fragments`) -- None in float32, whose
    kernel and plain version read ``w``, and where C is not a multiple of
    16.  Counterpart of ``pack_mrf_params`` and of
    ``pack_mrf_params_streamed``."""
    ks = generator.cfg.resblock_kernel_sizes
    ws, bs = [], []
    for j in range(len(ks)):
        block = getattr(generator, f"res_{stage}_{j}")
        for p in range(len(block.dilations)):
            for name in (f"conv1_{p}", f"conv2_{p}"):
                conv = getattr(block, name)
                ws.append(conv.weight.detach().permute(2, 1, 0).reshape(-1))
                bs.append(conv.bias.detach().float())
    w = torch.cat(ws).to(dtype).contiguous()
    C = conv.weight.shape[0]
    w_frag = (pack_mrf_fragments(w, C, ks, len(block.dilations))
              if dtype == torch.bfloat16 and C % 16 == 0 else None)
    return w, torch.cat(bs).contiguous(), w_frag


def fragment_order(C: int, k: int) -> torch.Tensor:
    """The permutation that puts one conv's [tap][c_in][c_out] weights in
    the bf16 kernel's ``mma.sync.m16n8k16`` B-fragment order:
    ``frag = w.reshape(-1)[fragment_order(C, k)]``.

    The order is [tap][c_in step s of 16][c_out pair q of n8 tiles][lane]
    [8]: lane ``4 g + t`` holds b0, b1 of n8 tile 2q, then b0, b1 of tile
    2q + 1, where (PTX's B layout) b0 = w[16 s + 2t + (0, 1)][8 n + g] and
    b1 = w[16 s + 2t + 8 + (0, 1)][8 n + g] of n8 tile n.  So a lane reads
    its fragments of a step and a pair with one 16-byte load."""
    tap, s, q, lane, e = torch.meshgrid(
        torch.arange(k), torch.arange(C // 16), torch.arange(C // 16),
        torch.arange(32), torch.arange(8), indexing="ij")
    n8 = 2 * q + e // 4
    ci = 16 * s + 2 * (lane % 4) + 8 * (e // 2 % 2) + e % 2
    co = 8 * n8 + lane // 4
    return ((tap * C + ci) * C + co).reshape(-1)


def pack_mrf_fragments(w, C: int, kernel_sizes=(3, 7, 11), n_pairs=3):
    """:func:`pack_mrf_params`'s weights ``w`` with each conv reordered by
    :func:`fragment_order`: the layout the bfloat16 kernel reads.  A pure
    permutation, made once when the weights are packed."""
    if C % 16:
        raise ValueError(f"the bf16 kernel takes C a multiple of 16, not {C}")
    if w.numel() != 2 * n_pairs * sum(kernel_sizes) * C * C:
        raise ValueError("packed weights do not match the stage")
    out, off = [], 0
    for k in kernel_sizes:
        order = fragment_order(C, k).to(w.device)
        for _ in range(2 * n_pairs):
            out.append(w[off: off + k * C * C][order])
            off += k * C * C
    return torch.cat(out).contiguous()


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
    global-memory scratch (float32 only).  ``pad`` > 0 means the head is
    fused."""
    cap = min(MAX_TILE, -(-L // 32) * 32)
    for tile in range(cap, 0, -32):
        if _smem_bytes(C, tile, itemsize, halo, pad, True) <= SMEM_LIMIT:
            return tile, True
    return min(256, cap), False


def _smem_bytes(C, tile, itemsize, halo, pad, in_shared):
    """Shared memory of a block: y and h, float32 as [C][W], bfloat16 as
    [W][C + ROW_PAD]; with the head, the f32 ResBlock sum [C][tile + 2 pad].
    """
    row = C + ROW_PAD if itemsize == 2 else C
    ab = 2 * row * (tile + 2 * halo) * itemsize if in_shared else 0
    head = C * (tile + 2 * pad) * 4 if pad else 0
    return ab + head


def kernel_takes(C: int, compute_dtype, kernel_sizes=(3, 7, 11),
                 dilations=(1, 3, 5), post_k: int = 0) -> bool:
    """Whether the kernels take a stage of C channels in ``compute_dtype``
    (with a fused head of ``post_k`` taps when ``post_k`` > 0): C a
    multiple of 16 in bfloat16 (one k16 step of ``mma.sync``) or of 8 in
    float32, at most 4 ResBlocks and 4 dilation pairs, and in bfloat16 the
    smallest length tile's buffers in shared memory.  The vocoder routes a
    stage by it when it packs the weights, and the launch refuses a stage
    it rejects."""
    if compute_dtype not in _DTYPE_CODE:
        return False
    bf16 = compute_dtype == torch.bfloat16
    if C % (16 if bf16 else 8) or len(kernel_sizes) > 4 or len(dilations) > 4:
        return False
    pad = (post_k - 1) // 2 if post_k else 0
    halo = receptive_radius(kernel_sizes, dilations) + pad
    return not bf16 or _smem_bytes(C, 32, 2, halo, pad, True) <= SMEM_LIMIT


def _launch(x, packed, kernel_sizes, dilations, compute_dtype, post):
    if compute_dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported compute dtype {compute_dtype}")
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError("x must be a float32 (B, C, L) tensor")
    B, C, L = x.shape
    bf16 = compute_dtype == torch.bfloat16
    w, b, w_frag = packed
    kw = w_frag if bf16 else w       # the layout this dtype's kernel reads
    n_conv = 2 * len(kernel_sizes) * len(dilations)
    if not kernel_takes(C, compute_dtype, kernel_sizes, dilations,
                        post[0].shape[0] if post is not None else 0):
        raise ValueError(f"unsupported stage shape C={C} "
                         f"kernel_sizes={kernel_sizes} dilations={dilations} "
                         f"in {compute_dtype}")
    n_weights = 2 * len(dilations) * sum(kernel_sizes) * C * C
    if kw is None:
        raise ValueError("the bf16 kernel needs the weights in fragment "
                         "order: pack them with pack_mrf_params")
    if kw.dtype != compute_dtype or kw.numel() != n_weights:
        raise ValueError("packed weights do not match the stage")
    if b.dtype != torch.float32 or b.numel() != n_conv * C:
        raise ValueError("packed biases do not match the stage")
    tensors = [x, kw, b] + (list(post) if post is not None else [])
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
    if not in_shared:   # float32 only: kernel_takes holds bf16 in shared
        scratch = torch.empty(B * n_tiles * 2 * C * (tile + 2 * halo),
                              dtype=compute_dtype, device=x.device)
    out = torch.empty((B, L) if post is not None else (B, C, L),
                      dtype=torch.float32, device=x.device)
    ks = (ctypes.c_int * len(kernel_sizes))(*kernel_sizes)
    ds = (ctypes.c_int * len(dilations))(*dilations)
    err = _library().mrf_stage(
        _DTYPE_CODE[compute_dtype], x.data_ptr(), out.data_ptr(),
        kw.data_ptr(), b.data_ptr(),
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

    x: (B, C, L) float32.  packed: ``(w, b, w_frag)`` from
    :func:`pack_mrf_params` in ``compute_dtype``.  post: optional ``(w, b)``
    from :func:`pack_post_params` — fuses leaky_relu(0.01) -> conv_post ->
    tanh and returns the (B, L) waveform instead of the (B, C, L) stage
    output.
    """
    if x.device.type == "cpu":
        return mrf_stage_plain(x, packed[0], packed[1], kernel_sizes,
                               dilations, compute_dtype, post)
    if x.device.type != "cuda":
        raise ValueError(f"no MRF kernel for device {x.device}")
    out = _launch(x, packed, kernel_sizes, dilations, compute_dtype, post)
    fused_mrf_stage.launches += 1
    return out


fused_mrf_stage.launches = 0


def fused_mrf_stage_streamed(x, packed, kernel_sizes=(3, 7, 11),
                             dilations=(1, 3, 5),
                             compute_dtype=torch.bfloat16):
    """The wide (C = 256) MRF stage, no head (counterpart of
    ``mrf_pallas.fused_mrf_stage_streamed``).  On the TPU its weights did
    not fit in VMEM and were streamed from HBM; on Hopper no stage's weights
    fit in shared memory, and the kernel reads them from L2 for every
    stage.  Where its activation buffers do not fit in shared memory (C =
    256 in float32), they live in a global-memory scratch.  ``packed`` as
    for :func:`fused_mrf_stage`."""
    if x.device.type == "cpu":
        return mrf_stage_plain(x, packed[0], packed[1], kernel_sizes,
                               dilations, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no MRF kernel for device {x.device}")
    out = _launch(x, packed, kernel_sizes, dilations, compute_dtype, None)
    fused_mrf_stage_streamed.launches += 1
    return out


fused_mrf_stage_streamed.launches = 0
