"""Multi-receptive-field (MRF) vocoder stage: the CUDA kernels' wrappers,
their plain PyTorch versions and the weight packers.

Counterparts of ``cmtts_tpu/ops/mrf_pallas.py``:

- :func:`fused_mrf_stage` replaces ``fused_mrf_stage`` (the VMEM-resident
  Pallas kernel, C <= 128, with the optional fused generator head);
- :func:`fused_mrf_stage_streamed` replaces ``fused_mrf_stage_streamed``
  (the weight-streaming Pallas kernel for the C = 256 stage).

Both launch the hand-written CUDA C++ for sm_90a in ``csrc/``.  In
bfloat16 (the main path) ``mrf_stage_bf16`` of ``csrc/mrf_wg.cu``: a cast
of x into position-major bf16 rows, then each of the stage's convs as one
launch of a warpgroup implicit GEMM on the tensor cores (``wgmma`` with
both operands read by descriptor from shared memory: A from the
activation window, stored in planes of 8 channels that tensor copies of
the producer warp bring in, so that one descriptor serves every tap; B
from weight tiles that the same warp brings into a shared-memory ring by
bulk async copies; :func:`pack_wg_tiles` lays the tiles out), then the
head's kernel.  In float32 ``mrf_stage_f32`` of
``csrc/mrf.cu``: each conv is a launch of a SIMT implicit GEMM (strict
float32 FMAs, register tiles of ``F32_TM`` x ``F32_TN``, K-chunks of
``F32_CHUNK`` input channels staged by ``cp.async`` in a ring of
``F32_STAGES``), then the head's kernel.  Both keep the running y, the
pair's h and the ResBlock sum in device buffers allocated here.  The
sources' headers say what bounds the kernels on an H100 and how their
designs deal with that.  The library is built with ``nvcc`` into
``build/`` at the repository root on first use, under a name that hashes
every file of ``csrc/`` and the flags, and loaded with ``ctypes``.

Layout is channels-first (B, C, L), the kernel's and ``Conv1d``'s layout;
x and the output are float32, and ``compute_dtype`` (float32 or bfloat16)
is the type of the activations inside the stage and of the conv operands,
with float32 accumulation, as the Pallas kernels' ``compute_dtype`` /
``dot_dtype``.  A wrapper runs the plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from cmtts_tpu_torch.core.trace import count

LRELU_SLOPE = 0.1
POST_SLOPE = 0.01
SMEM_LIMIT = 232448          # dynamic shared memory a block may use (H100)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_ROOT, "cmtts_tpu_torch", "csrc")
_BUILD = os.path.join(_ROOT, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the bf16 conv's work split (csrc/mrf_wg.cu): consumer warpgroups a
# block, K values a weight tile (one 128-byte swizzle row), weight tiles in
# the ring, MMA commit groups a warpgroup keeps in flight, the widest block
# in output channels, bf16 pad of an epilogue tile's row, the alignment of
# the ring's swizzle atoms
WG_CONSUMERS, WG_TILE_K, WG_STAGES, WG_MMA_GROUPS = 2, 64, 4, 1
WG_MAX_BN, WG_ROW_PAD, WG_ALIGN = 128, 8, 1024
# rows a tensor copy of a window plane may have, window chunks a slot has
# barriers for
WG_MAX_BOX, WG_MAX_CHUNKS = 256, 8
# threads of a float32 conv block (kThreads of csrc/mrf.cuh) in warps
WARPS = 8
# the float32 conv's work split (csrc/mrf.cu): a thread's register tile
# (positions x output channels), input channels a K-chunk, K-chunks in the
# shared-memory ring, the widest block in output channels; the head's
# positions a block and its widest kernel
F32_TM, F32_TN, F32_CHUNK, F32_STAGES, F32_MAX_BN = 8, 8, 8, 2, 128
F32_HEAD_T, F32_HEAD_C, F32_MAX_POST_K = 256, 32, 17
_lib = None
_lib_lock = threading.Lock()


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
    """The built library at ``path``, with its C entry points' signatures."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.mrf_stage_bf16.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                   i, i, i, i, i, ip, ip, i, p]
    lib.mrf_stage_bf16.restype = ctypes.c_int
    lib.mrf_stage_f32.argtypes = [p, p, p, p, p, p, p, p, p,
                                  i, i, i, i, i, ip, ip, i, p]
    lib.mrf_stage_f32.restype = ctypes.c_int
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
    both entry points: ``(w, b, w_tiles)`` with ``w`` the concatenation, per
    ResBlock, pair and conv (conv1, conv2), of the weight as
    [tap][c_in][c_out] in ``dtype``, ``b`` the float32 biases
    [block][pair][conv][C], and ``w_tiles`` the same weights as the
    bfloat16 kernel's B tiles (:func:`pack_wg_tiles`) -- None in float32,
    whose kernel and plain version read ``w``, and where C is not a
    multiple of 8.  Counterpart of ``pack_mrf_params`` and of
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
    w_tiles = (pack_wg_tiles(w, C, ks, len(block.dilations))
               if dtype == torch.bfloat16 and C % 8 == 0 else None)
    return w, torch.cat(bs).contiguous(), w_tiles


def padded_channels(C: int) -> int:
    """The bf16 kernel's channel count: C rounded up to a k16 step, the
    extra channels zero in the weights, biases and activations."""
    return -(-C // 16) * 16


def wg_block(Cp: int) -> int:
    """BN: a bf16 conv block's output channels, the widest of
    ``WG_MAX_BN``, 64, 32, 16 dividing Cp."""
    return next(bn for bn in (WG_MAX_BN, 64, 32, 16) if Cp % bn == 0)


def wg_chunk(Cp: int) -> int:
    """cw: input channels a chunk of the bf16 conv's window (its K steps
    run chunk by chunk, each over all taps), the widest of 64, 32, 16
    dividing Cp."""
    return next(cw for cw in (64, 32, 16) if Cp % cw == 0)


def wg_steps(Cp: int, k: int):
    """The bf16 conv's k16 steps in order, as (tap, first input channel):
    input-channel chunk, then tap, then 16 channels of the chunk."""
    cw = wg_chunk(Cp)
    return [(t, c + 16 * j) for c in range(0, Cp, cw) for t in range(k)
            for j in range(cw // 16)]


def wg_tile_count(Cp: int, k: int) -> int:
    """Weight tiles of one conv and output-channel block: 4 k16 steps a
    tile, the last one padded with zero steps."""
    return -(-k * Cp // WG_TILE_K)


def wg_tiling(Cp: int):
    """(BN, MT) of a bf16 conv block: ``wg_block``, and MT m64 tiles a
    consumer warpgroup, 1 at BN >= 64 (at BN = 128, 64 accumulators a
    thread an m64 tile, MT = 2 spills; at BN = 64 MT = 1 lets an SM hold
    two blocks, see ``wg_min_blocks`` in csrc/mrf_wg.cu), else 2.  A
    block's position tile is BM = 64 MT ``WG_CONSUMERS``."""
    bn = wg_block(Cp)
    return bn, 1 if bn >= 64 else 2


def wg_window_boxes(Cp: int, k: int, d: int):
    """(copies, rows a copy) of one 8-channel plane of the bf16 conv's
    window: its BM + (k - 1) d positions in as few tensor copies of at
    most ``WG_MAX_BOX`` rows as hold them, the rows rounded up to 8 so that
    every copy lands 128-byte aligned (``win_boxes`` and ``box_rows`` in
    csrc/mrf_wg.cu)."""
    _, mt = wg_tiling(Cp)
    rows = 64 * mt * WG_CONSUMERS + (k - 1) * d
    n = -(-rows // WG_MAX_BOX)
    return n, -(-(-(-rows // n)) // 8) * 8


def wg_window_rows(Cp: int, k: int, d: int) -> int:
    """Rows of one 8-channel plane of the bf16 conv's window: its copies'
    (``win_rows`` in csrc/mrf_wg.cu)."""
    n, box = wg_window_boxes(Cp, k, d)
    return n * box


def wg_smem_bytes(Cp: int, k: int, d: int, conv1: bool,
                  slots: int = 1) -> int:
    """Shared memory of a bf16 conv block with ``slots`` window slots, as
    ``wg_smem_bytes`` in csrc/mrf_wg.cu adds it up: alignment slack, the
    ring of ``WG_STAGES`` weight tiles, each slot's window [Cp / 8]
    [:func:`wg_window_rows`][8] (or the epilogue's tile [BM][BN + 8] that
    it later holds, where that is larger) with, for conv2, the residual
    rows [BM][BN + 8] beside it, the barriers (the ring's, and each slot's
    ``WG_MAX_CHUNKS`` chunk barriers and its empty barrier).  ``launch_wg``
    takes two slots, and makes its blocks persistent, where two fit."""
    bn, mt = wg_tiling(Cp)
    tile = 64 * mt * WG_CONSUMERS * (bn + WG_ROW_PAD) * 2
    slot = (max(Cp * wg_window_rows(Cp, k, d) * 2, tile)
            + (0 if conv1 else tile))
    return (WG_ALIGN + WG_STAGES * bn * WG_TILE_K * 2 + slots * slot
            + (2 * WG_STAGES + 2 * WG_MAX_CHUNKS + 2) * 8)


@functools.lru_cache(maxsize=64)
def wg_two_slot_convs(Cp: int, kernel_sizes: tuple, dilations: tuple) -> int:
    """How many of a stage's conv launches take two window slots (their
    blocks load the next tile's window under this tile's MMAs): the
    convs whose two slots fit, by ``launch_wg``'s rule.  Cached: each
    launch counts it."""
    return sum((wg_smem_bytes(Cp, k, d, True, 2) <= SMEM_LIMIT)
               + (wg_smem_bytes(Cp, k, 1, False, 2) <= SMEM_LIMIT)
               for k in kernel_sizes for d in dilations)


def wg_tile_order(Cp: int, k: int) -> torch.Tensor:
    """Where each element of one conv's packed tiles comes from, as an
    index into its [tap][c_in][c_out] weights padded to Cp channels and
    followed by one zero (index ``k Cp Cp``: padding steps).

    The pack is [Cp / BN][tile][BN / 8 atoms][8 channels][64 K values]:
    tile i holds k16 steps 4i..4i+3 of :func:`wg_steps`; an atom is wgmma's
    K-major layout with the 128-byte swizzle, output channel n of the atom
    in row n % 8 (128 bytes) and K value kk of the tile in 16-byte chunk
    (kk / 8) XOR (n % 8) of the row."""
    bn = wg_block(Cp)
    steps = wg_steps(Cp, k)
    steps = torch.tensor(steps + [(-1, -1)] * (-len(steps) % 4))
    nb, i, a, r, col = torch.meshgrid(
        torch.arange(Cp // bn), torch.arange(wg_tile_count(Cp, k)),
        torch.arange(bn // 8), torch.arange(8), torch.arange(WG_TILE_K),
        indexing="ij")
    kk = ((col // 8) ^ r) * 8 + col % 8         # the K value stored there
    tap, ci0 = steps[4 * i + kk // 16].unbind(-1)
    co = nb * bn + 8 * a + r
    idx = (tap * Cp + ci0 + kk % 16) * Cp + co
    return torch.where(tap >= 0, idx, k * Cp * Cp).reshape(-1)


def pack_wg_tiles(w, C: int, kernel_sizes=(3, 7, 11), n_pairs=3):
    """:func:`pack_mrf_params`'s weights ``w`` as the bfloat16 kernel's B
    tiles: each conv's [tap][c_in][c_out] zero-padded to
    :func:`padded_channels` and reordered by :func:`wg_tile_order`, so that
    the kernel fetches each tile with one bulk copy.  Made once when the
    weights are packed."""
    if C % 8:
        raise ValueError(f"the bf16 kernel takes C a multiple of 8, not {C}")
    if w.numel() != 2 * n_pairs * sum(kernel_sizes) * C * C:
        raise ValueError("packed weights do not match the stage")
    Cp = padded_channels(C)
    out, off = [], 0
    for k in kernel_sizes:
        order = wg_tile_order(Cp, k).to(w.device)
        for _ in range(2 * n_pairs):
            wc = F.pad(w[off: off + k * C * C].view(k, C, C),
                       (0, Cp - C, 0, Cp - C))
            out.append(torch.cat([wc.reshape(-1), wc.new_zeros(1)])[order])
            off += k * C * C
    return torch.cat(out).to(torch.bfloat16).contiguous()


def wg_desc(addr: int) -> int:
    """The kernel's wgmma descriptor of a K-major B tile at shared address
    ``addr`` (``b_desc`` in csrc/mrf_wg.cu): start >> 4 in bits 0-13, LBO
    1 (unused by the swizzled K-major layout) in bits 16-29, SBO 1024 bytes
    >> 4 in bits 32-45, swizzle mode 1 (128 bytes) in bits 62-63."""
    return (((addr & 0x3FFFF) >> 4) | (1 << 16) | ((1024 >> 4) << 32)
            | (1 << 62))


def wg_a_desc(addr: int, lbo: int) -> int:
    """The kernel's wgmma descriptor of a K-major A slice of the window at
    shared address ``addr`` (``a_desc`` in csrc/mrf_wg.cu): start >> 4 in
    bits 0-13, LBO = ``lbo`` (the plane stride between the step's two
    8-channel halves) >> 4 in bits 16-29, SBO 128 bytes (between
    8-position core matrices) >> 4 in bits 32-45, no swizzle (mode 0)."""
    return (((addr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16)
            | ((128 >> 4) << 32))


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

def conv_block(C: int):
    """(BM, BN): the positions and output channels of one block of the
    float32 conv kernel: BN the largest power of two <= ``F32_MAX_BN``
    dividing C, each thread ``F32_TM`` x ``F32_TN`` of the tile."""
    bn = F32_MAX_BN
    while C % bn:
        bn //= 2
    return WARPS * 32 // (bn // F32_TN) * F32_TM, bn


def window_stride(bm: int, k: int, d: int) -> int:
    """Row stride of a K-chunk's activation window: BM + (k - 1) d
    positions, rounded up to 4 floats."""
    return -(-(bm + (k - 1) * d) // 4) * 4


def conv_smem_bytes(C: int, k: int, d: int) -> int:
    """Shared memory of one float32 conv block: ``F32_STAGES`` ring slots,
    each a window [F32_CHUNK][stride] and weights [k][F32_CHUNK][BN]."""
    bm, bn = conv_block(C)
    return 4 * F32_STAGES * F32_CHUNK * (window_stride(bm, k, d) + k * bn)


def kernel_takes(C: int, compute_dtype, kernel_sizes=(3, 7, 11),
                 dilations=(1, 3, 5), post_k: int = 0) -> bool:
    """Whether the kernels take a stage of C channels in ``compute_dtype``
    (with a fused head of ``post_k`` taps when ``post_k`` > 0): C a
    multiple of 8 (bfloat16 pads it to a k16 step; float32 needs a
    thread's 8 channels), every conv's block in shared memory and at most
    ``F32_MAX_POST_K`` head taps (both heads stage that many).  The vocoder
    routes a stage by it when it packs the weights, and the launch refuses
    a stage it rejects."""
    if compute_dtype not in _DTYPE_CODE or C % 8 or post_k > F32_MAX_POST_K:
        return False
    if compute_dtype == torch.bfloat16:
        Cp = padded_channels(C)
        if Cp // wg_chunk(Cp) > WG_MAX_CHUNKS:
            return False
        return all(wg_smem_bytes(Cp, k, d, True) <= SMEM_LIMIT
                   and wg_smem_bytes(Cp, k, 1, False) <= SMEM_LIMIT
                   for k in kernel_sizes for d in dilations)
    return all(conv_smem_bytes(C, k, d) <= SMEM_LIMIT
               for k in kernel_sizes for d in (*dilations, 1))


def _launch(x, packed, kernel_sizes, dilations, compute_dtype, post):
    if compute_dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported compute dtype {compute_dtype}")
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError("x must be a float32 (B, C, L) tensor")
    B, C, L = x.shape
    bf16 = compute_dtype == torch.bfloat16
    w, b, w_tiles = packed
    kw = w_tiles if bf16 else w      # the layout this dtype's kernel reads
    n_conv = 2 * len(kernel_sizes) * len(dilations)
    if not kernel_takes(C, compute_dtype, kernel_sizes, dilations,
                        post[0].shape[0] if post is not None else 0):
        raise ValueError(f"unsupported stage shape C={C} "
                         f"kernel_sizes={kernel_sizes} dilations={dilations} "
                         f"in {compute_dtype}")
    Cp = padded_channels(C)
    n_weights = 2 * len(dilations) * (
        sum(wg_tile_count(Cp, k) for k in kernel_sizes) * Cp * WG_TILE_K
        if bf16 else sum(kernel_sizes) * C * C)
    if kw is None:
        raise ValueError("the bf16 kernel needs the weights as B tiles: "
                         "pack them with pack_mrf_params")
    if kw.dtype != compute_dtype or kw.numel() != n_weights:
        raise ValueError("packed weights do not match the stage")
    if b.dtype != torch.float32 or b.numel() != n_conv * C:
        raise ValueError("packed biases do not match the stage")
    tensors = [x, kw, b] + (list(post) if post is not None else [])
    if any(t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError("all tensors must be contiguous and on one device")
    if post is not None:
        w_post, b_post = post
        if (w_post.dtype != compute_dtype or w_post.dim() != 2
                or w_post.shape[1] != C or b_post.dtype != torch.float32
                or b_post.numel() != 1):
            raise ValueError("packed head does not match the stage")
    out = torch.empty((B, L) if post is not None else (B, C, L),
                      dtype=torch.float32, device=x.device)
    ks = (ctypes.c_int * len(kernel_sizes))(*kernel_sizes)
    ds = (ctypes.c_int * len(dilations))(*dilations)
    post_ptrs = ((post[0].data_ptr(), post[1].data_ptr()) if post is not None
                 else (None, None))
    post_k = post[0].shape[0] if post is not None else 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # the ResBlock sum the head reads: a device buffer of x's shape
    s = torch.empty_like(x) if post is not None else None
    if bf16:
        # the position-major rows: x cast (y0), the pair's h and the running
        # y past the first pair, Cp channels; the biases padded to Cp
        def rows():
            return torch.empty((B, L, Cp), dtype=torch.bfloat16,
                               device=x.device)

        y0, h = rows(), rows()
        y = rows() if len(dilations) > 1 else None
        bp = (b if Cp == C else
              F.pad(b.view(n_conv, C), (0, Cp - C)).reshape(-1))
        err = _library().mrf_stage_bf16(
            x.data_ptr(), out.data_ptr(), kw.data_ptr(), bp.data_ptr(),
            *post_ptrs, y0.data_ptr(), y.data_ptr() if y is not None else None,
            h.data_ptr(), s.data_ptr() if s is not None else None,
            B, C, L, len(kernel_sizes), len(dilations), ks, ds, post_k,
            stream)
    else:
        # the pair's h and the running y (past the first pair): device
        # buffers of x's shape
        h = torch.empty_like(x)
        y = torch.empty_like(x) if len(dilations) > 1 else None
        err = _library().mrf_stage_f32(
            x.data_ptr(), out.data_ptr(), kw.data_ptr(), b.data_ptr(),
            *post_ptrs, y.data_ptr() if y is not None else None,
            h.data_ptr(), s.data_ptr() if s is not None else None,
            B, C, L, len(kernel_sizes), len(dilations), ks, ds, post_k,
            stream)
    if err != 0:
        raise RuntimeError(f"MRF stage launch failed: cudaError_t {err}")
    if bf16:
        count("mrf.wg_convs", n_conv)
        count("mrf.wg_convs_two_slot",
              wg_two_slot_convs(Cp, tuple(kernel_sizes), tuple(dilations)))
    return out


def fused_mrf_stage(x, packed, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5),
                    compute_dtype=torch.float32, post=None):
    """One MRF stage through the CUDA kernels: the bf16 or the float32
    route's launches, a conv each (counterpart of
    ``mrf_pallas.fused_mrf_stage``).  A call that launches counts
    ``mrf.fused_mrf_stage`` (:func:`cmtts_tpu_torch.core.trace.counters`).

    x: (B, C, L) float32.  packed: ``(w, b, w_tiles)`` from
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
    count("mrf.fused_mrf_stage")
    return out


def fused_mrf_stage_streamed(x, packed, kernel_sizes=(3, 7, 11),
                             dilations=(1, 3, 5),
                             compute_dtype=torch.bfloat16):
    """The wide (C = 256) MRF stage, no head (counterpart of
    ``mrf_pallas.fused_mrf_stage_streamed``).  On the TPU its weights did
    not fit in VMEM and were streamed from HBM; on Hopper both routes
    stream each conv's weights through a shared-memory ring: the bf16
    convs a 64-deep K tile at a time by bulk async copies, the float32
    convs a K-chunk at a time by ``cp.async``.  ``packed`` as for
    :func:`fused_mrf_stage`; a call that launches counts
    ``mrf.fused_mrf_stage_streamed``."""
    if x.device.type == "cpu":
        return mrf_stage_plain(x, packed[0], packed[1], kernel_sizes,
                               dilations, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no MRF kernel for device {x.device}")
    out = _launch(x, packed, kernel_sizes, dilations, compute_dtype, None)
    count("mrf.fused_mrf_stage_streamed")
    return out
