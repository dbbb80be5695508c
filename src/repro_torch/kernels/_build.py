"""Build, load and launch the hand-written CUDA kernels.

The sources in ``csrc/`` (``SOURCES``, which include ``HEADERS``) are
compiled by ``nvcc`` at first use, one ``nvcc`` per source, all started
together, and linked into ``build/repro_torch/libfog_<hash>.so`` under the
repository root (the hash covers the sources, the headers and the flags,
so an edit rebuilds).  The library is
loaded with ``ctypes`` and called through a plain C interface: every
pointer and the stream as ``c_void_p``, every int as ``c_int``, a float
scale as ``c_float``.  Each C
entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises on anything but 0 and counts
the launch.

A failed build raises with nvcc's output.  Nothing here falls back to the
plain PyTorch versions: a CUDA tensor either runs the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "fog_kernels.cu", CSRC / "histogram.cu",
           CSRC / "tree_traverse.cu", CSRC / "ssd_chunk.cu",
           CSRC / "ssd_chunk_sm90.cu", CSRC / "flash_attention.cu",
           CSRC / "flash_attention_sm90.cu")
HEADERS = (CSRC / "fog_tables.cuh", CSRC / "fog_stage.cuh",
           CSRC / "sm90_common.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# -fmad=false: no multiply-add contraction, so the kernels round exactly
# as the plain versions do (the sources also use explicit _rn intrinsics);
# -Xptxas=-v reports registers and spills per kernel into the build log
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xptxas=-v",
              "-Xcompiler", "-fPIC")

# launches per kernel, counted where each kernel is launched and nowhere
# else; kernels.ops re-exports this dict as ``ops.launches``
launches = {"fused_fog": 0, "grove_aggregate": 0, "top2_confidence": 0,
            "histogram": 0, "tree_traverse": 0, "ssd_chunk": 0,
            "flash_attention": 0}
# the same launches by C entry point, where a kernel has several routes
# ("flash_attention" and "ssd_chunk" on CUDA cores, "flash_attention_sm90"
# and "ssd_chunk_sm90" on the tensor cores; "fused_fog" and
# "tree_traverse" one thread per lane, "fused_fog_smem" and "fused_fog_l1"
# the group kernel with the field in shared memory or read through L1,
# "tree_traverse_spread" the spread kernel; "grove_aggregate" one thread
# per lane, "grove_aggregate_tile" the warp-tile kernel)
routes = {"flash_attention": 0, "flash_attention_sm90": 0, "ssd_chunk": 0,
          "ssd_chunk_sm90": 0, "fused_fog": 0, "fused_fog_smem": 0,
          "fused_fog_l1": 0, "tree_traverse": 0, "tree_traverse_spread": 0,
          "grove_aggregate": 0, "grove_aggregate_tile": 0}

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fog_top2_confidence": (P, P, P, I, I, I, I, P),
    "fog_grove_aggregate": (P, P, P, P, P, P, P, P, P, I, I, I, P),
    "fog_grove_aggregate_tile": (*[P] * 9, I, I, I, I, I, P),
    "fog_fused_fog": (I, P, P, P, P, P, P, P, P, P, P, P, P,
                      I, I, I, I, I, I, I, I, I, P),
    "fog_histogram": (P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P),
    "fog_fused_fog_smem": (I, *[P] * 11, *[I] * 14, P),
    "fog_fused_fog_l1": (I, *[P] * 11, *[I] * 14, P),
    "fog_tree_traverse": (I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                          P),
    "fog_tree_traverse_spread": (I, *[P] * 7, *[I] * 10, P),
    "fog_ssd_chunk": (I, P, P, P, P, P, P, P, I, I, I, I, I, P),
    "fog_ssd_chunk_sm90": (P, P, P, P, P, P, I, I, I, I, I, I, P),
    "fog_flash_attention": (I, P, P, P, P, I, I, I, I, I, I, I, F, I, P),
    "fog_flash_attention_sm90": (P, P, P, P, I, I, I, I, I, I, I, F, I, P),
    # a device query, not a kernel
    "fog_smem_optin": (I, P),
    # a latency probe, not an inference kernel: never counted in launches
    "fog_chase": (P, I, P, P),
    # a kernel that does nothing (the device time of a launch): never
    # counted in launches
    "fog_empty": (P,),
    # one wgmma tile product of each form flash_attention_sm90 issues, and
    # of the forms ssd_chunk_sm90 adds, for the tests: never counted in
    # launches
    "fog_wgmma_probe": (P, P, P, P, P, I, P),
    "fog_wgmma_probe_ssd": (P, P, P, P, P, P, P),
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "need the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfog_{h.hexdigest()[:16]}.so"


def _run(procs: list) -> str:
    """Wait for every ``(cmd, Popen)``; raise with nvcc's output on the
    first failure; return the joined logs."""
    logs, failed = [], None
    for cmd, proc in procs:
        out, err = proc.communicate()
        logs.append(out + err)
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed (exit {proc.returncode}): "
                      f"{' '.join(cmd)}\n{out}{err}")
    if failed is not None:
        raise RuntimeError(failed)
    return "".join(logs)


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the
    shared library's path.  ``build_info`` records seconds and nvcc's log."""
    out = library_path()
    if out.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("log", "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                for src, o in zip(SOURCES, objs)]
    log = _run([(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))
                for c in compiles])
    tmp = out.with_name(f"{tag}.tmp.so")
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    log += _run([(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True))])
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    os.replace(tmp, out)   # atomic: concurrent builds race harmlessly
    build_info.update(seconds=seconds, log=log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        lib.fog_error_string.argtypes = [ctypes.c_int]
        lib.fog_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_block(block_b: int) -> None:
    if block_b < 32 or block_b > 1024 or block_b % 32:
        raise ValueError(f"block_b is the CUDA threads per block: a multiple "
                         f"of 32 in [32, 1024], got {block_b}")


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``ndim``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_tma(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` is contiguous and starts on a 16-byte boundary, as
    a TMA tensor map of the tensor-core kernels needs (their row strides
    are multiples of 16 bytes by their route rules)."""
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous for the tensor-core "
                         f"kernel's TMA loads")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary for the "
                         f"tensor-core kernel's TMA loads")


def launch(kernel: str, device: torch.device, *args,
           entry: str | None = None) -> None:
    """Call C entry point ``fog_<entry>`` (default ``fog_<kernel>``) on
    ``device``'s current stream, raise on a launch error, and count one
    launch of ``kernel`` (and of ``entry`` in ``routes``)."""
    entry = entry or kernel
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"fog_{entry}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"fog_{entry} launch failed: CUDA error {rc} "
                           f"({lib.fog_error_string(rc).decode()})")
    launches[kernel] += 1
    if entry in routes:
        routes[entry] += 1


def smem_optin(device: torch.device) -> int:
    """Bytes of shared memory one block of a kernel on ``device`` may opt
    into (``cudaDevAttrMaxSharedMemoryPerBlockOptin``)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _smem_optin(index)


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors on ``device``."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _sm_count(index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    out = ctypes.c_int(0)
    rc = library().fog_smem_optin(index, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"fog_smem_optin failed: CUDA error {rc}")
    return out.value
