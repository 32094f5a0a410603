"""Build, load and count the port's CUDA kernels.

Every `csrc/*.cu` source has a plain C interface and is compiled by `nvcc`
for `sm_90a` (one `nvcc -c` per source, all started together), then linked
into one shared library that `ctypes` loads. The build runs at the first
kernel launch, never at import, into `build/repro_torch/<hash>/` at the root
of the checkout (listed in `.gitignore`); the hash covers the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

Each kernel wrapper adds one to its launch count where it launches, and
nowhere else (`count_launch`), so a run can show that its main path went
through the kernels.

Every wrapper takes `backend=` and resolves it with `resolve_backend`, the
counterpart of the reference's `selection._resolve_backend`:

  * ``None`` / ``"auto"`` — the CUDA kernel for a CUDA tensor, the plain
    PyTorch version (`ref.py`) for a CPU tensor;
  * ``"torch"`` — the plain version on any device;
  * ``"cuda"``  — the kernel; raises for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("topk_select.cu", "encode_rows.cu", "pack_bits.cu",
           "decode_to_slots.cu")
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures (argtypes) of the exported launchers; each returns the
#: `cudaGetLastError()` of its launch as an int
SIGNATURES = {
    # x, x_is_bf16, rows, d, k, mask(u8), thr(f32), stream
    "topk_mask_threshold": (_P, _I, _I, _I, _I, _P, _P, _P),
    # x, x_is_bf16, mask(u8), rows, d, kind, k, bits, out0, out1, out2, stream
    "encode_rows": (_P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # vals(i32), n, width, out(i32 words), stream
    "pack_bits": (_P, ctypes.c_longlong, _I, _P, _P),
    # xbuf, xbuf_is_bf16, cap1, d, slots(i32), n, kind, k, values, indices,
    # header, stream
    "decode_to_slots": (_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P),
}

BACKENDS = ("auto", "torch", "cuda")


def resolve_backend(backend, t) -> str:
    """"cuda" or "torch" for tensor `t` (see the module docstring)."""
    backend = backend or "auto"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "auto":
        return "cuda" if t.is_cuda else "torch"
    if backend == "cuda" and not t.is_cuda:
        raise ValueError("backend='cuda' needs a CUDA tensor")
    return backend


_LOCK = threading.Lock()
_LIB = None
LAST_BUILD_LOG = ""

_COUNT_LOCK = threading.Lock()
_LAUNCHES = {name: 0 for name in SIGNATURES}


def count_launch(name: str) -> None:
    with _COUNT_LOCK:
        _LAUNCHES[name] += 1


def launch_counts() -> dict:
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from src/repro_torch/csrc at first use")
    return path


def _build() -> pathlib.Path:
    """Compile every source in parallel, link one .so, return its path."""
    global LAST_BUILD_LOG
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode() + path.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "librepro_torch_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in SOURCES:
        obj = out_dir / (src[:-3] + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    LAST_BUILD_LOG = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{LAST_BUILD_LOG}")
    tmp = out_dir / f"lib.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp),
         *[str(out_dir / (s[:-3] + ".o")) for s in SOURCES]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    (out_dir / "build.log").write_text(LAST_BUILD_LOG)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def launch(name: str, *args) -> None:
    """Call one exported launcher on the current stream's handle (the last
    argument), raise on a nonzero `cudaGetLastError()`, count the launch."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    count_launch(name)


def stream_handle(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
