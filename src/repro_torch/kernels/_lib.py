"""Build, load and count the port's CUDA kernels.

Every `csrc/*.cu` source has a plain C interface and is compiled by `nvcc`
for `sm_90a` (one `nvcc -c` per source, all started together), then linked
into one shared library that `ctypes` loads. The build runs at the first
kernel launch, never at import, into `build/repro_torch/<hash>/` at the root
of the checkout (listed in `.gitignore`); the hash covers the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

Each kernel wrapper adds one to its launch count where it launches, and
nowhere else (`launch`), so a run can show that its main path went
through the kernels.

The launch path is the one all wrappers share, so it is kept short: the
first launch builds and loads the library under `_LOCK` and resolves every
launcher once into `_FNS`, a table of ctypes function objects; later
launches take no lock, look the function up in that table, call it, and
count the launch with `next()` on the name's `itertools.count`, one C call
that the GIL does not split, so concurrent launches from several threads
are each counted exactly once without a second lock.

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
import itertools
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("topk_select.cu", "randtopk_mask.cu", "encode_rows.cu",
           "pack_bits.cu", "decode_rows.cu", "quantize.cu",
           "flash_attention.cu")
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures (argtypes) of the exported launchers; each returns the
#: `cudaGetLastError()` of its launch as an int
SIGNATURES = {
    # x, x_is_bf16, rows, d, k, mask(u8), thr(f32), stream
    "topk_mask_threshold": (_P, _I, _I, _I, _I, _P, _P, _P),
    # x, x_is_bf16, mask(u8), rows, d, kind, k, bits, out0, out1, out2, stream
    "encode_rows": (_P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # x, x_is_bf16, mask(u8), rows, d, kind, k, bits, select, out0, out1,
    # out2, idx_words, code_words, stream
    "encode_sections": (_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                        _P, _P),
    # vals(i32), n, width, out(i32 words), stream
    "pack_bits": (_P, ctypes.c_longlong, _I, _P, _P),
    # xbuf, xbuf_is_bf16, cap1, d, slots(i32), n, kind, k, values, indices,
    # header, stream
    "decode_to_slots": (_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P),
    # x, x_is_bf16, gumbel(f32), m(i32), rows, d, k, mask(u8), stream
    "randtopk_mask": (_P, _I, _P, _P, _I, _I, _I, _P, _P),
    # values, vals_is_bf16, indices, header, rows, d, kind, k, out,
    # out_is_bf16, stream
    "decode_rows": (_P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _P),
    # values, vals_is_bf16, indices, header, rows, d, kind, k, w(f32), p,
    # scratch(f32), out, out_is_bf16, stream
    "decode_rows_project": (_P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P,
                            _I, _P),
    # values, vals_is_bf16, indices(i32), rows, d, k, out, stream
    "scatter_rows": (_P, _I, _P, _I, _I, _I, _P, _P),
    # x, x_is_bf16, rows, d, bits, code(u8), deq, lo(f32), step(f32), stream
    "quantize": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # q, k, v (bf16), B, S, Hq, Hkv, hd, causal, window, scale_log2, out,
    # stream
    "flash_attention": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P),
    # q, k, v, is_bf16, B, S, Hq, Hkv, hd, bq, bk, causal, window, scale,
    # out, stream
    "flash_attention_simt": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _F, _P, _P),
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
_FNS: dict = {}
LAST_BUILD_LOG = ""

_LAUNCHES = {name: itertools.count() for name in SIGNATURES}


def _count_of(counter) -> int:
    """The next value of an `itertools.count`, without advancing it."""
    return int(repr(counter)[len("count("):-1])


def launch_counts() -> dict:
    return {name: _count_of(c) for name, c in _LAUNCHES.items()}


def reset_launch_counts() -> None:
    """Zero every count; call it while no other thread launches."""
    for name in _LAUNCHES:
        _LAUNCHES[name] = itertools.count()


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


def _load() -> ctypes.CDLL:
    return ctypes.CDLL(str(_build()))


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), its launchers
    resolved into `_FNS`."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = _load()
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _FNS[name] = fn
            _LIB = lib
        return _LIB


def launch(name: str, *args) -> None:
    """Call one exported launcher on the current stream's handle (the last
    argument), raise on a nonzero `cudaGetLastError()`, count the launch."""
    fn = _FNS.get(name)
    if fn is None:
        library()
        fn = _FNS[name]
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    next(_LAUNCHES[name])


def stream_handle(t) -> int:
    """The raw handle of the current CUDA stream of `t`'s device, read as
    PyTorch's own Triton launcher reads it
    (`torch._C._cuda_getCurrentRawStream`), without building a
    `torch.cuda.Stream` object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())
