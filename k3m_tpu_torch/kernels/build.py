"""Builds the port's CUDA kernels into one shared library and loads it.

The sources under `kernels/csrc/` have a plain C interface (no PyTorch
headers), so `nvcc` compiles each one in seconds. At first use every `.cu`
file is compiled by its own `nvcc` process, all started together, and the
objects are linked into `libk3m_kernels.so`. The library lives in
`build/k3m_tpu_torch/<hash of the sources>/` at the root of the checkout,
so a changed source is rebuilt and an unchanged one is reused. Nothing here
runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "k3m_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# dtype codes of the C interface (csrc/common.cuh k3m::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256()
    for p in cu + cuh + [Path(__file__)]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Start every command at once; raise with its output if one fails,
    else return their joined output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    logs, failed = [], False
    for cmd, p in procs:
        out, _ = p.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        failed |= p.returncode != 0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(logs))
    return "\n".join(logs)


def build(verbose: bool = False) -> Path:
    """Compile the library if it is not built yet; return its path. With
    `verbose`, ptxas reports each kernel's registers, shared memory and
    spills into `ptxas.log` beside the library."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libk3m_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu, _ = _sources()
    flags = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                          "-I", str(CSRC)]
    if verbose:
        flags += ["-Xptxas", "-v"]
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in cu]
        log = _run_all([[nvcc, *flags, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(cu, objs)])
        tmp_lib = Path(tmp) / lib_path.name
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                   *map(str, objs)]])
        os.replace(tmp_lib, lib_path)   # atomic: readers never see half a file
    if verbose:
        (out_dir / "ptxas.log").write_text(log)
    return lib_path


def _declare(lib):
    P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.k3m_layernorm_fwd.argtypes = [P, I, P, I, P, P, P, I, P, I, I, F, I, P]
    lib.k3m_ln_bwd_bands.argtypes = [I]
    lib.k3m_layernorm_bwd.argtypes = [P, I, P, P, P, P, P, I, P, P, P, I, I, P]
    lib.k3m_attention_fwd.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, P, F,
                                      U, U, F, I, I, I, P]
    lib.k3m_attention_bwd.argtypes = [P, P, P, P, P, P, P, P, P, P, P, P,
                                      I, I, I, I, I, I, P, F, U, F, P]
    lib.k3m_biattention_fwd.argtypes = [P, P, P, P, P, P, P, P, P, P, P, P, P, P,
                                        I, I, I, I, I, I, P, F, U, U, F, U, F, I, I, I, P]
    lib.k3m_attention_fwd_split.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, P, F,
                                            U, U, F, I, I, I, P]
    lib.k3m_attention_bwd_split.argtypes = [P, P, P, P, P, P, P, P, P, P, P, P,
                                            I, I, I, I, I, I, P, F, U, F, P]
    lib.k3m_moe_gather.argtypes = [P, P, P, I, P, P, I, I, P]
    lib.k3m_moe_swiglu_fwd.argtypes = [P, P, I, P, I, I, P]
    lib.k3m_moe_swiglu_bwd.argtypes = [P, P, P, I, P, I, I, P]
    lib.k3m_moe_combine_fwd.argtypes = [P, P, P, P, I, P, I, I, I, I, P]
    lib.k3m_moe_combine_bwd.argtypes = [P, P, P, P, P, I, P, P, I, I, I, I, P]
    for fn in (lib.k3m_layernorm_fwd, lib.k3m_ln_bwd_bands, lib.k3m_layernorm_bwd,
               lib.k3m_attention_fwd, lib.k3m_attention_bwd, lib.k3m_biattention_fwd,
               lib.k3m_attention_fwd_split, lib.k3m_attention_bwd_split,
               lib.k3m_moe_gather, lib.k3m_moe_swiglu_fwd, lib.k3m_moe_swiglu_bwd,
               lib.k3m_moe_combine_fwd, lib.k3m_moe_combine_bwd):
        fn.restype = I


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:       # the lock only guards the first load
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                _declare(lib)
                _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def int64_array(values):
    return (ctypes.c_longlong * len(values))(*values)
