"""Build the CUDA kernels (attention and the SSD scan) with ``nvcc`` at
first use and load them with ctypes.

The sources are ``kernels/csrc/*.cu`` (plain C interface, no PyTorch
headers).  Each ``.cu`` compiles to an object in its own ``nvcc`` process,
all started together, and the objects link into
``build/repro_torch/<hash>/librepro_torch_kernels.so`` under the repo
root; the hash covers the sources and the flags, so an edited source
builds anew and an unchanged one loads the library already built.
Importing this module builds nothing: the CPU tests import every module
without ``nvcc``."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v", "-lineinfo"]

_lib: Optional[ctypes.CDLL] = None
# what the last build (or load) did: seconds, library path, ptxas lines
build_info: Dict[str, object] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default
    prefix."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from kernels/csrc at first use")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(build_root: Optional[Path] = None) -> Path:
    """Compile and link the kernels if the library for these sources is
    not there yet; returns its path.  Raises on any compiler error."""
    root = Path(build_root) if build_root else REPO_ROOT / "build"
    out_dir = root / "repro_torch" / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        if build_info.get("path") != str(lib):     # keep this run's log
            build_info.update(seconds=0.0, path=str(lib), ptxas=[],
                              cached=True)
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, lib)      # atomic: concurrent builds agree
    ptxas = [ln.strip() for log in logs for ln in log.splitlines()
             if "registers" in ln or "Compiling" in ln or "spill" in ln
             or "wgmma" in ln]
    build_info.update(seconds=time.perf_counter() - t0, path=str(lib),
                      ptxas=ptxas, cached=False)
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # pointers (q k v o lse q_off), then q_off_value B Sq Sk H KV hd causal
    # window, scale, stream; the same for the f32-query kernel
    for fn in (lib.repro_flash_fwd, lib.repro_flash_fwd_f32):
        fn.argtypes = [vp] * 6 + [i32] * 9 + [f32, vp]
        fn.restype = i32
    # pointers (q k v o dO lse delta dq), then B Sq Sk H KV hd causal
    # window, scale, stream; the same for the f32-query kernel
    for fn in (lib.repro_flash_bwd_dq, lib.repro_flash_bwd_dq_f32):
        fn.argtypes = [vp] * 8 + [i32] * 8 + [f32, vp]
        fn.restype = i32
    # pointers (q k v dO lse delta dk dv partial arrived), then B Sq Sk H
    # KV hd nsplit causal window, scale, stream
    lib.repro_flash_bwd_dkv.argtypes = [vp] * 10 + [i32] * 9 + [f32, vp]
    lib.repro_flash_bwd_dkv.restype = i32
    # pointers (q k v dO lse delta dk dv), then B Sq Sk H KV hd causal
    # window, scale, stream
    lib.repro_flash_bwd_dkv_f32.argtypes = [vp] * 8 + [i32] * 8 + [f32, vp]
    lib.repro_flash_bwd_dkv_f32.restype = i32
    # pointers (q k_cache v_cache o lengths partial arrived), then B S H
    # KV hd window split, scale, q_is_f32, stream
    lib.repro_flash_decode.argtypes = [vp] * 7 + [i32] * 7 + [f32, i32, vp]
    lib.repro_flash_decode.restype = i32
    # pointers (q k_pool v_pool o table lengths partial arrived), then B MB
    # BL H KV hd split, scale, q_is_f32, stream
    lib.repro_flash_paged_decode.argtypes = [vp] * 8 + [i32] * 7 + [f32, i32,
                                                                     vp]
    lib.repro_flash_paged_decode.restype = i32
    # pointers (xh a_log bb cc y cum s_local), then B S H P N chunk, stream
    lib.repro_ssd_chunk_scan.argtypes = [vp] * 7 + [i32] * 6 + [vp]
    lib.repro_ssd_chunk_scan.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
