"""Build and load the port's CUDA kernels.

Each kernel source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, at first use, under
``build/ipoke_tpu_torch/`` beside the package (listed in ``.gitignore``).
The file name carries a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is reused.  Libraries are loaded with
``ctypes``; nothing here includes or links PyTorch's C++ headers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ipoke_tpu_torch"
KERNELS = ("mcf_inverse", "mcf_unit_inverse")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# activation name -> code of csrc/mcf_cluster_scan.cuh (enum Act)
ACT_CODES = {"elu": 0, "relu": 1, "leaky_relu": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of each library's launch function
SIGNATURES = {
    "mcf_inverse": ("mcf_inverse_launch", [_P] * 6 + [_I] * 8 + [_F, _I, _I, _I, _I, _P]),
    "mcf_unit_inverse": ("macow_unit_inverse_launch", [_P] * 17 + [_I] * 8 + [_F, _I, _I, _I, _P]),
}

_LOADED: dict = {}


@dataclass
class BuildInfo:
    name: str
    path: Path
    seconds: float   # 0.0 when an existing library was reused
    log: str         # nvcc's output, with the -Xptxas -v resource report


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Build the named kernels that are not built yet, one ``nvcc`` each, all
    started together.  Returns {name: BuildInfo}; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc() if any(not library_path(n).is_file() for n in names) else None
    jobs, infos = {}, {}
    for name in names:
        path = library_path(name)
        if path.is_file():
            infos[name] = BuildInfo(name, path, 0.0, "")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        infos[name] = BuildInfo(name, path, seconds, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return infos


def load(name: str):
    """The launch function of kernel ``name``, building its library if needed."""
    if name not in _LOADED:
        path = build((name,))[name].path
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = fn
    return _LOADED[name]


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_tensor(name: str, t, device, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of rank ``ndim``
    on ``device``."""
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous() \
            or t.dim() != ndim:
        raise ValueError(
            f"{name}: the kernel takes contiguous float32 tensors of rank {ndim} on "
            f"{device}; got {tuple(t.shape)} {t.dtype} on {t.device}"
            f"{'' if t.is_contiguous() else ', not contiguous'}")
