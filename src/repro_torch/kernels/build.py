"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to
``build/repro_torch_kernels/`` at the root of the checkout, named by a hash
of the sources and flags, and are built at first use; ``build_all`` starts
one ``nvcc`` per source at once. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The attention kernels' K/V beside q: q's own dtype (0) or fp8 e4m3 (1),
# which the kernels widen to q's dtype as they stage it
KV_E4M3 = torch.float8_e4m3fn


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


class CudaLibrary:
    """One ``csrc`` source (plus the shared ``.cuh`` headers) as one shared
    library. ``functions`` maps each exported C function to its argtypes;
    every one returns an int (a ``cudaError_t`` or a size)."""

    def __init__(self, source: str, functions: dict[str, list]):
        self.source = CSRC / source
        self.functions = functions
        self.build_log = ""             # nvcc's output (ptxas register use)
        self._lib = None
        self._lock = threading.Lock()

    @property
    def path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in [self.source, *sorted(CSRC.glob("*.cuh"))]:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start ``nvcc`` unless the library is already built. Returns
        ``(process, tmp_path, out_path)`` or None."""
        out = self.path
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp, out = started
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name}:\n"
                               f"{self.build_log}")
        os.replace(tmp, out)

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self.path))
                for name, argtypes in self.functions.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
        return self._lib


def build_all(libraries) -> None:
    """Build every library at once (one ``nvcc`` each), then load them."""
    started = [(lib, lib.start_build()) for lib in libraries]
    for lib, s in started:
        lib.finish_build(s)
    for lib in libraries:
        lib.lib()


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


def check_cuda_inputs(name: str, float_tensors, int_tensors,
                      kv_tensors=()) -> int:
    """Validate what a kernel takes and return its dtype code: every tensor
    contiguous on one CUDA device, floats all bf16 or all f32 and 16-byte
    aligned, indices int32. ``kv_tensors`` (an attention kernel's K and V)
    share one dtype, the floats' or e4m3 (``kv_code``), and are 16-byte
    aligned too."""
    device = float_tensors[0].device
    dtype = float_tensors[0].dtype
    require(dtype in DTYPE_CODES,
            f"{name}: dtype {dtype} not supported (bf16 or f32)")
    for t in (*float_tensors, *kv_tensors, *int_tensors):
        require(t.device == device,
                f"{name}: tensors on {t.device} and {device}")
        require(t.is_contiguous(), f"{name}: inputs must be contiguous")
    for t in float_tensors:
        require(t.dtype == dtype, f"{name}: mixed dtypes {t.dtype}, {dtype}")
    if kv_tensors:
        kv = kv_tensors[0].dtype
        require(kv in (dtype, KV_E4M3) and all(t.dtype == kv
                                               for t in kv_tensors),
                f"{name}: K/V dtypes {[t.dtype for t in kv_tensors]} with "
                f"q in {dtype} (K and V share q's dtype or e4m3)")
    for t in (*float_tensors, *kv_tensors):
        require(t.data_ptr() % 16 == 0, f"{name}: inputs must be 16-byte "
                                        "aligned")
    for t in int_tensors:
        require(t.dtype == torch.int32, f"{name}: index tensors must be "
                                        f"int32, got {t.dtype}")
    return DTYPE_CODES[dtype]


def kv_code(k: torch.Tensor) -> int:
    """The launchers' K/V code: 1 for e4m3, 0 for q's own dtype."""
    return int(k.dtype == KV_E4M3)


def check_head_dim(name: str, d: int) -> None:
    require(d % 8 == 0 and 0 < d <= 256,
            f"{name}: head_dim {d} not supported (a multiple of 8, <= 256)")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
