"""Build and load the port's CUDA kernels.

Each ``vyomai_tpu_torch/csrc/*.cu`` source compiles with its own ``nvcc``
for ``sm_90a``, all started together, and the objects link into ONE shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use, into
``vyomai_tpu_torch/csrc/build/<hash>/``, keyed by a hash of the sources and
flags, so an unchanged checkout builds once and a changed source rebuilds.
Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures of the kernels' launchers (each returns cudaGetLastError())
_SIGNATURES = {
    # q, pool, scales, block_tables, seq_lens, out, workspace (acc, m/l),
    # B, H, H_kv, D, BS, MAXB, W, quant, is_bf16, plan (partition, splits),
    # stream
    "paged_decode_launch": [_P] * 8 + [_I] * 11 + [_P],
    # x, w, scale, out, M, N, K, w strides (n, k), is_bf16, tensor-core
    # plan (bm, 0 = CUDA cores; bn; splits), split workspace, counters,
    # stream
    "int8_matmul_launch": [_P] * 4 + [_I] * 3 + [_LL] * 2 + [_I] * 4
    + [_P] * 3,
    # x, w_p, scale, out, M, N, K, group size, mode, scale_row, is_bf16,
    # w_p strides (n, k), tensor-core plan (bm, bn, splits), split
    # workspace, counters, stream
    "int4_matmul_launch": [_P] * 4 + [_I] * 7 + [_LL] * 2 + [_I] * 3
    + [_P] * 3,
    # q, k, v, bias, out, lse, B, H, H_kv, Lq, Lk, D, bias strides (b, h,
    # q; 64-bit), causal, q_offset, is_bf16, stream
    "flash_fwd_launch": [_P] * 6 + [_I] * 6 + [_LL] * 3 + [_I] * 3 + [_P],
    # q, k, v, bias, dout, lse, delta, dq, B, H, H_kv, Lq, Lk, D, bias
    # strides (b, h, q; 64-bit), causal, q_offset, is_bf16, stream
    "flash_bwd_dq_launch": [_P] * 8 + [_I] * 6 + [_LL] * 3 + [_I] * 3 + [_P],
    # q, k, v, bias, dout, lse, delta, dk, dv, then as flash_bwd_dq_launch
    "flash_bwd_dkv_launch": [_P] * 9 + [_I] * 6 + [_LL] * 3 + [_I] * 3
    + [_P],
    # q, k, v, bias, bias batch stride, out, stats, B, H, L, D, q/k/v
    # strides (b, h, row), out strides (b, h, row), is_bf16, stream
    "short_fwd_launch": [_P] * 4 + [_LL] + [_P] * 2 + [_I] * 4 + [_LL] * 6
    + [_I, _P],
    # q, k, v, bias, bias batch stride, dout, stats, delta, dq, dk, dv, B,
    # H, L, D, q/k/v/dq/dk/dv strides, dout strides, is_bf16, stream
    "short_bwd_launch": [_P] * 4 + [_LL] + [_P] * 6 + [_I] * 4 + [_LL] * 6
    + [_I, _P],
}

_LIB = None
build_seconds = None   # wall time of this process's build (None = not built)
path = None            # the loaded library's file (None = not loaded)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built from source")
    return str(path)


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise with the failures' stderr."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call."""
    global _LIB, build_seconds, path
    if _LIB is not None:
        return _LIB
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = CSRC / "build" / digest.hexdigest()[:16]
    so = out_dir / "libvyomai_kernels.so"
    if not so.exists():
        t0 = time.perf_counter()
        out_dir.mkdir(parents=True, exist_ok=True)
        objs = [out_dir / f"{src.stem}.o" for src in sources]
        _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(sources, objs)])
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            _run_all([[_nvcc(), "-shared", "-o", tmp, *map(str, objs)]])
        except RuntimeError:
            os.unlink(tmp)
            raise
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vyomai_error_string.argtypes = [ctypes.c_int]
    lib.vyomai_error_string.restype = ctypes.c_char_p
    _LIB, path = lib, so
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` from a launcher."""
    if err:
        text = _LIB.vyomai_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")
