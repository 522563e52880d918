"""Weight-only int8 / int4 matmuls (counterpart of
``vyomai_tpu.ops.quant_matmul``): the quantizers, the hand-written Hopper
kernels of ``csrc/quant_matmul.cu`` and their plain PyTorch versions.

Replaces the TPU kernels ``vyomai_tpu/ops/quant_matmul.py`` ``_kernel_kn`` /
``_kernel_nk`` (K8), ``_kernel_int4`` / ``_kernel_int4_fold`` (K9) and
``benchmarks/int4_dense_bench.py`` ``_stream_kernel`` / ``_noscale_kernel``
(K10, two attribution modes of K9 for the microbenchmark).

Layouts at these functions are the JAX package's: ``int8_matmul`` takes
``w_q [K, N]`` (``w_layout="kn"``) or ``[N, K]`` (``"nk"``, the tied head and
the port's ``nn.Linear``-shaped modules) with ``scale [N]``; ``int4_matmul``
takes ``w_p [K/2, N]`` (``w_layout="kn"``, the JAX ``kernel_q4``: row 2i in
the low nibble, 2i+1 in the high one) or its transpose ``[N, K/2]``
(``"nk"``, k contiguous: byte i of row n holds k = 2i and 2i+1 of column n;
the port's ``Int4Linear``) with group scales ``[K/gs, N]``.

Numerics of the kernels and of their plain versions:

- int8: ``x @ w_q`` accumulated in fp32 (fp64 for fp64 inputs on the CPU),
  times ``scale[n]`` in fp32, rounded ONCE to x's dtype: the Pallas kernel's
  epilogue. The JAX package's default int8 path is XLA's, which rounds
  ``x @ w`` to x's dtype before the scale; at fp32 the two agree to
  rounding, at bf16 the kernel's single rounding is the more exact.
- int4 ``"fold"`` (the serving default, as ``_INT4_KERNEL`` in JAX):
  ``w = nibble * scale[g, n]`` in fp32, rounded to x's dtype, then one fp32
  accumulation. ``"split"``: exact fp32 partial sums times the group's
  scale (per group here; the kernel scales each 16-row slice of a group,
  the same math in another fp32 order).
- K10 ``"stream"`` dots the packed bytes themselves as int8 values against
  both the even and the odd columns of x; ``"noscale"`` unpacks but applies
  one scale row at the end. Both are wrong math with the right traffic,
  and both read the scale row the TPU kernels read (:func:`k10_scale_row`).

Each wrapper takes the plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises on what the kernel does not take); there
is no fallback between the two.

K8 and K9/K10 each have two kernels, chosen before the launch by a static
property of the operands (:func:`int8_route`, :func:`int4_route`): bf16 x
against an ``nk`` weight with 16-byte aligned rows and K % 16 == 0 (every
int8 / int4 linear and tied head of the serving modules) runs
``int8_matmul_kernel_tc`` / ``int4_matmul_kernel_tc`` (K9 fold, K10's
modes) on the tensor cores, tiled and split along K by
:func:`int8_tc_plan`; fp32 x, the ``kn`` layout, K9's ``"split"`` mode and
unaligned operands run the CUDA-core kernels. A split plan sums its fp32
partials in a fixed order in a workspace of the device and stream
(:func:`_split_workspace`), so two calls give the same bits.

``w8a8_matmul`` has no TPU kernel (JAX runs ``lax.dot_general`` int8 x int8
-> int32) and calls ``torch._int_mm`` on the card.
"""

import functools

import torch

from . import _build

_DTYPES = (torch.bfloat16, torch.float32)
INT4_MODES = {"fold": 0, "split": 1, "stream": 2, "noscale": 3}


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


# -- quantizers (bit-identical to the JAX package's on the same fp32 input) ---

def quantize_weight(w: torch.Tensor, *, contract_axis: int = 0):
    """Symmetric per-output-channel int8: ``(w_q int8, scale f32 [n_out])``
    with ``w ~ w_q * scale`` broadcast over ``contract_axis``; a zero
    channel gets scale 1.0."""
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=contract_axis)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    expand = scale[None, :] if contract_axis == 0 else scale[:, None]
    q = torch.clamp(torch.round(w32 / expand), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight_int4(w: torch.Tensor, *, group_size: int = 128):
    """Symmetric 4-bit group-wise quantization of a ``[K, N]`` kernel:
    ``(packed int8 [K/2, N], scale f32 [K/group_size, N])``, adjacent rows
    2i / 2i+1 in the low / high nibble."""
    k_dim, n_dim = w.shape
    if k_dim % 2 or k_dim % group_size:
        raise ValueError(f"K={k_dim} must be even and divisible by "
                         f"group_size={group_size}")
    grouped = w.to(torch.float32).reshape(k_dim // group_size, group_size,
                                          n_dim)
    amax = grouped.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(grouped / scale[:, None, :]), -7, 7)
    q = q.reshape(k_dim, n_dim).to(torch.int32)
    packed = (q[0::2] & 0xF) | ((q[1::2] & 0xF) << 4)
    return packed.to(torch.uint8).view(torch.int8), scale


def unpack_int4(p8: torch.Tensor):
    """(low, high) nibbles of an int8 tensor, sign-extended, as int32."""
    p32 = p8.to(torch.int32)
    return ((p32 & 15) ^ 8) - 8, p32 >> 4


def dequantize_int4(w_p: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 ``[K, N]`` reconstruction of a packed int4 kernel."""
    lo, hi = unpack_int4(w_p)
    k_dim, n_dim = 2 * w_p.shape[0], w_p.shape[1]
    w = torch.stack([lo, hi], dim=1).reshape(k_dim, n_dim).to(torch.float32)
    g = scale.shape[0]
    return (w.reshape(g, k_dim // g, n_dim) * scale[:, None, :]).reshape(
        k_dim, n_dim)


def quantize_activation(x: torch.Tensor):
    """Dynamic symmetric per-row int8: ``(x_q int8 [..., K], scale f32
    [..., 1])``; a zero row gets scale 1.0."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int4_block_rows(group_size: int, k_half: int) -> int:
    """The TPU kernel's packed K rows per block (``_int4_block_rows``):
    a multiple of the group's packed rows and of 128, dividing K/2, the
    widest up to 512; 0 when none fits."""
    half = group_size // 2
    if half % 128 == 0:
        base = half
    elif 128 % half == 0:
        base = 128
    else:
        return 0
    best, rows = 0, base
    while rows <= 512:
        if k_half % rows == 0:
            best = rows
        rows += base
    return best


def k10_scale_row(k_dim: int, group_size: int) -> int:
    """The scale row K10's TPU kernels apply: ``s_ref[0, 0, :]`` of the last
    K block, group ``(kb - 1) * gpb`` of the TPU's blocking."""
    rows = int4_block_rows(group_size, k_dim // 2)
    if rows == 0:
        raise ValueError(f"no TPU blocking for K={k_dim} gs={group_size}")
    gpb = rows // (group_size // 2)
    return ((k_dim // 2) // rows - 1) * gpb


# -- plain versions -------------------------------------------------------------

def int8_matmul_ref(x, w_q, scale, w_layout: str = "kn") -> torch.Tensor:
    """Plain version of K8 (same contract as :func:`int8_matmul`)."""
    acc = _acc(x.dtype)
    w = w_q if w_layout == "kn" else w_q.t()
    y = torch.matmul(x.to(acc), w.to(acc))
    return (y * scale.to(acc)).to(x.dtype)


def int4_matmul_ref(x, w_p, scale, kernel: str = "fold",
                    scale_row: int = 0, w_layout: str = "kn") -> torch.Tensor:
    """Plain version of K9 (``"fold"``, ``"split"``) and of K10's modes
    (``"stream"``, ``"noscale"``, which apply ``scale[scale_row]``), for
    either layout of the packed weight."""
    if w_layout == "nk":
        w_p = w_p.t()
    elif w_layout != "kn":
        raise ValueError(w_layout)
    acc = _acc(x.dtype)
    k_dim, n_dim = 2 * w_p.shape[0], w_p.shape[1]
    g = scale.shape[0]
    x32 = x.to(acc)
    lo, hi = unpack_int4(w_p)
    if kernel == "stream":
        wp = w_p.to(acc)
        y = x32[..., 0::2] @ wp + x32[..., 1::2] @ wp
        return (y * scale[scale_row].to(acc)).to(x.dtype)
    w = torch.stack([lo, hi], dim=1).reshape(k_dim, n_dim).to(acc)
    if kernel == "noscale":
        return ((x32 @ w) * scale[scale_row].to(acc)).to(x.dtype)
    if kernel == "fold":   # the scaled weight is an fp32 product
        wd = (w.to(torch.float32).reshape(g, k_dim // g, n_dim)
              * scale[:, None, :].to(torch.float32))
        wd = wd.reshape(k_dim, n_dim).to(x.dtype).to(acc)
        return (x32 @ wd).to(x.dtype)
    if kernel != "split":
        raise ValueError(kernel)
    lead = x.shape[:-1]
    xg = x32.reshape(-1, g, k_dim // g)
    part = torch.einsum("mgk,gkn->gmn", xg, w.reshape(g, k_dim // g, n_dim))
    y = (part * scale[:, None, :].to(acc)).sum(dim=0)
    return y.reshape(*lead, n_dim).to(x.dtype)


# -- the routes and the tensor-core plan -----------------------------------------

TC_K_STEP = 64   # k per step of the tensor-core kernel's ring
# (bm, bn) tiles the tensor-core kernel is built for: 16 x 32 (decode, and
# any M whose 64-row tiles would leave SMs idle) and 64 x 128 (prefill)
TC_TILES = ((16, 32), (64, 128))


def int8_route(x2: torch.Tensor, w_q: torch.Tensor, w_layout: str) -> str:
    """Which K8 kernel takes ``x2 [M, K] @ w_q``: ``"tc"`` (tensor cores)
    for bf16 x against an ``nk`` weight whose rows are k-contiguous and
    16-byte aligned with K % 16 == 0 and x 16-byte aligned, else
    ``"cuda"`` (the CUDA-core kernel: fp32 x, the ``kn`` layout, or
    operands the tensor-core tiles cannot read with 16-byte copies)."""
    k_dim = x2.shape[-1]
    if x2.dtype != torch.bfloat16 or w_layout != "nk":
        return "cuda"
    if (k_dim % 16 or w_q.stride(1) != 1 or w_q.stride(0) % 16
            or w_q.data_ptr() % 16 or x2.data_ptr() % 16):
        return "cuda"
    return "tc"


def int4_route(x2: torch.Tensor, w_p: torch.Tensor, w_layout: str,
               mode: str, group_size: int) -> str:
    """Which K9/K10 kernel takes ``x2 [M, K] @ dequant4(w_p)``: ``"tc"``
    (tensor cores) for bf16 x against an ``nk`` packed weight in mode
    ``"fold"``, ``"stream"`` or ``"noscale"``, with K % 16 == 0, a group
    size that is a multiple of 16 (a lane's 16 k lie in one group), k
    contiguous, 16-byte aligned rows and 16-byte aligned pointers; else
    ``"cuda"`` (the CUDA-core kernel: fp32 x, the ``kn`` layout,
    ``"split"``, or operands the tensor-core tiles cannot read with
    16-byte copies)."""
    k_dim = x2.shape[-1]
    if (x2.dtype != torch.bfloat16 or w_layout != "nk"
            or mode not in ("fold", "stream", "noscale")):
        return "cuda"
    if (k_dim % 16 or group_size % 16 or w_p.stride(1) != 1
            or w_p.stride(0) % 16 or w_p.data_ptr() % 16
            or x2.data_ptr() % 16):
        return "cuda"
    return "tc"


def int8_tc_plan(m: int, k: int, n: int, sm_count: int, *,
                 wide: bool = True):
    """``(bm, bn, splits)`` of the tensor-core K8 or K9/K10 at ``[m, k] @
    [k, n]``.

    Prefill (m > 16) takes 64 x 128 tiles, so each widened weight fragment
    feeds four 16-row ``mma`` tiles, where those tiles alone fill the SMs;
    decode (m <= 16), and an m whose 64-row tiles would not, takes 16 x 32
    tiles, the most CTAs a weight stream can spread over (at the head,
    4,748). If the 16 x 32 tiles are still fewer than ``sm_count``, K
    splits across CTAs in whole 64-deep steps, none empty: the fewest
    splits that make the grid at least ``sm_count`` CTAs (all of the steps
    at most). The 64-row tile never splits. ``wide=False`` (K10's modes,
    built for the 16 x 32 tile only) always takes the 16 x 32 tile."""
    if wide and m > 16 and -(-m // 64) * -(-n // 128) >= sm_count:
        return 64, 128, 1
    tiles = -(-m // 16) * -(-n // 32)
    steps = -(-k // TC_K_STEP)
    splits = 1
    if tiles < sm_count:
        want = -(-sm_count // tiles)
        while True:
            splits = -(-steps // -(-steps // min(want, steps)))
            if splits * tiles >= sm_count or want >= steps:
                break
            want += 1
    return 16, 32, splits


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream handle) -> (fp32 partials, int32 tile counters),
# grown on demand. Calls on one stream run in order and the kernel leaves
# every counter at 0, so the calls of one stream share one workspace;
# two streams never do. A grown workspace's old buffers move to
# _RETIRED and are never freed: a CUDA graph captured over a split-K call
# keeps their addresses, and replays it after a larger call has grown the
# workspace.
_WORKSPACE = {}
_RETIRED = []


def _split_workspace(device: torch.device, stream: int, floats: int,
                     tiles: int):
    """The split-K workspace of ``device`` and ``stream`` (a stream
    handle): at least ``floats`` fp32 partials and ``tiles`` counters
    (zeroed when allocated)."""
    key = (device.index, stream)
    ws, counters = _WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() < floats:
        if ws is not None:
            _RETIRED.append(ws)
        ws = torch.empty(floats, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < tiles:
        if counters is not None:
            _RETIRED.append(counters)
        counters = torch.zeros(tiles, dtype=torch.int32, device=device)
    _WORKSPACE[key] = (ws, counters)
    return ws, counters


def _tc_plan_args(x2, m, k_dim, n_dim, stream, *, wide=True):
    """``(bm, bn, splits, ws, counters)`` launch arguments of a tensor-core
    plan (pointers 0 when it does not split)."""
    bm, bn, splits = int8_tc_plan(m, k_dim, n_dim,
                                  _sm_count(x2.device.index), wide=wide)
    ws = counters = 0
    if splits > 1:
        tiles = -(-m // bm) * -(-n_dim // bn)
        wsb, cnt = _split_workspace(x2.device, stream, splits * m * n_dim,
                                    tiles)
        ws, counters = wsb.data_ptr(), cnt.data_ptr()
    return bm, bn, splits, ws, counters


# -- wrappers ---------------------------------------------------------------------

def _check(cond: bool, name: str, msg: str):
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_common(name, x2, w, scale, out_n):
    _check(x2.is_cuda and w.device == x2.device and scale.device == x2.device,
           name, "all tensors on one CUDA device")
    _check(x2.dtype in _DTYPES, name, f"x dtype {x2.dtype} not in {_DTYPES}")
    _check(w.dtype == torch.int8, name, "weights must be int8")
    _check(scale.dtype == torch.float32 and scale.is_contiguous(), name,
           "scale must be contiguous fp32")
    _check(x2.is_contiguous(), name, "x must be contiguous")
    _check(out_n > 0, name, "empty output")


def int8_matmul(x, w_q, scale, *, w_layout: str = "kn") -> torch.Tensor:
    """``x [..., K] @ dequant(w_q)``: K8 on the card, the plain version on
    the CPU. On the card :func:`int8_route` picks the tensor-core kernel
    (bf16, aligned ``nk``: ``int8_matmul.tc_launches`` counts it) or the
    CUDA-core one, which reads ``w_q`` through its (n, k) strides, so the
    two layouts (and any strided view) take it; ``int8_matmul.launches``
    counts both."""
    if w_layout not in ("kn", "nk"):
        raise ValueError(w_layout)
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w_q, scale, w_layout)
    k_dim = x.shape[-1]
    n_dim = w_q.shape[1] if w_layout == "kn" else w_q.shape[0]
    x2 = x.reshape(-1, k_dim)
    _check_common("int8_matmul", x2, w_q, scale, n_dim)
    sn, sk = ((w_q.stride(1), w_q.stride(0)) if w_layout == "kn"
              else (w_q.stride(0), w_q.stride(1)))
    _check(tuple(scale.shape) == (n_dim,) and w_q.numel() == k_dim * n_dim,
           "int8_matmul", "weight/scale shapes")
    m = x2.shape[0]
    out = torch.empty((m, n_dim), dtype=x.dtype, device=x.device)
    if m:
        lib = _build.library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tc = int8_route(x2, w_q, w_layout) == "tc"
        plan = (_tc_plan_args(x2, m, k_dim, n_dim, stream) if tc
                else (0, 0, 1, 0, 0))
        err = lib.int8_matmul_launch(
            x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, n_dim, k_dim, sn, sk, int(x.dtype == torch.bfloat16), *plan,
            stream)
        _build.check(err, "int8_matmul")
        int8_matmul.launches += 1
        int8_matmul.tc_launches += int(tc)
    return out.reshape(*x.shape[:-1], n_dim)


int8_matmul.launches = 0
int8_matmul.tc_launches = 0


def _int4_launch(fn, x, w_p, scale, mode: str, scale_row: int,
                 w_layout: str):
    """Launch K9/K10 on the route :func:`int4_route` picks, counting the
    launch on ``fn`` (``launches``, and ``tc_launches`` on the tensor
    cores)."""
    name = fn.__name__
    if w_layout not in ("kn", "nk"):
        raise ValueError(w_layout)
    k_dim = x.shape[-1]
    n_dim = w_p.shape[1] if w_layout == "kn" else w_p.shape[0]
    x2 = x.reshape(-1, k_dim)
    _check_common(name, x2, w_p, scale, n_dim)
    g = scale.shape[0]
    shape = (k_dim // 2, n_dim) if w_layout == "kn" else (n_dim, k_dim // 2)
    _check(tuple(w_p.shape) == shape and k_dim % 2 == 0, name,
           f"w_p must be {'[K/2, N]' if w_layout == 'kn' else '[N, K/2]'}")
    _check(scale.dim() == 2 and scale.shape[1] == n_dim and g > 0
           and k_dim % g == 0 and (k_dim // g) % 16 == 0, name,
           "scale must be [K/gs, N]; the kernel takes group sizes that are "
           "multiples of 16")
    _check(0 <= scale_row < g, name, "scale_row out of range")
    sn, sk = ((w_p.stride(1), w_p.stride(0)) if w_layout == "kn"
              else (w_p.stride(0), w_p.stride(1)))
    gs = k_dim // g
    m = x2.shape[0]
    out = torch.empty((m, n_dim), dtype=x.dtype, device=x.device)
    if m:
        lib = _build.library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tc = int4_route(x2, w_p, w_layout, mode, gs) == "tc"
        # K10's modes are built for the 16 x 32 tile alone
        plan = (_tc_plan_args(x2, m, k_dim, n_dim, stream,
                              wide=mode == "fold") if tc
                else (0, 0, 1, 0, 0))
        err = lib.int4_matmul_launch(
            x2.data_ptr(), w_p.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, n_dim, k_dim, gs, INT4_MODES[mode], scale_row,
            int(x.dtype == torch.bfloat16), sn, sk, *plan, stream)
        _build.check(err, name)
        fn.launches += 1
        fn.tc_launches += int(tc)
    return out.reshape(*x.shape[:-1], n_dim)


def int4_matmul(x, w_p, scale, *, kernel: str = "fold",
                w_layout: str = "kn") -> torch.Tensor:
    """``x [..., K] @ dequant4(w_p)``: K9 (``kernel="fold"``, the modules'
    body, or ``"split"``) on the card, the plain version on the CPU. On
    the card :func:`int4_route` picks the tensor-core kernel (bf16 fold
    against an aligned ``nk`` weight: ``int4_matmul.tc_launches`` counts
    it) or the CUDA-core one, which reads ``w_p`` through its strides;
    ``int4_matmul.launches`` counts both."""
    if kernel not in ("fold", "split"):
        raise ValueError(kernel)
    if x.device.type == "cpu":
        return int4_matmul_ref(x, w_p, scale, kernel, 0, w_layout)
    return _int4_launch(int4_matmul, x, w_p, scale, kernel, 0, w_layout)


int4_matmul.launches = 0
int4_matmul.tc_launches = 0


def int4_attribution(x, w_p, scale, *, mode: str, scale_row: int,
                     w_layout: str = "kn") -> torch.Tensor:
    """K10: K9's traffic with ``mode="stream"`` (packed bytes dotted as
    int8) or ``"noscale"`` (unpacked, one scale row at the end); routed
    and counted as :func:`int4_matmul` (``int4_attribution.tc_launches``)."""
    if mode not in ("stream", "noscale"):
        raise ValueError(mode)
    if x.device.type == "cpu":
        return int4_matmul_ref(x, w_p, scale, mode, scale_row, w_layout)
    return _int4_launch(int4_attribution, x, w_p, scale, mode, scale_row,
                        w_layout)


int4_attribution.launches = 0
int4_attribution.tc_launches = 0


def w8a8_matmul(x, w_q, w_scale, *, w_layout: str = "kn") -> torch.Tensor:
    """``x @ dequant(w_q)`` with x quantized per token and the contraction
    in int8 x int8 -> int32, corrected by the outer product of the token
    and channel scales. The int32 sum is exact, so the CPU forms it in
    fp64 (exact below 2^53) and the card with ``torch._int_mm``."""
    lead = x.shape[:-1]
    k_dim = x.shape[-1]
    n_dim = w_q.shape[1] if w_layout == "kn" else w_q.shape[0]
    xq, xs = quantize_activation(x.reshape(-1, k_dim))
    w = w_q if w_layout == "kn" else w_q.t()
    if x.device.type == "cpu":
        acc = (xq.to(torch.float64) @ w.to(torch.float64)).to(torch.float32)
    else:
        # torch._int_mm on CUDA takes M > 16 and K, N multiples of 8: the
        # decode batch (M = 16) is padded with zero rows to a multiple of
        # 8 no smaller than 32, and the pad rows are dropped
        m = xq.shape[0]
        m_pad = max(32, -(-m // 8) * 8)
        if m_pad != m:
            xq = torch.cat([xq, xq.new_zeros((m_pad - m, k_dim))])
        acc = torch._int_mm(xq, w)[:m].to(torch.float32)
    out = (acc * xs * w_scale.to(torch.float32)).to(x.dtype)
    return out.reshape(*lead, n_dim)
