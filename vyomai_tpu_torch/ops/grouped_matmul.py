"""K11, the grouped SwiGLU expert matmul of a mixture-of-experts layer: the
hand-written Hopper kernels (Triton) and their plain PyTorch version.

It replaces no TPU kernel: the JAX package runs its experts through XLA
(``layers/moe.py``: the GShard einsums, or ``lax.ragged_dot``). The port
needs it because routing is data-dependent and the serving step is a
captured CUDA graph: the expert product must take each expert's rows from
device memory, with a launch shape fixed by the worst case.

Contract, shared by both versions:

- ``x [T, H]`` the tokens' activations; ``src [R]`` int64, the token of
  each routed row, rows sorted by expert (R = T x experts per token);
  ``offsets [E + 1]`` int32, the first row of each expert, nondecreasing
  from ``offsets[0] = 0``, with ``offsets[E]`` the rows in use (rows past
  it belong to no expert: padding and dead lanes);
- ``w1``, ``w3 [E, I, H]`` (gate and up), ``w2 [E, H, I]`` (down), the
  layout of ``nn.Linear`` weights stacked over experts;
- row ``r`` of expert ``e`` gives ``y[r] = w2[e] @ (silu(w1[e] @ x[src[r]])
  * (w3[e] @ x[src[r]]))``: products summed in fp32 (fp64 for fp64), the
  gated activation rounded once to x's dtype, ``y`` rounded once. Rows
  from ``offsets[E]`` on are left unwritten on the card (0 from the plain
  version): the caller masks them.

What bounds it on the H100: a decode step of 128 lanes at top-4 over 32
experts routes ~16 rows to each expert, so every expert's 3 x 1,792 x
2,048 bf16 weights (22 MB) are read for ~1.3 GFLOP: memory-bound, 705 MB a
layer, 0.21 ms at 3.35 TB/s. A prefill call of ~2,400 real rows is within
2x of the ridge point. The design streams each expert's weights once a
call: one program per (row tile of one expert, column tile), 64-row tiles
so that a decode step's expert is one tile; ``k11_gate_up_kernel`` does
the gate and up products from the same x tile (x rows gathered by
``src``, never copied) and writes silu(gate) x up in bf16, and
``k11_down_kernel`` the down product. The grid is ``ceil(R / 64) + E``
row tiles (the most any routing needs) by the column tiles; a program
finds its expert and rows by walking ``offsets`` and returns at once past
the last tile, so a launch reads nothing from the host and a CUDA graph
captures it.

:func:`grouped_swiglu` routes a CPU tensor to :func:`grouped_swiglu_ref`
and launches the kernels for a CUDA tensor; there is no fallback between
the two. ``grouped_swiglu.launches`` counts calls (both kernels together).
Triton is imported, and the kernels built, at the first launch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# set to ``triton.language`` by :func:`_kernels` before the kernels compile
tl = None

_BM = 64                 # rows of a tile (one expert's rows at decode)
_BN = 64                 # output columns of a tile
_BK = 64                 # depth of one step of the product
_WARPS, _STAGES = 4, 3
_kernels_built = {}


def _expert_tile(offs_ptr, pid_m, E: tl.constexpr, BM: tl.constexpr):
    """``(expert, first row, end row)`` of row tile ``pid_m``: tiles are
    numbered expert by expert, ``ceil(rows / BM)`` each; expert -1 past
    the last."""
    e_sel = pid_m * 0 - 1
    row0 = pid_m * 0
    row_end = pid_m * 0
    seen = pid_m * 0
    for i in tl.static_range(E):
        a = tl.load(offs_ptr + i)
        b = tl.load(offs_ptr + i + 1)
        nt = (b - a + BM - 1) // BM
        hit = (pid_m >= seen) & (pid_m < seen + nt)
        e_sel = tl.where(hit, i, e_sel)
        row0 = tl.where(hit, a + (pid_m - seen) * BM, row0)
        row_end = tl.where(hit, b, row_end)
        seen += nt
    return e_sel, row0, row_end


def k11_gate_up_kernel(x_ptr, src_ptr, offs_ptr, w1_ptr, w3_ptr, h_ptr, H,
                       I, E: tl.constexpr, BM: tl.constexpr,
                       BN: tl.constexpr, BK: tl.constexpr):
    pid_m = tl.program_id(0)
    pid_n = tl.program_id(1)
    e, row0, row_end = _expert_tile(offs_ptr, pid_m, E, BM)
    if e < 0:
        return
    rm = row0 + tl.arange(0, BM)
    m_ok = rm < row_end
    tok = tl.load(src_ptr + rm, mask=m_ok, other=0)
    rn = pid_n * BN + tl.arange(0, BN)
    n_ok = rn < I
    rk = tl.arange(0, BK)
    xp = x_ptr + tok[:, None] * H + rk[None, :]
    wo = e.to(tl.int64) * I * H + rn[:, None].to(tl.int64) * H + rk[None, :]
    w1p = w1_ptr + wo
    w3p = w3_ptr + wo
    g = tl.zeros((BM, BN), dtype=tl.float32)
    u = tl.zeros((BM, BN), dtype=tl.float32)
    for _ in range(0, H, BK):
        xa = tl.load(xp, mask=m_ok[:, None], other=0.0)
        wa = tl.load(w1p, mask=n_ok[:, None], other=0.0)
        wb = tl.load(w3p, mask=n_ok[:, None], other=0.0)
        g += tl.dot(xa, tl.trans(wa))
        u += tl.dot(xa, tl.trans(wb))
        xp += BK
        w1p += BK
        w3p += BK
    h = g * tl.sigmoid(g) * u
    hp = h_ptr + rm[:, None].to(tl.int64) * I + rn[None, :]
    tl.store(hp, h.to(h_ptr.dtype.element_ty),
             mask=m_ok[:, None] & n_ok[None, :])


def k11_down_kernel(h_ptr, offs_ptr, w2_ptr, y_ptr, H, I,
                    E: tl.constexpr, BM: tl.constexpr, BN: tl.constexpr,
                    BK: tl.constexpr):
    pid_m = tl.program_id(0)
    pid_n = tl.program_id(1)
    e, row0, row_end = _expert_tile(offs_ptr, pid_m, E, BM)
    if e < 0:
        return
    rm = row0 + tl.arange(0, BM)
    m_ok = rm < row_end
    rn = pid_n * BN + tl.arange(0, BN)
    n_ok = rn < H
    rk = tl.arange(0, BK)
    hp = h_ptr + rm[:, None].to(tl.int64) * I + rk[None, :]
    w2p = (w2_ptr + e.to(tl.int64) * H * I
           + rn[:, None].to(tl.int64) * I + rk[None, :])
    acc = tl.zeros((BM, BN), dtype=tl.float32)
    for _ in range(0, I, BK):
        a = tl.load(hp, mask=m_ok[:, None], other=0.0)
        b = tl.load(w2p, mask=n_ok[:, None], other=0.0)
        acc += tl.dot(a, tl.trans(b))
        hp += BK
        w2p += BK
    yp = y_ptr + rm[:, None].to(tl.int64) * H + rn[None, :]
    tl.store(yp, acc.to(y_ptr.dtype.element_ty),
             mask=m_ok[:, None] & n_ok[None, :])


def _kernels():
    """``(gate_up, down)``, Triton's JIT over the functions above, built
    once a process (the kernels call ``_expert_tile`` by its global name,
    so that name is bound to its JIT too)."""
    if not _kernels_built:
        global tl, _expert_tile
        import triton
        import triton.language
        tl = triton.language
        _expert_tile = triton.jit(_expert_tile)
        _kernels_built["gate_up"] = triton.jit(k11_gate_up_kernel)
        _kernels_built["down"] = triton.jit(k11_down_kernel)
    return _kernels_built["gate_up"], _kernels_built["down"]


def grouped_swiglu_ref(x, src, offsets, w1, w3, w2) -> torch.Tensor:
    """The plain version (module docstring), one expert at a time."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = x.new_zeros(src.shape[0], w2.shape[1])
    off = offsets.tolist()
    for e in range(w1.shape[0]):
        a, b = off[e], off[e + 1]
        if b <= a:
            continue
        xe = x[src[a:b]].to(acc)
        g = xe @ w1[e].to(acc).t()
        u = xe @ w3[e].to(acc).t()
        h = (F.silu(g) * u).to(x.dtype).to(acc)
        y[a:b] = (h @ w2[e].to(acc).t()).to(x.dtype)
    return y


def rounding_bound(x, src, offsets, w1, w3, w2) -> torch.Tensor:
    """``[R, H]``: how far bf16 K11 may lie from its plain version at each
    element of a used row. Both sum exact bf16 products in fp32, in other
    orders, and round the gated activation h and y to bf16 once: y may
    differ by one bf16 ulp of itself (2^-7 |y|) and by each h's one-ulp
    flip carried through w2 (2^-7 sum_i |h_i||w2_ni|)."""
    bound = torch.zeros(src.shape[0], w2.shape[1], device=x.device)
    off = offsets.tolist()
    for e in range(w1.shape[0]):
        a, b = off[e], off[e + 1]
        if b > a:
            xe = x[src[a:b]].float()
            hh = F.silu(xe @ w1[e].float().t()) * (xe @ w3[e].float().t())
            y = hh @ w2[e].float().t()
            bound[a:b] = 2.0 ** -7 * (y.abs() + hh.abs() @
                                      w2[e].float().abs().t()) + 1e-6
    return bound


def _check(x, src, offsets, w1, w3, w2):
    e, i, h = w1.shape
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"K11 takes bf16, got {x.dtype}")
    if any(t.dtype != x.dtype for t in (w1, w3, w2)):
        raise ValueError("K11: x and the expert banks must share a dtype")
    if x.dim() != 2 or x.shape[1] != h or w3.shape != w1.shape or \
            w2.shape != (e, h, i):
        raise ValueError(f"K11 shapes: x {tuple(x.shape)}, w1/w3 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if src.dtype != torch.int64 or offsets.dtype != torch.int32 or \
            offsets.shape != (e + 1,):
        raise ValueError("K11: src int64 [R], offsets int32 [E + 1]")
    if h % _BK or i % _BK:
        raise NotImplementedError(
            f"K11: hidden {h} and expert width {i} must be multiples of "
            f"{_BK}")
    for t in (x, src, offsets, w1, w3, w2):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("K11: contiguous tensors on one device")


def grouped_swiglu(x, src, offsets, w1, w3, w2) -> torch.Tensor:
    """``y [R, H]`` (module docstring): the plain version on the CPU, K11
    on the card."""
    if x.device.type != "cuda":
        return grouped_swiglu_ref(x, src, offsets, w1, w3, w2)
    _check(x, src, offsets, w1, w3, w2)
    gate_up, down = _kernels()
    e, i, h = w1.shape
    r = src.shape[0]
    hid = torch.empty(r, i, dtype=x.dtype, device=x.device)
    y = torch.empty(r, h, dtype=x.dtype, device=x.device)
    tiles = -(-r // _BM) + e
    with torch.cuda.device(x.device):
        gate_up[(tiles, -(-i // _BN))](
            x, src, offsets, w1, w3, hid, h, i, E=e, BM=_BM, BN=_BN,
            BK=_BK, num_warps=_WARPS, num_stages=_STAGES)
        down[(tiles, -(-h // _BN))](
            hid, offsets, w2, y, h, i, E=e, BM=_BM, BN=_BN, BK=_BK,
            num_warps=_WARPS, num_stages=_STAGES)
    grouped_swiglu.launches += 1
    return y


grouped_swiglu.launches = 0
