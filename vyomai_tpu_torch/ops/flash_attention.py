"""Flash attention: the hand-written Hopper kernels and their plain PyTorch
versions, forward (``csrc/flash_fwd.cu``) and backward
(``csrc/flash_bwd.cu``), joined by a ``torch.autograd.Function``.

Replaces the TPU kernels of ``vyomai_tpu/ops/flash_attention.py``:
``_fwd_kernel`` (K1), ``_bwd_dq_kernel`` (K2) and ``_bwd_dkv_kernel`` (K3),
and its ``_flash`` custom VJP (``flash_attention_bias``). The window and
segment-id variants are not ported yet. Contract, shared by the kernels and
the plain versions here:

- q: [B, H, Lq, D]; k, v: [B, H_kv, Lk, D]; q head ``h`` reads kv head
  ``h // (H // H_kv)`` (GQA without repeating k/v; dk/dv sum the group).
- ``bias``: additive fp32 ``[B|1, H|1, Lq|1, Lk]`` or None; it gets no
  gradient.
- ``causal``: keys after ``q_offset + row`` are masked (``q_offset``
  defaults to ``Lk - Lq``, queries aligned to the end of the keys).
- Scores ``q.k / sqrt(D)``, softmax and the value sum run in fp32.
  Masked scores take ``NEG_INF``; the running max is floored at ``-1e30``,
  so a fully-masked row gives output 0, lse ``-1e30`` and zero gradient.
- Forward returns ``(out [B, H, Lq, D] in q's dtype, lse [B, H, Lq] fp32)``;
  backward recomputes ``P = exp(scores - lse)`` and, with
  ``delta = rowsum(dO * O)``, ``dS = P * (dO.v - delta) / sqrt(D)``:
  ``dq = dS.k`` (K2), ``dk = dS^T.q`` and ``dv = P^T.dO`` (K3), each in its
  input's dtype.

Each wrapper routes a CPU tensor to its plain version and launches its
kernel for a CUDA tensor, raising on what the kernel does not take; there
is no fallback between the two. On the card each kernel dispatches by
dtype: bf16 runs on the tensor cores (``flash_fwd_kernel_tc``,
``flash_bwd_dq_kernel_tc``, ``flash_bwd_dkv_kernel_tc``: P, and in the
backward dS, rounded to bf16 before their products), fp32 on the CUDA
cores (``flash_fwd_kernel``, ``flash_bwd_dq_kernel``,
``flash_bwd_dkv_kernel``); either raises on failure. The tensor-core
kernels read the bias through 16-byte aligned rows, so their wrappers pass
it through ``_aligned_bias``.
"""

from typing import Optional

import torch

from . import _build
from ..core.masks import NEG_INF

_DTYPES = (torch.bfloat16, torch.float32)


# -- plain versions -------------------------------------------------------------

def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scores(q, k, bias, causal: bool, q_offset: Optional[int]):
    """Masked, scaled scores ``[B, H, Lq, Lk]`` with k repeated over the
    GQA group, in the accumulation dtype; returns ``(scores, group)``."""
    lq, d = q.shape[2], q.shape[3]
    lk = k.shape[2]
    group = q.shape[1] // k.shape[1]
    if q_offset is None:
        q_offset = lk - lq
    acc = _acc(q.dtype)
    kk = k.repeat_interleave(group, dim=1).to(acc)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kk) * (1.0 / d ** 0.5)
    if causal:
        q_pos = q_offset + torch.arange(lq, device=q.device)[:, None]
        k_pos = torch.arange(lk, device=q.device)[None, :]
        s = s + torch.where(k_pos <= q_pos, 0.0, NEG_INF).to(acc)
    if bias is not None:
        s = s + bias.to(acc)
    return s, group


def flash_attention_fwd_ref(q, k, v, bias=None, *, causal: bool = False,
                            q_offset: Optional[int] = None):
    """Plain PyTorch version of K1 (same contract, full softmax)."""
    s, group = _scores(q, k, bias, causal, q_offset)
    vv = v.repeat_interleave(group, dim=1).to(s.dtype)
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse       # lse stays in the accumulation dtype


def _p_ds(q, k, v, bias, do, lse, delta, causal, q_offset):
    """Recomputed ``P`` and ``dS`` ``[B, H, Lq, Lk]`` (accumulation
    dtype) and the GQA group."""
    s, group = _scores(q, k, bias, causal, q_offset)
    acc = s.dtype
    p = torch.exp(s - lse.to(acc)[..., None])
    vv = v.repeat_interleave(group, dim=1).to(acc)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(acc), vv)
    ds = p * (dp - delta.to(acc)[..., None]) * (1.0 / q.shape[3] ** 0.5)
    return p, ds, group


def _group_sum(x, h_kv: int, group: int):
    """[B, H, L, D] -> [B, H_kv, L, D], summing each kv head's q heads."""
    b, _, l, d = x.shape
    return x.view(b, h_kv, group, l, d).sum(dim=2)


def flash_bwd_dq_ref(q, k, v, bias, do, lse, delta, *, causal: bool = False,
                     q_offset: Optional[int] = None):
    """Plain PyTorch version of K2: ``dq = dS.k``."""
    _, ds, group = _p_ds(q, k, v, bias, do, lse, delta, causal, q_offset)
    kk = k.repeat_interleave(group, dim=1).to(ds.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", ds, kk).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, bias, do, lse, delta, *,
                      causal: bool = False, q_offset: Optional[int] = None):
    """Plain PyTorch version of K3: ``dk = sum_group dS^T.q``, ``dv =
    sum_group P^T.dO``."""
    p, ds, group = _p_ds(q, k, v, bias, do, lse, delta, causal, q_offset)
    acc = ds.dtype
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(acc))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.to(acc))
    h_kv = k.shape[1]
    return (_group_sum(dk, h_kv, group).to(k.dtype),
            _group_sum(dv, h_kv, group).to(v.dtype))


def _delta(out, do):
    """``rowsum(dO * O)`` [B, H, Lq], fp32 (fp64 for fp64 inputs)."""
    acc = _acc(out.dtype)
    return (do.to(acc) * out.to(acc)).sum(dim=-1)


def flash_attention_bwd_ref(q, k, v, bias, out, lse, do, *,
                            causal: bool = False,
                            q_offset: Optional[int] = None):
    """Plain PyTorch version of the whole backward: ``(dq, dk, dv)``."""
    delta = _delta(out, do)
    kw = dict(causal=causal, q_offset=q_offset)
    return (flash_bwd_dq_ref(q, k, v, bias, do, lse, delta, **kw),
            *flash_bwd_dkv_ref(q, k, v, bias, do, lse, delta, **kw))


# -- kernel wrappers --------------------------------------------------------------

def _check(cond: bool, name: str, msg: str):
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _validate(name: str, q, k, v, bias, *others):
    """Raise on what the kernels do not take."""
    b, h, lq, d = q.shape
    h_kv, lk = k.shape[1], k.shape[2]
    main = (q, k, v, *others)
    tensors = main if bias is None else (*main, bias)
    _check(all(t.is_cuda and t.device == q.device for t in tensors), name,
           "all tensors on one CUDA device")
    _check(q.dtype in _DTYPES and all(t.dtype == q.dtype for t in main),
           name, f"q/k/v (and dO) must share a dtype in {_DTYPES}")
    _check(d in (64, 128), name, f"head_dim {d} not in (64, 128)")
    _check(k.shape == (b, h_kv, lk, d) and v.shape == k.shape
           and h % h_kv == 0, name,
           "k/v must be [B, H_kv, Lk, D], H % H_kv == 0")
    _check(all(t.is_contiguous() for t in main), name,
           "q/k/v (and dO) must be contiguous")
    _check(all(t.data_ptr() % 16 == 0 for t in main), name,
           "q/k/v (and dO) must be 16-byte aligned")
    if bias is None:
        return
    _check(bias.dtype == torch.float32, name, "bias must be float32")
    _check(bias.dim() == 4 and bias.shape[0] in (1, b)
           and bias.shape[1] in (1, h) and bias.shape[2] in (1, lq)
           and bias.shape[3] == lk, name,
           "bias must be [B|1, H|1, Lq|1, Lk]")
    _check(bias.stride(3) == 1, name, "bias must be contiguous in Lk")


def _aligned_bias(bias):
    """``bias`` as the tensor-core kernels read it: 16-byte aligned rows
    (every stride of a non-broadcast dim a multiple of 4 floats). Else a
    copy whose rows are padded to 4 floats, viewed back to ``Lk``."""
    if bias is None or (bias.data_ptr() % 16 == 0 and all(
            bias.shape[i] == 1 or bias.stride(i) % 4 == 0 for i in range(3))):
        return bias
    lk = bias.shape[3]
    padded = torch.zeros((*bias.shape[:3], -(-lk // 4) * 4),
                         dtype=bias.dtype, device=bias.device)
    padded[..., :lk] = bias
    return padded[..., :lk]


def supported(q, k, bias=None) -> bool:
    """Whether the kernels take these operands (the ``"auto"`` route's
    test): CUDA tensors of one dtype in bf16/fp32, D 64 or 128, an fp32
    bias of a broadcastable 4-D shape."""
    if not (q.is_cuda and q.dtype in _DTYPES and k.dtype == q.dtype
            and q.shape[-1] in (64, 128) and q.shape[1] % k.shape[1] == 0):
        return False
    if bias is None:
        return True
    b, h, lq, _ = q.shape
    return (bias.dtype == torch.float32 and bias.dim() == 4
            and bias.shape[0] in (1, b) and bias.shape[1] in (1, h)
            and bias.shape[2] in (1, lq) and bias.shape[3] == k.shape[2])


def _dims(q, k, q_offset):
    b, h, lq, d = q.shape
    h_kv, lk = k.shape[1], k.shape[2]
    return b, h, h_kv, lq, lk, d, lk - lq if q_offset is None else q_offset


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd(q, k, v, bias=None, *, causal: bool = False,
                        q_offset: Optional[int] = None):
    """K1, the flash-attention forward: ``(out, lse)``. CPU tensors take
    the plain version; CUDA tensors launch the kernel (or raise)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, bias, causal=causal,
                                       q_offset=q_offset)
    _validate("flash_attention_fwd", q, k, v, bias)
    bias, (sb, sh, sq) = _kernel_bias(q, bias)
    b, h, h_kv, lq, lk, d, q_offset = _dims(q, k, q_offset)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    err = _build.library().flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
        out.data_ptr(), lse.data_ptr(), b, h, h_kv, lq, lk, d, sb, sh, sq,
        int(causal), int(q_offset), int(q.dtype == torch.bfloat16),
        _stream(q))
    _build.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


def _kernel_bias(q, bias):
    """The bias a kernel reads (bf16: ``_aligned_bias``) and its strides
    ``(b, h, q)``, 0 for a broadcast dim."""
    if bias is None:
        return None, (0, 0, 0)
    if q.dtype == torch.bfloat16:
        bias = _aligned_bias(bias)
    return bias, tuple(0 if bias.shape[i] == 1 else bias.stride(i)
                       for i in range(3))


def _bwd_inputs(name, q, k, v, bias, do, lse, delta):
    """Validate a backward kernel's operands; return the bias it reads
    and its strides."""
    _validate(name, q, k, v, bias, do)
    rows = q.shape[:3]
    _check(all(t.dtype == torch.float32 and t.shape == rows
               and t.is_contiguous() for t in (lse, delta)), name,
           "lse and delta must be contiguous fp32 [B, H, Lq]")
    return _kernel_bias(q, bias)


def flash_bwd_dq(q, k, v, bias, do, lse, delta, *, causal: bool = False,
                 q_offset: Optional[int] = None):
    """K2: ``dq`` from the forward's lse and ``delta = rowsum(dO * O)``.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, bias, do, lse, delta,
                                causal=causal, q_offset=q_offset)
    bias, (sb, sh, sq) = _bwd_inputs("flash_bwd_dq", q, k, v, bias, do,
                                     lse, delta)
    b, h, h_kv, lq, lk, d, q_offset = _dims(q, k, q_offset)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    err = _build.library().flash_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, h_kv, lq, lk,
        d, sb, sh, sq, int(causal), int(q_offset),
        int(q.dtype == torch.bfloat16), _stream(q))
    _build.check(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, bias, do, lse, delta, *, causal: bool = False,
                  q_offset: Optional[int] = None):
    """K3: ``(dk, dv)``, each summed over its GQA group. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, bias, do, lse, delta,
                                 causal=causal, q_offset=q_offset)
    bias, (sb, sh, sq) = _bwd_inputs("flash_bwd_dkv", q, k, v, bias, do,
                                     lse, delta)
    b, h, h_kv, lq, lk, d, q_offset = _dims(q, k, q_offset)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    err = _build.library().flash_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
        h_kv, lq, lk, d, sb, sh, sq, int(causal), int(q_offset),
        int(q.dtype == torch.bfloat16), _stream(q))
    _build.check(err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, bias, out, lse, do, *, causal: bool = False,
                        q_offset: Optional[int] = None):
    """The backward of :func:`flash_attention_fwd`: ``delta`` in torch (as
    the TPU ``_bwd`` computes it outside its kernels), then K2 and K3.
    Returns ``(dq, dk, dv)``."""
    delta = _delta(out, do)
    dq = flash_bwd_dq(q, k, v, bias, do, lse, delta, causal=causal,
                      q_offset=q_offset)
    dk, dv = flash_bwd_dkv(q, k, v, bias, do, lse, delta, causal=causal,
                           q_offset=q_offset)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward (saving out and lse), K2 + K3 backward; the bias gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, q_offset):
        out, lse = flash_attention_fwd(q, k, v, bias, causal=causal,
                                       q_offset=q_offset)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, bias, out, lse, do.contiguous(), causal=ctx.causal,
            q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


def flash_attention_bias(q, k, v, bias=None, *, causal: bool = False,
                         window=None, segments=None):
    """Differentiable flash attention with an additive bias (counterpart of
    the JAX ``flash_attention_bias``): q ``[B, H, Lq, D]``, k/v ``[B, H_kv,
    Lk, D]`` unrepeated, queries aligned to the end of the keys. Ragged
    lengths need no padding: the kernels mask their edges."""
    if window is not None or segments is not None:
        raise NotImplementedError(
            "flash attention's window and segment-id variants are not "
            "ported yet")
    q_offset = k.shape[2] - q.shape[2]
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bias, causal, q_offset)
