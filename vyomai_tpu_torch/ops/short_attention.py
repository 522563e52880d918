"""Short bidirectional attention (ViT- and MLM-class lengths): the
hand-written Hopper kernels of ``csrc/short_attention.cu``, their plain
PyTorch versions and the ``torch.autograd.Function``s around them.

Replaces the TPU kernels of ``vyomai_tpu/ops/short_attention.py``:
``_kernel`` / ``_kernel_paired`` (K5: ``short_attention`` and
``short_attention_bias``), ``_kernel_qkv`` (K6: ``short_attention_qkv``
over the packed fused-qkv projection) and ``_kernel_bwd`` (K7, the
backward). The JAX package computes ``short_attention_bias``'s backward in
plain math (``_bwd_math``); here K7 takes the key-pad bias too, so that
backward runs the kernel on the card. The bias gets no gradient (the
flash contract of this port).

Contract, shared by the kernels and the plain versions:

- q, k, v ``[B, H, L, D]`` (MHA, one length), read through their strides
  with unit stride along D; ``bias`` an additive key-pad ``[B|1, 1, 1, L]``
  or None.
- scores ``q.k / sqrt(D) + bias`` in fp32 (fp64 for fp64 inputs on the
  CPU), a row max, ``p = exp(s - max)``, the value sum, then the division
  by the row's sum. A row whose keys are all padded (every score
  ``finfo(fp32).min``) gets a uniform softmax: the mean of V, as the TPU
  kernel and the ``"xla"`` route give.
- the forward returns ``(out, stats)``, ``stats [B, H, L, 2]`` fp32 each
  row's ``(max, sum)``; the backward recomputes ``P = exp(s - max) / sum``
  and, with ``delta = rowsum(dO * O)``, ``dS = P * (dP - delta) /
  sqrt(D)``: ``dq = dS.k``, ``dk = dS^T.q``, ``dv = P^T.dO``.
- K6 reads q/k/v as views of ``qkv [B, L, 3*H*D]`` (head h of q at columns
  ``h*D``, of k at ``H*D + h*D``, of v at ``2*H*D + h*D``) and writes
  ``[B, L, H*D]``; its backward writes the packed ``dx`` directly.

The gates keep the TPU gates' semantic conditions (bidirectional, no
window or segments, MHA, ``lq == lk``, no mask or a key-pad bias,
``8 <= L <= 512``, ``D in {32, 64, 128}``, bf16 or fp32). They drop the
TPU's own: the VMEM budget, and ``supported_packed``'s even head count
(the head pairing that fills the TPU's matrix unit is not ported).

Each wrapper routes a CPU tensor to its plain version and launches its
kernel for a CUDA tensor, raising on what the kernel does not take; there
is no fallback between the two. On the card both directions dispatch by
dtype, and either path raises on failure: bf16 runs on the tensor cores,
the forward (K5, K6) in one pass (``short_fwd_kernel_tc``: online softmax,
P rounded to bf16 before the value product) and the backward (K7) as
``short_bwd_dq_kernel_tc`` and ``short_bwd_dkv_kernel_tc`` (P and dS
rounded to bf16 before their products); fp32 runs on the CUDA cores
(``short_fwd_kernel``, ``short_bwd_dq_kernel``, ``short_bwd_dkv_kernel``).
"""

import torch

from . import _build

SHORT_MAX_L = 512
_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (32, 64, 128)


# -- gates --------------------------------------------------------------------------

def _is_keypad_bias(mask, b: int, lk: int) -> bool:
    """Additive key-padding bias ``[B|1, 1, 1, Lk]`` (the encoder's
    ``(1 - m) * finfo.min`` mask)."""
    return (mask is not None and mask.dim() == 4 and mask.shape[1] == 1
            and mask.shape[2] == 1 and mask.shape[3] == lk
            and mask.shape[0] in (1, b))


def supported(q, k, mask, *, causal: bool = False, window=None,
              segments=None) -> bool:
    """Whether the short-attention route takes this call (any device)."""
    if causal or window is not None or segments is not None:
        return False
    if mask is not None and not _is_keypad_bias(mask, q.shape[0], k.shape[2]):
        return False
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        return False
    _, h, lq, d = q.shape
    return (h == k.shape[1] and lq == k.shape[2] and d in _HEAD_DIMS
            and 8 <= lq <= SHORT_MAX_L)


def supported_packed(qkv, nh: int) -> bool:
    """Gate of ``short_attention_qkv``: ``qkv [B, L, 3*H*D]``."""
    if qkv.dtype not in _DTYPES or qkv.dim() != 3 or qkv.shape[2] % (3 * nh):
        return False
    return (qkv.shape[2] // (3 * nh) in _HEAD_DIMS
            and 8 <= qkv.shape[1] <= SHORT_MAX_L)


# -- plain versions -------------------------------------------------------------------

def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scores(q, k, bias):
    acc = _acc(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * (
        1.0 / q.shape[-1] ** 0.5)
    return s if bias is None else s + bias.to(acc)


def short_attention_fwd_ref(q, k, v, bias=None):
    """Plain PyTorch version of K5: ``(out, stats)``."""
    s = _scores(q, k, bias)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(s.dtype)) / l
    return out.to(q.dtype), torch.cat([m, l], dim=-1)


def _unpack(qkv, nh: int):
    """q, k, v ``[B, H, L, D]`` views of the packed ``[B, L, 3*H*D]``."""
    b, l, w = qkv.shape
    x5 = qkv.view(b, l, 3, nh, w // (3 * nh))
    return tuple(x5[:, :, i].transpose(1, 2) for i in range(3))


def _merge(x):
    """``[B, H, L, D]`` -> ``[B, L, H*D]``."""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def short_attention_qkv_ref(qkv, nh: int):
    """Plain PyTorch version of K6: ``(out [B, L, H*D], stats)``."""
    out, stats = short_attention_fwd_ref(*_unpack(qkv, nh))
    return _merge(out), stats


def short_attention_bwd_ref(q, k, v, bias, do, stats, delta):
    """Plain PyTorch version of K7: ``(dq, dk, dv)``."""
    s = _scores(q, k, bias)
    acc = s.dtype
    stats = stats.to(acc)
    p = torch.exp(s - stats[..., :1]) / stats[..., 1:]
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(acc), v.to(acc))
    ds = p * (dp - delta.to(acc)[..., None]) * (1.0 / q.shape[-1] ** 0.5)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(acc))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(acc))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(out, do):
    """``rowsum(dO * O)`` ``[B, H, L]``, fp32 (fp64 for fp64 inputs)."""
    acc = _acc(out.dtype)
    return (do.to(acc) * out.to(acc)).sum(dim=-1).contiguous()


# -- kernel wrappers ------------------------------------------------------------------

def _check(cond: bool, name: str, msg: str):
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _rows_ok(t) -> bool:
    """A ``[B, H, L, D]`` operand the kernels read in place: unit stride
    along D and 16-byte aligned rows."""
    vn = 16 // t.element_size()
    return (t.stride(3) == 1 and all(s % vn == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _strides(t):
    return tuple(int(s) for s in t.stride()[:3])


def _validate(name: str, q, k, v, bias, outs, rows):
    """Raise on what the kernels do not take. ``outs`` share q/k/v's
    strides (dq/dk/dv), ``rows`` share one layout (out, dO). Returns the
    bias as fp32 ``[B|1, L]`` (or None) and its batch stride."""
    b, h, l, d = q.shape
    tensors = (q, k, v, *outs, *rows)
    _check(all(t.is_cuda and t.device == q.device for t in tensors), name,
           "all tensors on one CUDA device")
    _check(q.dtype in _DTYPES and all(t.dtype == q.dtype for t in tensors),
           name, f"tensors must share a dtype in {_DTYPES}")
    _check(d in _HEAD_DIMS and 1 <= l <= SHORT_MAX_L, name,
           f"[B, H, L, D] with D in {_HEAD_DIMS} and L <= {SHORT_MAX_L}, got "
           f"{tuple(q.shape)}")
    _check(all(t.shape == q.shape for t in tensors), name,
           "q, k, v (and their gradients, out, dO) must have one shape")
    _check(all(_rows_ok(t) for t in tensors), name,
           "unit stride along D and 16-byte aligned rows")
    _check(all(t.stride() == q.stride() for t in (k, v, *outs)), name,
           "q, k, v (and their gradients) must share strides")
    _check(all(t.stride() == rows[0].stride() for t in rows), name,
           "out and dO must share strides")
    if bias is None:
        return None, 0
    _check(bias.is_cuda and bias.device == q.device and _is_keypad_bias(
        bias, b, l), name, "bias must be a key-pad [B|1, 1, 1, L] on q's "
           "device")
    # rows padded to 4 floats: the forward's bias ring reads 16-byte rows
    l4 = -(-l // 4) * 4
    b2 = torch.zeros((bias.shape[0], l4), dtype=torch.float32,
                     device=bias.device)
    b2[:, :l] = bias.reshape(bias.shape[0], l)
    return b2, (l4 if b2.shape[0] > 1 else 0)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _as_rows(*ts):
    """The tensors as the kernels read them: as they are when they share
    strides the kernels take, else contiguous copies."""
    if all(_rows_ok(t) and t.stride() == ts[0].stride() for t in ts):
        return ts
    return tuple(t.contiguous() for t in ts)


def _rows_empty(like):
    """An output ``[B, H, L, D]`` laid out as ``[B, L, H, D]`` in memory, so
    merging the heads afterwards is a view."""
    b, h, l, d = like.shape
    return torch.empty((b, l, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _launch_fwd(name, q, k, v, bias, out, stats):
    b2, bias_sb = _validate(name, q, k, v, bias, (), (out,))
    b, h, l, d = q.shape
    err = _build.library().short_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(b2), bias_sb,
        out.data_ptr(), _ptr(stats), b, h, l, d, *_strides(q),
        *_strides(out), int(q.dtype == torch.bfloat16), _stream(q))
    _build.check(err, name)


def _new_stats(q, with_stats: bool):
    if not with_stats:
        return None
    return torch.empty((*q.shape[:3], 2), dtype=torch.float32,
                       device=q.device)


def short_attention_fwd(q, k, v, bias=None, *, with_stats: bool = True):
    """K5: ``(out, stats)`` (``stats`` None when not asked for on the
    card). CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise)."""
    if q.device.type == "cpu":
        return short_attention_fwd_ref(q, k, v, bias)
    q, k, v = _as_rows(q, k, v)
    out, stats = _rows_empty(q), _new_stats(q, with_stats)
    if out.numel():
        _launch_fwd("short_attention_fwd", q, k, v, bias, out, stats)
        short_attention_fwd.launches += 1
    return out, stats


def short_attention_qkv_fwd(qkv, nh: int, *, with_stats: bool = True):
    """K6: ``(out [B, L, H*D], stats)`` from the packed ``qkv [B, L,
    3*H*D]``. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise)."""
    if qkv.device.type == "cpu":
        return short_attention_qkv_ref(qkv, nh)
    _check(qkv.dim() == 3 and qkv.shape[2] % (3 * nh) == 0
           and qkv.is_contiguous(), "short_attention_qkv_fwd",
           "qkv must be a contiguous [B, L, 3*H*D]")
    q, k, v = _unpack(qkv, nh)
    out, stats = _rows_empty(q), _new_stats(q, with_stats)
    if out.numel():
        _launch_fwd("short_attention_qkv_fwd", q, k, v, None, out, stats)
        short_attention_qkv_fwd.launches += 1
    return _merge(out), stats


def short_attention_bwd(q, k, v, bias, do, stats, delta, grads=None):
    """K7: ``(dq, dk, dv)`` from the forward's stats and ``delta =
    rowsum(dO * O)``. ``grads``, if given, are the three tensors to write
    (views of a packed ``dx``); by default they are allocated with q's
    strides. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise)."""
    if q.device.type == "cpu":
        got = short_attention_bwd_ref(q, k, v, bias, do, stats, delta)
        if grads is None:
            return got
        for dst, src in zip(grads, got):
            dst.copy_(src)
        return grads
    if grads is None:
        q, k, v = _as_rows(q, k, v)
        grads = tuple(torch.empty_strided(q.shape, q.stride(), dtype=q.dtype,
                                          device=q.device) for _ in range(3))
    name = "short_attention_bwd"
    b2, bias_sb = _validate(name, q, k, v, bias, grads, (do,))
    _check(all(t.dtype == torch.float32 and t.is_contiguous()
               for t in (stats, delta))
           and stats.shape == (*q.shape[:3], 2)
           and delta.shape == q.shape[:3], name,
           "stats [B, H, L, 2] and delta [B, H, L]: contiguous fp32")
    if q.numel():
        b, h, l, d = q.shape
        err = _build.library().short_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(b2), bias_sb,
            do.data_ptr(), stats.data_ptr(), delta.data_ptr(),
            *(g.data_ptr() for g in grads), b, h, l, d, *_strides(q),
            *_strides(do), int(q.dtype == torch.bfloat16), _stream(q))
        _build.check(err, name)
        short_attention_bwd.launches += 1
    return grads


short_attention_fwd.launches = 0
short_attention_qkv_fwd.launches = 0
short_attention_bwd.launches = 0


# -- autograd ---------------------------------------------------------------------------

class _ShortAttention(torch.autograd.Function):
    """K5 forward (saving out and the row stats), K7 backward; the bias
    gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        grad = any(ctx.needs_input_grad[:3])
        out, stats = short_attention_fwd(q, k, v, bias, with_stats=grad)
        if grad:
            ctx.save_for_backward(q, k, v, bias, out, stats)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, stats = ctx.saved_tensors
        if do.device.type != "cpu":
            do, = _as_rows(do)
        dq, dk, dv = short_attention_bwd(q, k, v, bias, do, stats,
                                         _delta(out, do))
        return dq, dk, dv, None


class _ShortAttentionQKV(torch.autograd.Function):
    """K6 forward, K7 backward writing the packed ``dx``."""

    @staticmethod
    def forward(ctx, qkv, nh):
        grad = ctx.needs_input_grad[0]
        out, stats = short_attention_qkv_fwd(qkv, nh, with_stats=grad)
        if grad:
            ctx.save_for_backward(qkv, out, stats)
            ctx.nh = nh
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, stats = ctx.saved_tensors
        nh = ctx.nh
        b, l, w = qkv.shape
        heads = lambda x: x.view(b, l, nh, -1).transpose(1, 2)  # noqa: E731
        do = do.contiguous()
        dx = torch.empty_like(qkv)
        short_attention_bwd(*_unpack(qkv, nh), None, heads(do), stats,
                            _delta(heads(out), heads(do)),
                            grads=_unpack(dx, nh))
        return dx, None


def short_attention(q, k, v):
    """``softmax(q k^T / sqrt(D)) v`` for ``[B, H, L, D]`` short
    sequences (counterpart of the JAX ``short_attention``)."""
    return _ShortAttention.apply(q, k, v, None)


def short_attention_bias(q, k, v, bias):
    """``softmax(q k^T / sqrt(D) + bias) v`` with an additive key-pad bias
    ``[B|1, 1, 1, L]``; the bias gets no gradient."""
    return _ShortAttention.apply(q, k, v, bias)


def short_attention_qkv(qkv, nh: int):
    """Attention over the packed fused-qkv projection ``[B, L, 3*H*D]`` ->
    ``[B, L, H*D]``, with no ``[B, H, L, D]`` transpose in device memory
    on either pass. Any head count."""
    return _ShortAttentionQKV.apply(qkv, nh)
