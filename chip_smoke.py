#!/usr/bin/env python3
"""Drive the PyTorch port's serving, decoder-training, encoder-family,
quantized-serving, static-cache generation, mixture-of-experts and
latent-attention serving paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints a flushed ``[chip_smoke]`` marker; any failure raises
and exits non-zero):

1. device and set-up: require CUDA, disable TF32, print the card's name and
   power limit, build the CUDA kernels from ``vyomai_tpu_torch/csrc``, and
   count with ``cuobjdump`` the tensor-core (HMMA) instructions and the
   registers of each bf16 tensor-core kernel (the attention forwards K1,
   K5/K6, the backwards K2/K3 and K7, K8's int8 matmul, and the int4
   matmul of K9 fold and K10's stream / noscale), and print the registers,
   shared memory and stack of K4's split-KV pair (``k4_kernels``);
2. K4 paged decode (the split-KV pair) against its plain version at the
   serving shapes (``K4_LENS``: a ragged batch, phase 5's tick, one lane
   at 1,024 tokens), each case with its plan, five calls bit-identical,
   its time, bound and share;
3. K1 flash forward against its plain version at the prefill and training
   shapes and the contract's edges (ragged, causal, fully masked rows);
   then at static-cache generation's shapes (``K1_GEN_CASES``: a
   128-token prefill against a 192-slot buffer, decode steps at Lq=1;
   bf16 and fp32, groups 2 and 4), each beside SDPA and the ``"xla"``
   route;
4. K2/K3 flash backward against their plain versions at the training
   shapes and the contract's edges (the bf16 bound adds the tensor-core
   kernels' rounding of P and dS, ``flash_bwd_rounding``), with their
   TFLOP/s on the issued work (``flash_bwd_issued_flops``) and the live
   pairs beside SDPA's backward;
5. end-to-end serving at Qwen3-0.6B width (``QwenConfig()``, random bf16
   weights from a seeded generator): 24 requests in two waves, the second
   hitting the radix prefix cache, through pipelined ticks, each a replay
   of the engine's captured decode step (``HorizonGraph``); then the same
   requests again with ``pipeline_decode=False``, token for token equal;
6. serving numerics: the same width at 2 layers and fp32, one 520-token
   prompt, prefill + 8 teacher-forced decode steps on the card against the
   same functions on the CPU; then one 8-step tick from that prefill as a
   graph tick and as the eager ``decode_horizon`` on the card and on the
   CPU (``phase_graph_numerics``);
7. end-to-end training at the width of the JAX package's ``bench.py``
   (``vyomai_tpu_torch.bench``: 12 layers, hidden 1024, bf16, B=4,
   S=1024, AdamW): the naive step, then the fused one, 3 warm-up + 10
   timed steps each on one seeded batch;
8. training numerics: the same widths at 2 layers and fp32, B=2, S=256,
   loss and every gradient on the card against the CPU, then one AdamW
   step and the params;
9. K5/K6/K7 (short attention) against their plain versions at the ViT,
   MLM and edge shapes, beside SDPA and K1 on the same operands (K7's bf16
   bound adds its rounding of P and dS, ``k7_rounding``);
10. end-to-end ViT-base/16 (``vyomai_tpu_torch.encoder_bench``: 12 layers,
    bf16): forward img/s at B=128, 3 warm-up + 10 timed train steps at
    B=32, on the "auto" (K6/K7) and "xla" routes;
11. end-to-end RoBERTa-base MLM (12 layers, bf16, right-padded) at S=128
    B=64 and S=512 B=16 on both routes (K5/K7 on "auto");
12. encoder numerics: ViT and MLM at 2 layers and fp32, loss and every
    gradient on the card (kernels) against the CPU (plain versions);
13. K8 (int8, kn and nk; bf16 nk on the tensor cores), K9 (int4 fold and
    split, kn and nk; bf16 nk fold on the tensor cores) and K10 (stream
    and noscale; bf16 nk on the tensor cores) against their plain versions
    at Qwen3-0.6B's decode shapes, the tied head, a prefill shape and
    ragged M, bf16 and fp32, at the shapes phase 17 gives K8 and K9 (M=8
    decode steps, M=1,024 prefill), and K8 at the served int8 decode
    (M=64 over Mistral-7B's linears and head), each with its route and,
    on the tensor cores, tile, splits and grid; the split-K reduction's
    determinism for int8 (16- and 64-row plans) and int4; then the K10
    path (``quant_bench.int4_attribution``);
14. K4's int8 and int4 pool variants against their plain versions at
    phase 2's cases;
15. end-to-end quantized serving: phase 5's workload and seeded weights
    through ``quantize_model``, int8 weights + int8 pool, then int4
    weights + int4 pool; each serving run (5 and 15) also runs one decode
    tick twice on the same inputs over copies of its pool, the eager
    ``decode_horizon`` and the engine's graph tick (identical tokens and
    pools required), each traced for its device time per step, K4's (both
    kernels, each required once a layer) and K8's and K9's (required in
    the quantized graph), and timed unprofiled for its wall per step
    (``decode_tick_ms``);
16. quantized numerics: phase 6's method for int8 + int8 pool, int4 +
    int4 pool and W8A8, quantized on the CPU and copied to the card;
17. end-to-end static-cache generation at Qwen3-0.6B width (random bf16
    weights from a seed; B=8, 128-token prompts, 64 greedy new tokens):
    ``generate_hf`` and ``generate(use_cache=True)``, token for token
    equal, then ``generate_hf`` with int8 and int4 (gs 128) weights; K1
    once a layer a call, K8 and K9 where quantized; tokens/s, and from
    ``generate_hf`` runs of 8 steps split at the prefill (``gen_step_ms``):
    prefill ms, wall per step and, traced, device ms per step, idle share
    and K1's, K8's and K9's ms;
18. generation numerics: 2 layers fp32, card against CPU: the Qwen width's
    cached logits, cached and uncached ``generate``, and
    ``DecoderModel.generate`` (a left-padded batch on the ``"flash"``
    route on both devices);
19. LFM2-8B-A1B: K11 (the grouped SwiGLU expert matmul) against its plain
    version at a decode step's and a prefill call's shapes, with its time,
    the plain version's, the library's grouped product's and its bound
    (``phase_k11``); then the model at its published widths through the
    engine with both captured graphs, the MoE counters exact
    (``phase_lfm2_serving``);
20. K12 (RMSNorm with the residual add folded in) against its plain
    version at the norm sites of the three served configurations' decode
    steps and prefill calls (``K12_CASES``), with its time, the plain
    chain's, the library's (``torch.nn.functional.rms_norm`` after the
    add) and its bound (``phase_k12``).
21. Moonlight-16B-A3B: K13 (MLA over the latent pool) against its plain
    version at a served decode step (128 lanes over cached documents)
    and prefill calls (4 rows x 128, 512, 32 tokens over 5,900 cached
    rows), within the kernels' rounding of the probabilities computed
    from the same operands, with its time, the plain version's and its
    bound (``phase_k13``); then the model at its published widths through
    the engine with the radix cache and both captured graphs, the latent
    row counters exact and the tick's time spent counting them
    (``phase_moonlight_serving``).

Each end-to-end path (5, 7, 10, 11, the K10 path of 13, 15, 17, 19, 21)
zeroes its kernels' launch counts just before it and reads them after; a
replay of the captured decode step adds what its capture counted. The line
before the last holds the kernels' JSON record, with the decode ticks'
figures, phase 5's tokens/s pipelined and synchronous, K1's generation
cases, phase 17's figures (``generation``) and phase 19's
(``serving_lfm2``; K11's record holds its decode case and ``prefill``),
phase 20's (K12's record, a case a norm site) and phase 21's (K13's
record holds its decode case and ``prefill``; ``serving_moonlight``);
the last line is
``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def phase(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


# Cycles of the sleep kernel queued before each timed call (~1 ms): the
# card is busy with it while the host enqueues the call, so the events time
# the device's work and not the wrapper's checks and launch, which take tens
# of microseconds, longer than the smaller kernels themselves.
SLEEP_CYCLES = 2_000_000


def cuda_ms(fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events), with the L2 cache
    flushed before each timed call and a sleep kernel queued behind the
    flush (``SLEEP_CYCLES``)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_atol(ref) -> float:
    """Both versions read the same bf16 inputs and reduce in fp32, so input
    rounding is shared: they differ by fp32 summation order (1e-4) plus at
    most one bf16 ulp of the output after the final cast, 2^-7 of its
    largest magnitude."""
    return 2.0 ** -7 * float(ref.float().abs().max()) + 1e-4


def attn_bf16_atol(ref, v) -> float:
    """A bf16 attention forward (K1, K5, K6) against its plain version:
    ``bf16_atol``, plus the tensor-core kernels' rounding of P to bf16
    before P.V (the plain versions keep it fp32). That moves each weight by
    at most 2^-8 of itself (bf16's unit roundoff), so an output, a
    normalised sum of weights times v, by at most 2^-8 max|v|."""
    return bf16_atol(ref) + 2.0 ** -8 * float(v.float().abs().max())


FP32_ATOL = 1e-4   # fp32 kernels vs plain fp32 (summation order only)

# One H100 SXM's published peaks (700 W): HBM bytes/s, and FLOP/s for the
# inputs' type: the dense bf16 tensor-core rate for bf16 inputs, the fp32
# rate outside the tensor cores for fp32 inputs (TF32 would round them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}


def bound(flops: float, nbytes: float, dtype) -> dict:
    """The least time the card could take for this work: the larger of
    the bytes that must move over the memory rate and the operations over
    the peak rate for the inputs' type."""
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def zero_launches(kernels):
    """Set the launch counts of these wrappers to 0 (K8's wrapper also
    counts its tensor-core launches apart, ``tc_launches``)."""
    for fn in kernels:
        fn.launches = 0
        if hasattr(fn, "tc_launches"):
            fn.tc_launches = 0


def kernel_launches(kernels) -> dict:
    """{wrapper name: launches}, with K8's tensor-core launches as
    ``int8_matmul_kernel_tc``."""
    out = {}
    for fn in kernels:
        out[fn.__name__] = fn.launches
        if hasattr(fn, "tc_launches"):
            out[f"{fn.__name__}_kernel_tc"] = fn.tc_launches
    return out


def achieved(flops: float, ms: float, rec: dict) -> str:
    """Achieved TFLOP/s and the share of the bound a kernel time reaches."""
    return (f"{flops / ms / 1e9:.1f} TFLOP/s, {rec['bound_ms'] / ms:.3f} of "
            f"the bound ({rec['bound_by']})")


def tensor_core_kernels(so: Path) -> dict:
    """HMMA (tensor-core) instructions, registers and stack bytes of each
    bf16 tensor-core kernel in the built library (the attention kernels,
    K8's and K9/K10's), from ``cuobjdump -sass`` and ``-res-usage``:
    {"flash_fwd_kernel_tc<64>": (hmma, regs, stack),
    "int8_matmul_kernel_tc<1,1>": ..., ...}."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"

    def dump(flag):
        return subprocess.run([str(tool), flag, str(so)], capture_output=True,
                              text=True, check=True, timeout=300).stdout

    # a template's int parameters, mangled: ILi64E, ILi1ELi2EE
    pat = re.compile(r"(flash_fwd_kernel_tc|flash_bwd_dq_kernel_tc|"
                     r"flash_bwd_dkv_kernel_tc|short_fwd_kernel_tc|"
                     r"short_bwd_dq_kernel_tc|short_bwd_dkv_kernel_tc|"
                     r"int8_matmul_kernel_tc|int4_matmul_kernel_tc)"
                     r"I((?:Li\d+E)+)")

    def kernel_name(line):
        m = pat.search(line)
        if not m:
            return None
        args = ",".join(re.findall(r"Li(\d+)E", m.group(2)))
        return f"{m.group(1)}<{args}>"

    found, name = {}, None
    for line in dump("-sass").splitlines():
        if "Function :" in line:
            name = kernel_name(line)
            if name:
                found[name] = [0, None, None]
        elif name and "HMMA" in line:
            found[name][0] += 1
    name = None
    for line in dump("-res-usage").splitlines():
        if "Function" in line:
            name = kernel_name(line)
        elif name in found:
            regs = re.search(r"REG:(\d+)", line)
            stack = re.search(r"STACK:(\d+)", line)
            if regs and stack:
                found[name][1:] = [int(regs.group(1)), int(stack.group(1))]
    return {k: tuple(v) for k, v in sorted(found.items())}


TC_KERNELS = ("flash_fwd_kernel_tc<128>", "flash_fwd_kernel_tc<64>",
              "flash_bwd_dq_kernel_tc<128>", "flash_bwd_dq_kernel_tc<64>",
              "flash_bwd_dkv_kernel_tc<128>", "flash_bwd_dkv_kernel_tc<64>",
              "short_fwd_kernel_tc<128>", "short_fwd_kernel_tc<32>",
              "short_fwd_kernel_tc<64>", "short_bwd_dq_kernel_tc<128>",
              "short_bwd_dq_kernel_tc<32>", "short_bwd_dq_kernel_tc<64>",
              "short_bwd_dkv_kernel_tc<128>", "short_bwd_dkv_kernel_tc<32>",
              "short_bwd_dkv_kernel_tc<64>", "int8_matmul_kernel_tc<1,1>",
              "int8_matmul_kernel_tc<4,2>", "int8_matmul_kernel_tc<4,4>",
              # <mode, MT, NT>: fold 0, stream 2, noscale 3
              "int4_matmul_kernel_tc<0,1,1>", "int4_matmul_kernel_tc<0,4,2>",
              "int4_matmul_kernel_tc<0,4,4>",
              "int4_matmul_kernel_tc<2,1,1>", "int4_matmul_kernel_tc<3,1,1>")


# K4's split-KV pair: the partitions' kernel and their combine
K4_KERNELS = ("paged_decode_split_kernel", "paged_decode_combine_kernel")


def k4_kernels(so: Path) -> dict:
    """Registers, shared memory and stack bytes of each instantiation of
    K4's two kernels in the built library (``cuobjdump -res-usage``):
    {"paged_decode_split_kernel<bf16,128,0,2>": (regs, smem, stack), ...};
    the split kernel's arguments are q's type, D, the pool (0 float, 1
    int8, 2 int4) and the query rows a lane keeps (2 or 8)."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    text = subprocess.run([str(tool), "-res-usage", str(so)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    pat = re.compile(r"(" + "|".join(K4_KERNELS) + r")I(13__nv_bfloat16|f)"
                     r"((?:Li\d+E)+)")
    found, name = {}, None
    for line in text.splitlines():
        if "Function" in line:
            m = pat.search(line)
            name = None
            if m:
                args = ["bf16" if m.group(2) != "f" else "f32"]
                args += re.findall(r"Li(\d+)E", m.group(3))
                name = f"{m.group(1)}<{','.join(args)}>"
        elif name:
            vals = [re.search(rf"{k}:(\d+)", line)
                    for k in ("REG", "SHARED", "STACK")]
            if all(vals):
                found[name] = tuple(int(v.group(1)) for v in vals)
                name = None
    return dict(sorted(found.items()))


def live_mask(torch, bias, lq, lk, causal, q_offset):
    """Which (query, key) pairs a call attends ``[B|1, H|1, Lq, Lk]``:
    the bias above the mask constant and, with ``causal``, keys at or
    before ``q_offset + row``."""
    ok = None if bias is None else bias > -1e30
    if causal:
        dev = bias.device if bias is not None else "cuda"
        rows = q_offset + torch.arange(lq, device=dev)[:, None]
        tri = torch.arange(lk, device=dev)[None, :] <= rows
        ok = tri if ok is None else ok & tri
    return ok


def live_pairs(torch, bias, b, h, lq, lk, causal=False, q_offset=None):
    """The count of attended (query, key) pairs over batch and heads."""
    ok = live_mask(torch, bias, lq, lk, causal,
                   lk - lq if q_offset is None else q_offset)
    if ok is None:
        return b * h * lq * lk
    return int(ok.expand(b, h, lq, lk).sum())


def sdpa_mask(torch, bias, lq, lk, causal, q_offset, dtype):
    """The additive mask ``scaled_dot_product_attention`` takes for the
    same call (in q's dtype), or None."""
    ok = live_mask(torch, None, lq, lk, causal,
                   lk - lq if q_offset is None else q_offset)
    neg = float(torch.finfo(torch.float32).min)
    mask = None if ok is None else torch.where(ok, 0.0, neg)
    if bias is not None:
        mask = bias if mask is None else torch.clamp_min(bias + mask, neg)
    return None if mask is None else mask.to(dtype)


# K4's cases besides phase 2's ragged batch: phase 5's traced tick (every
# lane at ctx 500) and one lane at 1,024 tokens
K4_LENS = {"ragged": [1, 16, 17, 100, 255, 256, 300, 511, 512, 513, 700,
                      999, 1023, 1024, 0, 1500],
           "tick": [500] * 16, "one lane": [1024]}


def k4_case(torch, pdm, flush, card, label, q, pool, bt, sl, h_kv,
            sc=None, per_row=None):
    """One K4 call against its plain version: the error bound, a dead lane
    (seq_len 0) at 0, five calls with the same bits; then the plan, the
    kernel pair's time, the plain version's, the bound and its share.
    ``per_row``: stored bytes of one K (or V) row with its scale."""
    fn = lambda: pdm.paged_decode(q, pool, bt, sl, h_kv, scales=sc)  # noqa
    ref_fn = lambda: pdm.paged_attention_decode_ref(  # noqa: E731
        q, pool, bt, sl, h_kv, sc)
    out = fn()
    torch.cuda.synchronize()
    ref = ref_fn()
    err = float((out.float() - ref.float()).abs().max())
    atol = FP32_ATOL if q.dtype == torch.float32 else bf16_atol(ref)
    check(err <= atol, f"K4 {label}: max err {err} > {atol}")
    dead = (sl == 0).nonzero().flatten().tolist()
    check(all(bool(torch.all(out[i] == 0)) for i in dead),
          f"K4 {label}: a dead lane is not 0")
    again = [fn() for _ in range(5)]
    torch.cuda.synchronize()
    check(all(torch.equal(o, out) for o in again),
          f"K4 {label}: five calls differ in their bits")
    ms = cuda_ms(fn, flush)
    plain_ms = cuda_ms(ref_fn, flush)
    b, h, d = q.shape
    maxb = bt.shape[1]
    bs = pool.shape[2]
    live = int(torch.clamp(sl.long(), 0, maxb * bs).sum())
    if per_row is None:
        per_row = h_kv * d * q.element_size()
    # no single PyTorch call reads a block-table pool
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
               **bound(4 * d * h * live,
                       nbytes(q, out, bt, sl) + 2 * live * per_row,
                       q.dtype))
    part, splits = pdm._decode_plan(b, h_kv, bs, maxb)
    phase(f"K4 {label}: plan P={part} S={splits} grid {b}x{h_kv}x{splits}="
          f"{b * h_kv * splits}; max_abs_err={err} (atol {atol}), 5 calls "
          f"bit-identical; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), share "
          f"{rec['bound_ms'] / ms:.3f} [{card}]")
    return rec


def phase_decode(torch, pdm, flush, card):
    """K4 at B=16, H=16, H_kv=8, BS=16, MAXB=64 (one lane: B=1): phase
    2's ragged batch, phase 5's tick and one lane at 1,024 tokens."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    h, h_kv, bs, maxb = 16, 8, 16, 64
    main = None
    for case, lens in K4_LENS.items():
        b = len(lens)
        nb = b * maxb
        for d, dtype in ((128, torch.bfloat16), (128, torch.float32),
                         (64, torch.bfloat16)):
            q = torch.randn(b, h, d, device=dev, generator=g).to(dtype)
            pool = torch.randn(nb, 2, bs, h_kv * d, device=dev,
                               generator=g).to(dtype)
            bt = torch.randperm(nb, device=dev, generator=g).reshape(
                b, maxb).int()
            sl = torch.tensor(lens, dtype=torch.int32, device=dev)
            if case == "ragged":   # partial blocks, a dead lane, oversized
                bt[3, 7:] = -1     # unused entries past the live ones
            rec = k4_case(torch, pdm, flush, card,
                          f"paged_decode {case} D={d} {str(dtype)[6:]}", q,
                          pool, bt, sl, h_kv)
            if main is None:
                main = rec
            del q, pool
    torch.cuda.empty_cache()
    return main


def _engine_bias(torch, n, tp, tctx, dev, g):
    """The serving prefill's causal-with-offset mask [N, 1, Tp, Tctx]."""
    cached = torch.randint(0, tctx - tp, (n,), device=dev, generator=g)
    t = torch.randint(1, tp + 1, (n,), device=dev, generator=g)
    t[0] = tp
    ar = torch.arange(tp, device=dev)
    pos = torch.minimum(cached[:, None] + ar, (cached + t - 1)[:, None])
    k_pos = torch.arange(tctx, device=dev)[None, None, :]
    ok = (k_pos <= pos[:, :, None]) & (k_pos < (cached + t)[:, None, None])
    return torch.where(ok, 0.0, float(torch.finfo(torch.float32).min)
                       ).float()[:, None]


def phase_flash(torch, flash_fwd, ref_fn, flush, card):
    """K1 at N=4, H=16, H_kv=8, Tctx=1024 with the engine's bias, at the
    training shapes (B=4, H=16, H_kv=4, L=1024, D=64, causal + zero pad
    bias), and at the contract's edges in bf16 and fp32: ragged lengths,
    D=64 causal, fully masked rows (output 0, lse -1e30)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    bf, f32 = torch.bfloat16, torch.float32
    main = None
    cases = [  # (label, n, h, h_kv, lq, lk, d, dtype, bias kind, causal)
        ("Tp=512 engine bias", 4, 16, 8, 512, 1024, 128, bf, "engine",
         False),
        ("Tp=32 engine bias", 4, 16, 8, 32, 1024, 128, bf, "engine", False),
        ("Tp=512 engine bias", 4, 16, 8, 512, 1024, 128, f32, "engine",
         False),
        ("ragged Lq=37 Lk=1000", 4, 16, 8, 37, 1000, 128, bf, "engine",
         False),
        ("ragged Lq=37 Lk=1000", 4, 16, 8, 37, 1000, 128, f32, "engine",
         False),
        ("causal flag", 4, 16, 8, 512, 1024, 128, bf, None, True),
        ("D=64 causal", 4, 16, 8, 300, 300, 64, f32, None, True),
        ("D=64 causal", 4, 16, 8, 300, 300, 64, bf, None, True),
        ("masked rows", 4, 16, 4, 200, 333, 64, bf, "masked", False),
        ("masked rows", 4, 16, 8, 100, 260, 128, f32, "masked", False),
        ("training causal+pad bias", 4, 16, 4, 1024, 1024, 64, bf, "pad",
         True),
    ]
    neg = float(torch.finfo(torch.float32).min)
    for label, n, h, h_kv, lq, lk, d, dtype, kind, causal in cases:
        q = torch.randn(n, h, lq, d, device=dev, generator=g).to(dtype)
        k = torch.randn(n, h_kv, lk, d, device=dev, generator=g).to(dtype)
        v = torch.randn(n, h_kv, lk, d, device=dev, generator=g).to(dtype)
        bias = None
        if kind == "pad":             # the decoder's all-ones pad mask
            bias = torch.zeros(n, 1, 1, lk, device=dev)
        elif kind == "engine":
            bias = _engine_bias(torch, n, lq, lk, dev, g)
        elif kind == "masked":        # random masking, rows 7 and 8 dead
            bias = torch.randn(n, 1, lq, lk, device=dev, generator=g)
            bias[bias > 1.0] = neg
            bias[:, :, 7:9] = neg
        out, lse = flash_fwd(q, k, v, bias, causal=causal)
        torch.cuda.synchronize()
        ref, ref_lse = ref_fn(q, k, v, bias, causal=causal)
        err = float((out.float() - ref.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        atol = FP32_ATOL if dtype == f32 else attn_bf16_atol(ref, v)
        check(err <= atol, f"K1 {label} {dtype}: max err {err} > {atol}")
        check(lse_err <= 1e-3, f"K1 {label}: lse err {lse_err}")
        if kind == "masked":
            check(bool(torch.all(out[:, :, 7:9] == 0))
                  and bool(torch.all(lse[:, :, 7:9] == -1e30)),
                  f"K1 {label} {dtype}: a fully masked row is not 0 / -1e30")
        ms = cuda_ms(lambda: flash_fwd(q, k, v, bias, causal=causal), flush,
                     iters=10)
        plain_ms = cuda_ms(lambda: ref_fn(q, k, v, bias, causal=causal),
                           flush, iters=10)
        flops = 4 * d * live_pairs(torch, bias, n, h, lq, lk, causal)
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=None, **bound(
                       flops, nbytes(q, k, v, bias, out, lse), dtype))
        phase(f"K1 flash_fwd {label} D={d} {str(dtype)[6:]}: "
              f"max_abs_err={err} lse_err={lse_err} (atol {atol}) "
              f"kernel {ms:.4f} ms ({achieved(flops, ms, rec)}), plain "
              f"{plain_ms:.4f} ms [{card}]")
        if main is None:
            mask = sdpa_mask(torch, bias, lq, lk, causal, None, dtype)
            rec["library_ms"] = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=h != h_kv), flush,
                iters=10)
            main = rec
            phase(f"K1 main case: SDPA {rec['library_ms']:.4f} ms, bound "
                  f"{main['bound_ms']:.4f} ms ({main['bound_by']})")
    return main


def grad_atol(ref, bf16: bool, rounding: float = 0.0) -> float:
    """Kernel vs plain gradients on the same inputs, both reducing in fp32
    (the plain version over the whole key or query range at once): fp32
    summation order over up to group * L terms, bounded by 1e-4 of the
    largest value, plus for bf16 one ulp of the output after the final cast
    (2^-7 of its largest magnitude), plus ``rounding``: what a kernel's own
    bf16 rounding of an intermediate may move the gradient. For the bf16
    tensor-core K7 that is ``k7_rounding``'s term, for K2/K3
    ``flash_bwd_rounding``'s: at most 2^-8 max(P^T |dO|) for dV, 2^-8
    max(|dS|^T |q|) for dK and 2^-8 max(|dS| |k|) for dQ, dV and dK summed
    over the GQA group (P and dS rounded to bf16 before their products)."""
    top = float(ref.float().abs().max())
    return ((2.0 ** -7 if bf16 else 0.0) + 1e-4) * top + 1e-6 + rounding


def bwd_rounding(torch, p, ds, q, k, do, group: int = 1) -> dict:
    """What rounding P (into dV = P^T.dO) and dS (into dK = dS^T.q and dQ =
    dS.k) to bf16 before the products may move each gradient, where the
    plain version keeps them fp32. bf16's unit roundoff is 2^-8, so each
    rounded value moves by at most 2^-8 of itself and each gradient entry
    by at most 2^-8 times the sum of |rounded value| x |other operand| along
    the product: dV[k, d] by 2^-8 sum_q P[q, k] |dO[q, d]|, dK[k, d] by
    2^-8 sum_q |dS[q, k]| |q[q, d]|, dQ[q, d] by 2^-8 sum_k |dS[q, k]|
    |k[k, d]|, the first two summed over the q heads of a kv head's GQA
    group. ``p`` and ``ds`` are fp32 ``[B, H, Lq, Lk]``, k is ``[B, H /
    group, Lk, D]``. Returns each term's largest entry {"dq", "dk",
    "dv"}."""
    u = 2.0 ** -8
    ds = ds.abs()
    fk = k.float().abs().repeat_interleave(group, dim=1)
    terms = {
        "dq": torch.einsum("bhqk,bhkd->bhqd", ds, fk),
        "dk": torch.einsum("bhqk,bhqd->bhkd", ds, q.float().abs()),
        "dv": torch.einsum("bhqk,bhqd->bhkd", p, do.float().abs())}
    for name in ("dk", "dv"):
        t = terms[name]
        terms[name] = t.view(t.shape[0], -1, group, *t.shape[2:]).sum(2)
    return {name: u * float(t.max()) for name, t in terms.items()}


def k7_rounding(torch, q, k, v, bias, do, stats, delta) -> dict:
    """``bwd_rounding`` for the bf16 tensor-core K7, from the plain
    arithmetic in fp32 on the same inputs, with P from the forward's row
    (max, sum)."""
    f = [x.float() for x in (q, k, v, do)]
    scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("bhqd,bhkd->bhqk", f[0], f[1]) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - stats[..., :1]) / stats[..., 1:]
    del s
    ds = torch.einsum("bhqd,bhkd->bhqk", f[3], f[2])
    ds = p * (ds - delta[..., None]) * scale
    return bwd_rounding(torch, p, ds, q, k, do)


def flash_bwd_rounding(fa, q, k, v, bias, do, lse, delta, *,
                       causal=False, q_offset=None) -> dict:
    """``bwd_rounding`` for the bf16 tensor-core K2/K3, from the plain
    arithmetic in fp32 on the same inputs (``fa._p_ds``: P from the
    forward's lse, the causal mask with ``q_offset``, GQA)."""
    import torch
    p, ds, group = fa._p_ds(q, k, v, bias, do, lse, delta, causal, q_offset)
    return bwd_rounding(torch, p, ds, q, k, do, group)


def k7_issued_flops(b: int, h: int, l: int, d: int, bf16: bool) -> int:
    """FLOPs K7's two kernels issue: 2 * D a (query, key) pair for each of
    their seven products (dq: S, dP, dQ; dk/dv: S^T, dP^T, dV, dK). The
    tensor-core kernels take the rows of their live warps (L rounded up to
    16) against the columns of their live sub-steps (L rounded up to 32 in
    dq, to 16 in dk/dv); the CUDA-core ones every pair of 64-row tiles."""
    def up(n):
        return -(-l // n) * n
    if bf16:
        return 2 * d * b * h * up(16) * (3 * up(32) + 4 * up(16))
    return 14 * d * b * h * up(64) ** 2


def flash_bwd_issued_flops(b: int, h: int, lq: int, lk: int, d: int,
                           causal: bool, q_offset=None) -> tuple:
    """FLOPs the bf16 tensor-core K2 and K3 issue, ``(K2, K3)``: 2 * D a
    (query, key) pair for each of K2's three products (S, dP, dQ) and K3's
    four (S^T, dP^T, dV, dK), over the pairs their loops visit. Each warp
    owns 16 rows (q rows in K2, keys in K3) and takes its 64-wide tile a
    sub-step at a time (32 key columns in K2, 32 q columns in K3): K2 walks
    the K tiles up to its CTA's causal edge and stops each warp at its own
    edge and at Lk; K3 walks the q tiles from the first that sees its keys,
    skips the sub-steps wholly before a warp's edge and stops at Lq. Warps
    past the ragged edge issue nothing. The count is the same for every
    (batch, q head)."""
    t = 64
    if q_offset is None:
        q_offset = lk - lq
    nq, nk = -(-lq // t), -(-lk // t)
    dq = dkv = 0
    for qt in range(nq):
        q0, n_k = qt * t, nk
        if causal:
            last = q_offset + q0 + t - 1
            n_k = 0 if last < 0 else min(last // t + 1, nk)
        for w in range(0, t, 16):
            wlast = q_offset + q0 + w + 15
            for k0 in range(0, n_k * t, t) if q0 + w < lq else ():
                end = min(t, lk - k0, wlast - k0 + 1 if causal else t)
                dq += 16 * -(-max(end, 0) // 32) * 32
    for k0 in range(0, nk * t, t):
        first_q = 0 if not causal else min(max(k0 - q_offset, 0) // t, nq)
        for w in range(0, t, 16):
            for q0 in range(first_q * t, nq * t, t) if k0 + w < lk else ():
                begin, first = 0, k0 + w - q_offset - q0
                if causal and first > 0:
                    begin = t if first >= t else first // 32 * 32
                dkv += 16 * 32 * len(range(begin, min(t, lq - q0), 32))
    return 6 * d * b * h * dq, 8 * d * b * h * dkv


def phase_flash_bwd(torch, fa, flush, card):
    """K2/K3 against their plain versions at the training shapes (B=4,
    H=16, H_kv=4, L=1024, D=64, bf16, causal + zero pad bias) and at the
    contract's edges, bf16 and fp32: D=128, ragged lengths with q_offset,
    a full bias with a fully masked row, GQA groups 1 and 8, causal rows
    before every key (Lq > Lk), and bias rows that are not 16-byte aligned
    (Lk = 1001, which the bf16 wrappers pad). A row that sees no key must
    get a gradient of exactly 0."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # (label, b, h, h_kv, lq, lk, d, dtype, bias rows, q_offset)
        ("training causal+pad bias", 4, 16, 4, 1024, 1024, 64, bf, 1, None),
        ("D=128 H_kv=8 causal", 4, 16, 8, 1024, 1024, 128, f32, 0, None),
        ("D=128 H_kv=8 causal", 4, 16, 8, 1024, 1024, 128, bf, 0, None),
        ("ragged Lq=37 Lk=1000 q_offset=900", 4, 16, 4, 37, 1000, 64, bf, 0,
         900),
        ("full bias, masked rows", 4, 16, 4, 512, 512, 128, bf, 512, None),
        ("group 1 causal", 4, 16, 16, 1024, 1024, 64, bf, 1, None),
        ("group 8 causal+pad bias", 4, 16, 2, 1024, 1024, 64, bf, 1, None),
        ("causal Lq=300 > Lk=200", 4, 16, 4, 300, 200, 64, bf, 0, None),
        ("causal Lq=300 > Lk=200", 4, 16, 4, 300, 200, 64, f32, 0, None),
        ("unaligned pad bias Lk=1001", 4, 16, 4, 1001, 1001, 64, bf, 1,
         None),
        ("unaligned full bias Lq=300 Lk=1001", 2, 16, 4, 300, 1001, 128, bf,
         300, None),
    ]
    main = None
    for label, b, h, h_kv, lq, lk, d, dtype, rows, q_off in cases:
        q = torch.randn(b, h, lq, d, device=dev, generator=g).to(dtype)
        k = torch.randn(b, h_kv, lk, d, device=dev, generator=g).to(dtype)
        v = torch.randn(b, h_kv, lk, d, device=dev, generator=g).to(dtype)
        do = torch.randn(b, h, lq, d, device=dev, generator=g).to(dtype)
        causal = rows <= 1
        bias = None
        if rows == 1:
            bias = torch.zeros(b, 1, 1, lk, device=dev)
        elif rows:
            bias = torch.randn(b, 1, rows, lk, device=dev, generator=g)
            bias[bias > 1.0] = float(torch.finfo(torch.float32).min)
            bias[:, :, 7] = float(torch.finfo(torch.float32).min)
        kw = dict(causal=causal, q_offset=q_off)
        out, lse = fa.flash_attention_fwd(q, k, v, bias, **kw)
        delta = fa._delta(out, do)
        dq = fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, bias, do, lse, delta, **kw)
        torch.cuda.synchronize()
        ref_dq = fa.flash_bwd_dq_ref(q, k, v, bias, do, lse, delta, **kw)
        ref_dk, ref_dv = fa.flash_bwd_dkv_ref(q, k, v, bias, do, lse, delta,
                                              **kw)
        rounding = (flash_bwd_rounding(fa, q, k, v, bias, do, lse, delta,
                                       **kw) if dtype == bf else {})
        errs = {}
        for name, x, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                             ("dv", dv, ref_dv)):
            err = float((x.float() - ref.float()).abs().max())
            atol = grad_atol(ref, dtype == bf, rounding.get(name, 0.0))
            check(bool(torch.isfinite(x).all()), f"K2/K3 {label}: {name} "
                  "not finite")
            check(err <= atol, f"K2/K3 {label} {dtype}: {name} max err "
                  f"{err} > {atol}")
            errs[name] = (err, atol)
        ok = live_mask(torch, bias, lq, lk, causal,
                       lk - lq if q_off is None else q_off)
        if ok is not None:   # rows that see no key: exactly zero gradient
            dead = ~ok.any(dim=-1).expand(b, h, lq)
            check(bool(dead.any()) == (rows > 1 or lq > lk)
                  and bool(torch.all(dq[dead] == 0)),
                  f"K2 {label}: a row that sees no key got a nonzero "
                  "gradient")
        t = {
            "K2": cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, bias, do, lse,
                                                  delta, **kw), flush, 10),
            "K3": cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, bias, do, lse,
                                                   delta, **kw), flush, 10),
            "K2 plain": cuda_ms(lambda: fa.flash_bwd_dq_ref(
                q, k, v, bias, do, lse, delta, **kw), flush, 10),
            "K3 plain": cuda_ms(lambda: fa.flash_bwd_dkv_ref(
                q, k, v, bias, do, lse, delta, **kw), flush, 10),
        }
        pairs = live_pairs(torch, bias, b, h, lq, lk, causal, q_off)
        ins = (q, k, v, do, lse, delta, bias)
        recs = {
            "flash_bwd_dq": dict(
                max_abs_err=errs["dq"][0], ms=t["K2"],
                plain_ms=t["K2 plain"], library_ms=None,
                **bound(6 * d * pairs, nbytes(*ins, dq), dtype)),
            "flash_bwd_dkv": dict(
                max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                ms=t["K3"], plain_ms=t["K3 plain"], library_ms=None,
                **bound(8 * d * pairs, nbytes(*ins, dk, dv), dtype))}
        rates = ""
        if dtype == bf:
            issued = flash_bwd_issued_flops(b, h, lq, lk, d, causal, q_off)
            rates = "; " + ", ".join(
                f"{n} {f / t[n] / 1e9:.1f} TFLOP/s issued ({f} FLOP), "
                f"{live / t[n] / 1e9:.1f} on live pairs, "
                f"{recs[r]['bound_ms'] / t[n]:.3f} of the bound "
                f"({recs[r]['bound_by']})"
                for n, r, f, live in (
                    ("K2", "flash_bwd_dq", issued[0], 6 * d * pairs),
                    ("K3", "flash_bwd_dkv", issued[1], 8 * d * pairs)))
        phase(f"K2/K3 flash_bwd {label} D={d} {str(dtype)[6:]}: max_abs_err "
              + ", ".join(f"{n}={e:.3g} (atol {a:.3g})"
                          for n, (e, a) in errs.items())
              + "; " + ", ".join(f"{n} {ms:.4f} ms" for n, ms in t.items())
              + rates + f" [{card}]")
        if main is None:
            # SDPA's backward computes dq, dk and dv at once: one figure
            # for K2 + K3
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            lib_out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=sdpa_mask(torch, bias, lq, lk, causal,
                                             q_off, dtype),
                enable_gqa=h != h_kv)
            lib_ms = cuda_ms(lambda: torch.autograd.grad(
                lib_out, leaves, do, retain_graph=True), flush, 10)
            main = recs
            for rec in main.values():
                rec["library_ms"] = lib_ms
            phase(f"K2+K3 main case: {t['K2'] + t['K3']:.4f} ms, SDPA "
                  f"backward {lib_ms:.4f} ms (ratio "
                  f"{(t['K2'] + t['K3']) / lib_ms:.3f}); bounds K2 "
                  f"{main['flash_bwd_dq']['bound_ms']:.4f} ms, K3 "
                  f"{main['flash_bwd_dkv']['bound_ms']:.4f} ms [{card}]")
            del leaves, lib_out
        del q, k, v, do, out, lse, delta, dq, dk, dv, ref_dq, ref_dk, ref_dv
    torch.cuda.empty_cache()
    return main


def clone_pool(pool):
    return ({k: v.clone() for k, v in pool.items()}
            if isinstance(pool, dict) else pool.clone())


def pools_equal(torch, pm, a, b) -> bool:
    return all(torch.equal(x, y)
               for x, y in zip(pm.pool_parts(a), pm.pool_parts(b))
               if x is not None)


def device_kernels(torch, prof, expect=K4_KERNELS):
    """``({kernel name: [device ms, count]}, source)`` of a trace: the
    device events of ``key_averages()`` where they hold a kernel named in
    ``expect``, else the trace's own kernel events (which also list a
    replayed CUDA graph's kernels)."""
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        ms, n = out.get(e.key, (0.0, 0))
        out[e.key] = [ms + t / 1e3, n + e.count]
    if any(name in k for k in out for name in expect):
        return out, "key_averages"
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        ms, n = out.get(e.name(), (0.0, 0))
        out[e.name()] = [ms + e.duration_ns() / 1e6, n + 1]
    return out, "trace kernel events"


def decode_tick_ms(torch, pm, eng, steps: int = 8, ctx: int = 500,
                   walls: int = 5):
    """Two decode ticks (``steps`` steps, the engine's horizon) of all
    ``max_batch`` lanes at position ``ctx``, on the same inputs over copies
    of the engine's pool: the eager ``paged_model.decode_horizon`` and the
    engine's graph tick (``HorizonGraph``: one captured step, replayed).
    For each: device kernel ms per step from a ``torch.profiler`` trace of
    one tick (and which part of the trace gave it), the unprofiled wall ms
    per step (median, min and max of ``walls`` ticks, each ended by a
    synchronise) and the same ticks' CUDA-event ms per step (median; from
    before the tick's first launch to after its last on the card's clock:
    events - device is the card's idle time inside the tick, wall - events
    the host's time outside it), the idle share ``1 - device / median
    wall``, the three kernels with the most
    device time, K8's, K9's and K4's device ms per step (K4: both kernels
    of its split-KV pair), and the launches per step of each K4 kernel. The
    device figures are None when the profiler saw no device time. Checks
    that the two ticks give identical tokens and leave identical pools."""
    b, bs, maxb = eng.max_batch, eng.block_size, eng.max_blocks_per_seq
    need = -(-(ctx + steps) // bs)
    dev = eng.device
    tables = torch.full((b, maxb), -1, dtype=torch.int32, device=dev)
    tables[:, :need] = torch.arange(b * need, dtype=torch.int32,
                                    device=dev).reshape(b, need)
    toks = (torch.arange(b, device=dev) + 7).to(torch.int32)
    pos = torch.full((b,), ctx, device=dev)
    live = torch.ones(b, dtype=torch.bool, device=dev)
    budget = torch.full((b,), steps, dtype=torch.int32, device=dev)
    pool_e = clone_pool(eng.pool)
    graph = eng.horizon_graph()

    def eager():
        return pm.decode_horizon(eng.model, pool_e, toks, pos, tables, live,
                                 steps, budget=budget)

    def replay():
        graph.start(pos, tables, live, budget, tokens=toks)
        return graph.run(steps)

    res = {}
    for label, tick in (("eager", eager), ("graph", replay)):
        out = [t.clone() for t in tick()]
        torch.cuda.synchronize()
        times, events = [], []
        for _ in range(walls):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0 = time.perf_counter()
            e0.record()
            tick()
            e1.record()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / steps)
            events.append(e0.elapsed_time(e1) / steps)
        wall = statistics.median(times)
        spread = (min(times), max(times))
        act = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            tick()
            torch.cuda.synchronize()
        kern, source = device_kernels(torch, prof)
        total = sum(ms for ms, _ in kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:3]

        def per_step(pred):
            ms = sum(v[0] for k, v in kern.items() if pred(k))
            return ms / steps if total > 0 else None
        res[label] = {
            "out": out, "wall_ms": wall, "wall_range_ms": spread,
            "event_ms": statistics.median(events), "source": source,
            "device_ms": (total / steps) if total > 0 else None,
            "idle": (1 - total / steps / wall) if total > 0 else None,
            "top": [(k[:60], round(v[0] / steps, 4)) for k, v in top],
            "k8_ms": per_step(lambda k: "int8_matmul_kernel" in k),
            "k9_ms": per_step(lambda k: "int4_matmul_kernel" in k),
            "k4_ms": per_step(lambda k: any(n in k for n in K4_KERNELS)),
            "k4_calls": {n: sum(v[1] for k, v in kern.items() if n in k)
                         / steps for n in K4_KERNELS}}
    check(all(torch.equal(a, b) for a, b in zip(res["eager"]["out"],
                                                res["graph"]["out"])),
          "the graph tick's tokens differ from the eager tick's")
    check(pools_equal(torch, pm, pool_e, eng.pool),
          "the graph tick left another pool than the eager tick")
    del pool_e
    return res


def tick_text(t: dict, quant: bool) -> str:
    if t["device_ms"] is None:
        return f"device not measured, wall {t['wall_ms']:.4f} ms"
    lo, hi = t["wall_range_ms"]
    txt = (f"device {t['device_ms']:.4f} ms, wall {t['wall_ms']:.4f} ms "
           f"(min {lo:.4f}, max {hi:.4f}), events {t['event_ms']:.4f} ms, "
           f"idle {t['idle']:.3f}, K4 {t['k4_ms']:.4f} ms (launches / step "
           f"{t['k4_calls']})")
    if quant:
        txt += f", K8 {t['k8_ms']:.4f} ms, K9 {t['k9_ms']:.4f} ms"
    return txt + f", top {t['top']} ({t['source']})"


def serve_waves(torch, eng, waves):
    """Every wave submitted and drained; ``({request id: tokens}, wall s)``
    (request ids count from 0 in each engine)."""
    outs = {}
    t0 = time.perf_counter()
    for wave in waves:
        ids = [eng.submit(p) for p in wave]
        done = eng.run()
        outs.update({i: done[i] for i in ids})
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def phase_serving(torch, np, tt, pm, kernels, card, label="bf16",
                  quant=None, pool_dtype=None, reference=None,
                  sync_rerun=False):
    """24 requests at Qwen3-0.6B width through the engine (pipelined ticks,
    each a replay of the captured decode step): bf16 weights and pool
    (phase 5), or the same seeded weights through
    ``quantize_model(**quant)`` with a ``pool_dtype`` pool (phase 15).
    ``reference``: phase 5's tokens, to report the share that agree.
    ``sync_rerun``: serve the same requests again with
    ``pipeline_decode=False`` on the same weights; the tokens must be
    identical."""
    dev = torch.device("cuda")
    cfg = tt.QwenConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = tt.ModelForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    model.init(gen)
    model.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    if quant is not None:
        tt.quantize_model(model, **quant)

    def engine(pipeline):
        eng = tt.ContinuousBatchEngine(
            model, num_blocks=1024, block_size=16, max_batch=16,
            max_blocks_per_seq=64, max_new_tokens=64, eos_token_id=-1,
            decode_horizon=8, dtype=pool_dtype or torch.bfloat16,
            pipeline_decode=pipeline, device=dev)
        t1 = time.perf_counter()
        eng.horizon_graph()          # capture the decode step: set-up
        eng.prefill_graphs()         # and a prefill a bucket
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t1

    eng, capture_s = engine(True)
    m0 = eng.metrics()
    phase(f"engine ready ({label}): {n_params} params, weights "
          f"{m0['weight_bytes']} bytes, pool {m0['pool_bytes']} bytes, "
          f"decode step and prefill buckets captured in {capture_s:.2f} s "
          f"({time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(0)
    wave1 = [rng.integers(0, cfg.vocab_size, rng.integers(300, 501)).tolist()
             for _ in range(16)]
    wave2 = [wave1[i][:256] + rng.integers(
        0, cfg.vocab_size, rng.integers(20, 61)).tolist() for i in range(8)]
    zero_launches(kernels)
    outs, wall = serve_waves(torch, eng, (wave1, wave2))
    launches = kernel_launches(kernels)
    m = eng.metrics()
    check(len(outs) == 24, f"{len(outs)} of 24 requests returned")
    check(all(len(t) == 64 for t in outs.values()), "a request != 64 tokens")
    check(all(0 <= x < cfg.vocab_size for t in outs.values() for x in t),
          "token outside the vocab")
    check(all(n > 0 for n in launches.values()),
          f"a kernel never ran on the main path: {launches}")
    check(m["cached_prompt_tokens"] > 0, "wave 2 never hit the prefix cache")
    check(m["chained_ticks"] > 0, "no decode tick was chained")
    tokens = sum(len(t) for t in outs.values())
    agree = ""
    if reference is not None:
        same = sum(a == b for i in outs for a, b in zip(outs[i],
                                                        reference[i]))
        agree = f", greedy tokens agreeing with bf16 {same / tokens:.4f}"
    tick = decode_tick_ms(torch, pm, eng)
    n_layers = cfg.num_hidden_layers
    for name in ("eager", "graph"):
        t = tick[name]
        if t["device_ms"] is None:
            continue
        # each traced tick went through the pair, once a layer a step
        check(all(c == n_layers for c in t["k4_calls"].values()),
              f"K4's split-KV pair did not run once a layer in the {name} "
              f"tick: {t['k4_calls']}")
        if quant is not None:
            check(t["k8_ms"] > 0, f"K8 did not run in the {name} tick")
            check(quant.get("bits") != 4 or t["k9_ms"] > 0,
                  f"K9 did not run in the {name} tick")
    phase(f"serving Qwen3-0.6B width {label} (pipelined): {tokens} tokens "
          f"in {wall:.3f} s = {tokens / wall:.1f} tok/s, mean TTFT "
          f"{m['ttft_mean_s']:.4f} s, prefix hits {m['radix_hits']} "
          f"({m['cached_prompt_tokens']} cached prompt tokens), prefill "
          f"calls {m['prefill_calls']}, decode ticks {m['decode_ticks']} "
          f"(chained {m['chained_ticks']}), weights {m['weight_bytes']} "
          f"bytes, pool {m['pool_bytes']} bytes{agree}; launches "
          f"{launches} [{card}]")
    for name in ("eager", "graph"):
        phase(f"decode tick {label} {name} (B=16, ctx 500, 8 steps), per "
              f"step: {tick_text(tick[name], quant is not None)} [{card}]")
    phase(f"decode tick {label}: graph and eager ticks give identical "
          "tokens and pools")
    res = {"launches": launches, "outs": outs, "tick": tick,
           "tok_s": tokens / wall, "ttft_s": m["ttft_mean_s"],
           "chained": m["chained_ticks"]}
    del eng
    torch.cuda.empty_cache()
    if sync_rerun:
        eng, _ = engine(False)
        outs_s, wall_s = serve_waves(torch, eng, (wave1, wave2))
        m_s = eng.metrics()
        check(outs_s == outs, f"{label}: pipelined and synchronous tokens "
              "differ")
        check(m_s["chained_ticks"] == 0, "a synchronous engine chained")
        phase(f"serving {label} synchronous (pipeline_decode=False): "
              f"{tokens} tokens in {wall_s:.3f} s = {tokens / wall_s:.1f} "
              f"tok/s, mean TTFT {m_s['ttft_mean_s']:.4f} s, decode ticks "
              f"{m_s['decode_ticks']} (chained {m_s['chained_ticks']}); "
              f"pipelined {tokens / wall:.1f} tok/s, mean TTFT "
              f"{m['ttft_mean_s']:.4f} s, chained {m['chained_ticks']}; "
              f"tokens identical [{card}]")
        res.update(sync_tok_s=tokens / wall_s, sync_ttft_s=m_s["ttft_mean_s"])
        del eng
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return res


def k11_library(torch, F, x, src, offsets, w1, w3, w2):
    """``(fn, name)``: the library's grouped product over the rows in use,
    ``torch._grouped_mm`` for gate/up and down where this torch has it,
    else one ``torch.matmul`` an expert."""
    e, i, _ = w1.shape
    used = int(offsets[-1])
    xs = x[src[:used]]
    if hasattr(torch, "_grouped_mm"):
        w13 = torch.cat([w1, w3], 1).transpose(1, 2)     # [E, H, 2I]
        w2t = w2.transpose(1, 2)                          # [E, I, H]
        ends = offsets[1:].to(torch.int32)

        def grouped():
            gu = torch._grouped_mm(xs, w13, offs=ends)
            return torch._grouped_mm(F.silu(gu[:, :i]) * gu[:, i:], w2t,
                                     offs=ends)
        try:
            grouped()
            return grouped, "torch._grouped_mm"
        except RuntimeError:
            pass
    off = offsets.tolist()

    def loop():
        for j in range(e):
            a, b = off[j], off[j + 1]
            if b > a:
                h = F.silu(xs[a:b] @ w1[j].t()) * (xs[a:b] @ w3[j].t())
                h @ w2[j].t()
    return loop, "torch.matmul per expert"


def phase_k11(torch, gm, moe, flush, card):
    """K11 at LFM2-8B-A1B's expert widths (32 experts, 1,792 x 2,048,
    bf16) under a random top-4, at a decode step of 128 lanes (512 rows)
    and a prefill call of 4 x 512 slots, 30 % of them real (the rest route
    to no expert): against its plain version within
    ``grouped_matmul.rounding_bound`` at every element, five calls
    bit-identical, then its time beside the plain version's and the
    library's grouped product (``k11_library``) and its bound (each expert
    with a row reads its three matrices once, each row its activations in
    and out)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    e, i, h, k = 32, 1792, 2048, 4
    g = torch.Generator(device=dev).manual_seed(19)
    w1, w3, w2 = (0.02 * torch.randn(s, generator=g, device=dev).to(
        torch.bfloat16) for s in ((e, i, h), (e, i, h), (e, h, i)))
    recs = {}
    for name, tokens, share in (("decode", 128, 1.0), ("prefill", 2048, 0.3)):
        x = torch.randn(tokens, h, generator=g, device=dev).to(torch.bfloat16)
        sel = torch.rand(tokens, e, generator=g, device=dev).topk(
            k, -1).indices
        valid = torch.arange(tokens, device=dev) < int(share * tokens)
        _, src, offsets = moe.dispatch(sel, e, valid)
        args = (x, src, offsets, w1, w3, w2)
        used = int(offsets[-1])
        got = gm.grouped_swiglu(*args)
        want = gm.grouped_swiglu_ref(*args)
        err = (got[:used].float() - want[:used].float()).abs()
        tol = gm.rounding_bound(*args)[:used]
        check(bool((err <= tol).all()), f"K11 {name}: error "
              f"{float(err.max())} over the bound at "
              f"{int((err > tol).sum())} elements")
        check(all(torch.equal(gm.grouped_swiglu(*args)[:used], got[:used])
                  for _ in range(5)), f"K11 {name}: calls differ")
        visits = int((offsets[1:] > offsets[:-1]).sum())
        flops = 2.0 * 3 * i * h * used
        rec = bound(flops, 3.0 * i * h * 2 * visits + 2.0 * h * 2 * used,
                    torch.bfloat16)
        lib, lib_name = k11_library(torch, F, *args)
        rec.update(rows=used, visits=visits,
                   ms=cuda_ms(lambda: gm.grouped_swiglu(*args), flush),
                   plain_ms=cuda_ms(lambda: gm.grouped_swiglu_ref(*args),
                                    flush, iters=5),
                   library_ms=cuda_ms(lib, flush), library=lib_name,
                   max_err=float(err.max()), max_bound=float(tol.max()))
        phase(f"K11 {name} ({used} rows, {visits} experts): max error "
              f"{rec['max_err']:.3e} within the bound; {rec['ms']:.4f} ms, "
              f"{achieved(flops, rec['ms'], rec)}; plain "
              f"{rec['plain_ms']:.4f} ms, {lib_name} "
              f"{rec['library_ms']:.4f} ms; bound {rec['bound_ms']:.4f} ms "
              f"[{card}]")
        recs[name] = rec
        del x, got, want, err, tol
    del w1, w3, w2
    torch.cuda.empty_cache()
    return recs


def phase_lfm2_serving(torch, np, tt, kernels, card):
    """LFM2-8B-A1B at its published widths (``Lfm2MoeConfig()``, random
    bf16 weights from a seeded generator) through the engine with both
    captured graphs (the decode step and a prefill a bucket): 48 requests
    of 100 to 500 tokens on 32 lanes, so that lanes are refilled, 64 new
    tokens each. The kernels' launch counts are zeroed just before and
    read just after; the engine's MoE counters must count every routed
    row exactly (tokens x 4 chosen experts x 22 MoE layers, in each
    phase), and every prefill call must replay its graph."""
    dev = torch.device("cuda")
    cfg = tt.Lfm2MoeConfig()
    t0 = time.perf_counter()
    model = tt.Lfm2MoeForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    model.init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    lanes, new = 32, 64
    eng = tt.ContinuousBatchEngine(
        model, num_blocks=lanes * 37, block_size=16, max_batch=lanes,
        max_blocks_per_seq=37, max_new_tokens=new, eos_token_id=-1,
        decode_horizon=8, prefill_group=4, radix_cache=False, device=dev)
    t1 = time.perf_counter()
    eng.horizon_graph()
    eng.prefill_graphs()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t1
    m0 = eng.metrics()
    phase(f"engine ready (LFM2-8B-A1B bf16): {n_params} params, weights "
          f"{m0['weight_bytes']} bytes, pool {m0['pool_bytes']} bytes, "
          f"decode step and prefill buckets captured in {capture_s:.2f} s "
          f"({time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(100, 501)
                            ).tolist() for _ in range(48)]
    c0 = dict(eng.counters)
    zero_launches(kernels)
    outs, wall = serve_waves(torch, eng, (prompts,))
    launches = kernel_launches(kernels)
    c = {key: eng.counters[key] - c0[key] for key in c0}
    routed = cfg.num_experts_per_tok * (cfg.num_hidden_layers
                                        - cfg.num_dense_layers)
    check(len(outs) == 48, f"{len(outs)} of 48 requests returned")
    check(all(len(t) == new for t in outs.values()),
          f"a request != {new} tokens")
    check(all(0 <= x < cfg.vocab_size for t in outs.values() for x in t),
          "token outside the vocab")
    check(all(n > 0 for n in launches.values()),
          f"a kernel never ran on the main path: {launches}")
    check(c["prefill_graph_calls"] == c["prefill_calls"] > 0,
          f"a prefill call ran eagerly: {c['prefill_graph_calls']} of "
          f"{c['prefill_calls']} replayed")
    check(c["chained_ticks"] > 0, "no decode tick was chained")
    check(c["moe_rows_prefill"] == sum(map(len, prompts)) * routed,
          f"prefill rows {c['moe_rows_prefill']}")
    check(c["moe_rows_decode"] == 48 * (new - 1) * routed,
          f"decode rows {c['moe_rows_decode']}")
    check(0 < c["moe_expert_visits_decode"] <= c["moe_rows_decode"],
          "decode visits")
    tokens = sum(len(t) for t in outs.values())
    res = {"launches": launches, "tok_s": tokens / wall,
           "capture_s": capture_s,
           "rows_per_visit_decode": c["moe_rows_decode"]
           / c["moe_expert_visits_decode"],
           **{key: c[key] for key in (
               "prefill_calls", "decode_ticks", "chained_ticks",
               "moe_rows_decode", "moe_rows_prefill",
               "moe_expert_visits_decode", "moe_expert_visits_prefill")}}
    phase(f"serving LFM2-8B-A1B bf16 (pipelined): {tokens} tokens in "
          f"{wall:.3f} s = {res['tok_s']:.1f} tok/s, prefill calls "
          f"{c['prefill_calls']} (all graph replays), decode ticks "
          f"{c['decode_ticks']} (chained {c['chained_ticks']}), MoE rows "
          f"decode {c['moe_rows_decode']} prefill {c['moe_rows_prefill']}, "
          f"{res['rows_per_visit_decode']:.2f} rows an expert visit in "
          f"decode; launches {launches} [{card}]")
    del eng, model
    torch.cuda.empty_cache()
    return res


# K13's kernels: the decode pair and the prefill kernel
K13_KERNELS = ("k13_decode_split_kernel", "k13_decode_combine_kernel",
               "k13_prefill_kernel")


def k13_kernels(so: Path) -> dict:
    """HMMA instructions, registers, shared memory and stack bytes of each
    of K13's kernels in the built library (``cuobjdump -sass`` and
    ``-res-usage``): {"k13_prefill_kernel": (hmma, regs, smem, stack),
    ...}; the shared memory is the dynamic part's (ptxas reports 0)."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"

    def dump(flag):
        return subprocess.run([str(tool), flag, str(so)], capture_output=True,
                              text=True, check=True, timeout=300).stdout

    pat = re.compile("(" + "|".join(K13_KERNELS) + ")")
    found, name = {}, None
    for line in dump("-sass").splitlines():
        if "Function :" in line:
            m = pat.search(line)
            name = m.group(1) if m else None
            if name:
                found[name] = [0, None, None, None]
        elif name and "HMMA" in line:
            found[name][0] += 1
    name = None
    for line in dump("-res-usage").splitlines():
        if "Function" in line:
            m = pat.search(line)
            name = m.group(1) if m else None
        elif name in found:
            vals = [re.search(rf"{k}:(\d+)", line)
                    for k in ("REG", "SHARED", "STACK")]
            if all(vals):
                found[name][1:] = [int(v.group(1)) for v in vals]
                name = None
    return {k: tuple(v) for k, v in sorted(found.items())}


def k13_rounding(torch, k13, q, pool, tables, ok, scale):
    """Where K13 may differ from its plain version, ``[B, M, C]`` for ``q
    [B, M, W]`` against the rows of ``tables`` under ``ok [B, M, K]``: the
    kernels round each probability to bf16 before the weighted sum (at
    most 2^-8 of itself), which moves an output by at most 2^-8 of sum(p
    |c_kv|) / sum(p), computed here in fp32 from the same operands; the
    caller adds the output's own rounding and the order of the sums."""
    rows = k13._rows(pool, tables, tables.shape[1] * pool.shape[1])
    s = torch.einsum("bmw,bkw->bmk", q.float(), rows.float()) * scale
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True).clamp_min(-1e30))
    del s
    l = p.sum(-1, keepdim=True)
    mag = torch.einsum("bmk,bkc->bmc", p, rows[..., :k13.RANK].float().abs())
    return 2.0 ** -8 * mag / torch.where(l == 0, 1.0, l)


def k13_case(torch, k13, name, kernel, plain, rounding, flops, moved,
             flush, card):
    """Run one K13 case: the kernel against its plain version within
    ``rounding`` + 2^-8 of the output (its bf16 rounding) + 1e-4 (the order
    of the fp32 sums) at every element, five calls bit-identical, then its
    time beside the plain version's and its bound."""
    got = kernel()
    want = plain()
    err = (got.float() - want.float()).abs()
    tol = rounding + 2.0 ** -8 * want.float().abs() + 1e-4
    check(bool((err <= tol).all()), f"K13 {name}: error {float(err.max())} "
          f"over the bound at {int((err > tol).sum())} elements")
    check(all(torch.equal(kernel(), got) for _ in range(5)),
          f"K13 {name}: calls differ")
    rec = bound(flops, moved, torch.bfloat16)
    rec.update(max_err=float(err.max()), max_bound=float(tol.max()),
               max_out=float(want.float().abs().max()),
               ms=cuda_ms(kernel, flush),
               plain_ms=cuda_ms(plain, flush, iters=5))
    phase(f"K13 {name}: max error {rec['max_err']:.3e} within the bound "
          f"(outputs to {rec['max_out']:.3f}); {rec['ms']:.4f} ms, "
          f"{achieved(flops, rec['ms'], rec)}; plain {rec['plain_ms']:.4f} "
          f"ms; bound {rec['bound_ms']:.4f} ms [{card}]")
    return rec


def phase_k13(torch, k13, flush, card):
    """K13 at Moonlight-16B-A3B's widths (16 heads, 512 + 64 latent rows,
    bf16; 16-row blocks, tables of 513), each kernel against its plain
    version on the same card tensors (``k13_case``):

    - a decode step of 128 lanes over 32 cached documents of 4,096-7,168
      rows, four lanes a document (the blocks shared in their tables), and
      each lane's own 64-400 rows after it; the bound counts every lane's
      rows, as the kernel reads them (``distinct_bound_ms``: each shared
      row once);
    - prefill calls of 4 rows x 128, 512 and 32 tokens, each row over its
      own 5,900 cached rows and its suffix, causal with the offset.

    Returns ``{"decode": record, "prefill": [record a bucket]}``."""
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(13)
    rng = torch.Generator().manual_seed(13)
    heads, width, rank, bs, maxb = k13.HEADS, k13.WIDTH, k13.RANK, 16, 513
    scale = 192 ** -0.5
    lanes, docs = 128, 32
    doc_len = torch.randint(4096, 7169, (docs,), generator=rng).tolist()
    tails = torch.randint(64, 401, (lanes,), generator=rng).tolist()
    nb, doc_blocks = 0, []
    for n in doc_len:
        doc_blocks.append(list(range(nb, nb + n // bs)))
        nb += n // bs
    tables = torch.full((lanes, maxb), -1, dtype=torch.int32)
    lens = []
    for i in range(lanes):
        d = i % docs
        own = -(-(doc_len[d] + tails[i]) // bs) - len(doc_blocks[d])
        row = doc_blocks[d] + list(range(nb, nb + own))
        nb += own
        tables[i, :len(row)] = torch.tensor(row, dtype=torch.int32)
        lens.append(doc_len[d] + tails[i])
    pool = torch.randn(nb, bs, width, generator=g, device=dev).to(bf16)
    tables = tables.to(dev)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn(lanes, heads, width, generator=g, device=dev).to(bf16)
    live = sum(lens)
    distinct = sum(len(b) * bs for b in doc_blocks) + sum(
        n - len(doc_blocks[i % docs]) * bs for i, n in enumerate(lens))
    ok = (torch.arange(maxb * bs, device=dev)[None] < seq_lens[:, None].long()
          )[:, None].expand(lanes, heads, -1)
    fixed = nbytes(q) + lanes * heads * rank * 2
    rec = k13_case(
        torch, k13, f"decode {lanes} lanes ({live} rows, {distinct} "
        f"distinct)",
        lambda: k13.mla_decode(q, pool, tables, seq_lens, rank, scale),
        lambda: k13.mla_decode_ref(q, pool, tables, seq_lens, rank, scale),
        k13_rounding(torch, k13, q, pool, tables, ok, scale),
        2.0 * heads * (width + rank) * live,
        live * width * 2 + fixed + 4.0 * live / bs, flush, card)
    chunk, splits = k13.decode_plan(lanes, maxb, bs)
    rec.update(lanes=lanes, rows=live, distinct_rows=distinct, chunk=chunk,
               splits=splits, distinct_bound_ms=(
                   distinct * width * 2 + fixed + 4.0 * distinct / bs)
               / HBM_BYTES_PER_S * 1e3)
    recs = {"decode": rec, "prefill": []}
    del ok, q
    cached = 5900
    for t in (128, 512, 32):
        q = torch.randn(4, t, heads, width, generator=g, device=dev).to(bf16)
        tab = torch.randperm(nb, generator=rng)[:4 * maxb].view(4, maxb).to(
            dev, torch.int32)
        pos = cached + torch.arange(t, device=dev)[None].expand(4, t)
        pos = pos.contiguous()
        ctx = torch.full((4,), cached + t, device=dev)
        true_len = torch.full((4,), t, device=dev)
        j = torch.arange(maxb * bs, device=dev)
        ok = (j[None, None] <= pos[..., None])[:, :, None].expand(
            4, t, heads, -1).reshape(4, t * heads, -1)
        pairs = heads * int((pos + 1).sum())   # pos holds the 4 rows
        rows = 4 * (cached + t)
        r = k13_case(
            torch, k13, f"prefill 4 x {t} over {cached} cached",
            lambda: k13.mla_prefill(q, pool, tab, pos, ctx, true_len, rank,
                                    scale),
            lambda: k13.mla_prefill_ref(q, pool, tab, pos, ctx, true_len,
                                        rank, scale),
            k13_rounding(torch, k13, q.view(4, t * heads, width), pool, tab,
                         ok, scale).view(4, t, heads, rank),
            2.0 * (width + rank) * pairs,
            rows * width * 2 + nbytes(q) + 4 * t * heads * rank * 2
            + 4.0 * rows / bs, flush, card)
        r.update(tokens=t, cached=cached, pairs=pairs)
        recs["prefill"].append(r)
        del q, ok
    del pool
    torch.cuda.empty_cache()
    return recs


def phase_moonlight_serving(torch, np, tt, kernels, card):
    """Moonlight-16B-A3B at its published widths (``DeepseekV3Config()``,
    random bf16 weights from a seeded generator) through the engine with
    the radix cache and both captured graphs: 4 documents of 1,000-1,500
    tokens asked once, then 44 more questions of 20-80 tokens about them
    (prefix hits), on 32 lanes, so that lanes are refilled, 32 new tokens
    each. The kernels' launch counts are zeroed just before and read just
    after; every prefill call must replay its graph, the latent-row
    counters must count each decode step's rows exactly (a request of P
    prompt tokens reads P + k rows at its k-th step) and fewer distinct
    ones (lanes share documents), and the time the tick spends counting
    them (``_count_latent_rows``) is taken beside the tick's host time."""
    dev = torch.device("cuda")
    cfg = tt.DeepseekV3Config()
    t0 = time.perf_counter()
    model = tt.DeepseekV3ForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    model.init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    lanes, new, per_seq = 32, 32, 104
    eng = tt.ContinuousBatchEngine(
        model, num_blocks=lanes * per_seq + 400, block_size=16,
        max_batch=lanes, max_blocks_per_seq=per_seq, max_new_tokens=new,
        eos_token_id=-1, decode_horizon=8, prefill_group=4, device=dev)
    t1 = time.perf_counter()
    eng.horizon_graph()
    eng.prefill_graphs()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t1
    m0 = eng.metrics()
    phase(f"engine ready (Moonlight-16B-A3B bf16): {n_params} params, "
          f"weights {m0['weight_bytes']} bytes, latent pool "
          f"{m0['pool_bytes']} bytes, decode step and prefill buckets "
          f"captured in {capture_s:.2f} s ({time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(24)
    vocab = cfg.vocab_size
    docs = [rng.integers(0, vocab, rng.integers(1000, 1501)).tolist()
            for _ in range(4)]
    wave1 = [d + rng.integers(0, vocab, rng.integers(20, 81)).tolist()
             for d in docs]
    wave2 = [docs[i % 4] + rng.integers(0, vocab, rng.integers(
        20, 81)).tolist() for i in range(44)]
    counting = [0]
    count = eng._count_latent_rows

    def timed(grants, n):
        t = time.perf_counter_ns()
        count(grants, n)
        counting[0] += time.perf_counter_ns() - t
    eng._count_latent_rows = timed
    c0 = dict(eng.counters)
    zero_launches(kernels)
    outs, wall = serve_waves(torch, eng, (wave1, wave2))
    launches = kernel_launches(kernels)
    c = {key: eng.counters[key] - c0[key] for key in c0}
    prompts = wave1 + wave2
    check(len(outs) == 48, f"{len(outs)} of 48 requests returned")
    check(all(len(t) == new for t in outs.values()),
          f"a request != {new} tokens")
    check(all(0 <= x < vocab for t in outs.values() for x in t),
          "token outside the vocab")
    check(all(n > 0 for n in launches.values()),
          f"a kernel never ran on the main path: {launches}")
    check(c["prefill_graph_calls"] == c["prefill_calls"] > 0,
          f"a prefill call ran eagerly: {c['prefill_graph_calls']} of "
          f"{c['prefill_calls']} replayed")
    check(c["cached_prompt_tokens"] > 0, "no question hit a cached document")
    want = sum((new - 1) * len(p) + (new - 1) * new // 2 for p in prompts)
    check(c["mla_rows_decode"] == want,
          f"decode latent rows {c['mla_rows_decode']}, not {want}")
    check(0 < c["mla_distinct_rows_decode"] < c["mla_rows_decode"],
          f"distinct decode rows {c['mla_distinct_rows_decode']}")
    check(c["mla_pairs_prefill"] > 0 and c["mla_rows_prefill"] > 0,
          "prefill latent counters")
    check(eng.kv.shared_rows == 0, "a finished lane still holds its blocks")
    tokens = sum(len(t) for t in outs.values())
    ticks = c["decode_ticks"]
    res = {"launches": launches, "tok_s": tokens / wall,
           "capture_s": capture_s, "n_params": n_params,
           "lanes_per_row": c["mla_rows_decode"]
           / c["mla_distinct_rows_decode"],
           "tick_host_ms": c["tick_host_ns"] / ticks / 1e6,
           "count_rows_ms": counting[0] / ticks / 1e6,
           **{key: c[key] for key in (
               "prefill_calls", "decode_ticks", "chained_ticks",
               "cached_prompt_tokens", "mla_rows_decode",
               "mla_distinct_rows_decode", "mla_pairs_prefill",
               "mla_rows_prefill", "moe_rows_decode")}}
    phase(f"serving Moonlight-16B-A3B bf16 (pipelined): {tokens} tokens in "
          f"{wall:.3f} s = {res['tok_s']:.1f} tok/s, prefill calls "
          f"{c['prefill_calls']} (all graph replays), cached prompt tokens "
          f"{c['cached_prompt_tokens']}, decode ticks {ticks} (chained "
          f"{c['chained_ticks']}), latent rows decode "
          f"{c['mla_rows_decode']} ({res['lanes_per_row']:.2f} lanes a "
          f"row), tick host {res['tick_host_ms']:.4f} ms of which counting "
          f"latent rows {res['count_rows_ms']:.4f} ms; launches {launches} "
          f"[{card}]")
    del eng, model
    torch.cuda.empty_cache()
    return res


def phase_graph_numerics(torch, np, tt, pm, tol=2e-3):
    """Phase 6's 2-layer fp32 model and 520-token prompt, prefilled on the
    card and on the CPU, then one 8-step greedy decode tick from the same
    first token three ways: the graph tick (``HorizonGraph``) and the eager
    ``decode_horizon`` on the card, and the eager one on the CPU. Graph vs
    eager: identical tokens and last-step logits within 1e-5; graph vs
    CPU: identical tokens and logits within phase 6's ``tol``."""
    import copy
    cfg = tt.QwenConfig(num_hidden_layers=2)
    cpu = tt.ModelForCausalLM(cfg, device="cpu", dtype=torch.float32)
    cpu.init(torch.Generator().manual_seed(3)).requires_grad_(False)
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(5)
    t, bs, maxb, steps = 520, 16, 64, 8
    prompt = rng.integers(0, cfg.vocab_size, t)
    table = np.arange(maxb, dtype=np.int32)[None]
    pos = np.arange(t)
    pre = [prompt[None], pos[None], (table[0][pos // bs])[None].astype(
        np.int32), (pos % bs)[None], table, np.array([t]), np.array([t])]
    pools, first = {}, None
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        pools[dev] = pm.init_pool(cfg, maxb, bs, dtype=torch.float32,
                                  device=dev)
        logits = pm.prefill(model, pools[dev], *[
            torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in pre])
        if first is None:
            first = int(logits.argmax(-1)[0])

    def tick(dev):
        return (torch.tensor([first], dtype=torch.int32, device=dev),
                torch.tensor([t], device=dev),
                torch.from_numpy(table).to(dev),
                torch.ones(1, dtype=torch.bool, device=dev),
                torch.tensor([steps], dtype=torch.int32, device=dev))

    toks, p, tab, live, budget = tick("cpu")
    ref = pm.decode_horizon(cpu, pools["cpu"], toks, p, tab, live, steps,
                            budget=budget, return_logits=True)
    toks, p, tab, live, budget = tick("cuda")
    eager = pm.decode_horizon(gpu, clone_pool(pools["cuda"]), toks, p, tab,
                              live, steps, budget=budget, return_logits=True)
    graph = pm.HorizonGraph(gpu, pools["cuda"], 1, maxb, steps)
    graph.start(p, tab, live, budget, tokens=toks)
    out = list(graph.run(steps)) + [graph.logits]
    torch.cuda.synchronize()
    out = [x.cpu() for x in out]
    eager = [x.cpu() for x in eager]
    check(all(torch.equal(a, b) for a, b in zip(out[:3], eager[:3])),
          f"graph vs eager tick tokens: {out[0]} vs {eager[0]}")
    check(all(torch.equal(a, b) for a, b in zip(out[:3], ref[:3])),
          f"graph tick vs CPU tokens: {out[0]} vs {ref[0]}")
    err_e = float((out[3] - eager[3]).abs().max())
    err_c = float((out[3] - ref[3]).abs().max())
    check(err_e <= 1e-5, f"graph vs eager last-step logits {err_e} > 1e-5")
    check(err_c <= tol, f"graph vs CPU last-step logits {err_c} > {tol}")
    phase(f"graph numerics 2L fp32 prefill(520) + one {steps}-step tick: "
          f"tokens {out[0][0].tolist()} identical graph / eager / CPU; "
          f"last-step max |dlogit| graph vs eager {err_e} (tol 1e-5), "
          f"graph vs CPU {err_c} (tol {tol})")


def phase_numerics(torch, np, tt, pm, label="fp32", quant=None,
                   pool_dtype=None, tol=2e-3, kernels=()):
    """2 layers, fp32: card vs CPU on a 520-token prompt, 8 decode steps
    teacher-forced along the CPU's greedy tokens. With ``quant`` the model
    is quantized on the CPU and the same modules are copied to the card;
    ``kernels`` must each launch on the card."""
    import copy
    cfg = tt.QwenConfig(num_hidden_layers=2)
    cpu = tt.ModelForCausalLM(cfg, device="cpu", dtype=torch.float32)
    cpu.init(torch.Generator().manual_seed(3)).requires_grad_(False)
    if quant is not None:
        tt.quantize_model(cpu, **quant)
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(5)
    t, bs, maxb = 520, 16, 64
    prompt = rng.integers(0, cfg.vocab_size, t)
    table = np.arange(maxb, dtype=np.int32)[None]
    pos = np.arange(t)
    pre = [prompt[None], pos[None], (table[0][pos // bs])[None],
           (pos % bs)[None], table, np.array([t]), np.array([t])]
    logits, pools = {}, {}
    zero_launches(kernels)
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        pool = pools[dev] = pm.init_pool(
            cfg, maxb, bs, dtype=pool_dtype or torch.float32, device=dev)
        arrays = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in pre]
        arrays[2] = arrays[2].int()
        arrays[4] = arrays[4].int()
        steps = [pm.prefill(model, pool, *arrays)]
        for i in range(8):
            p = t + i
            tok = (int(steps[-1].argmax(-1)[0]) if dev == "cpu"
                   else cpu_tokens[i])
            args = [np.array([tok]), np.array([p]), table,
                    np.array([p + 1], np.int32),
                    np.array([table[0, p // bs]], np.int32),
                    np.array([p % bs])]
            steps.append(pm.decode(model, pool, *[
                torch.from_numpy(a).to(dev) for a in args]))
        logits[dev] = [s.float().cpu() for s in steps]
        if dev == "cpu":
            cpu_tokens = [int(s.argmax(-1)[0]) for s in steps[:-1]]
    launches = kernel_launches(kernels)
    check(all(launches[fn.__name__] > 0 for fn in kernels),
          f"numerics {label}: a kernel never ran on the card: {launches}")
    check(all(n == 0 for name, n in launches.items()
              if name.endswith("_kernel_tc")),
          f"numerics {label}: fp32 took a bf16 tensor-core kernel: "
          f"{launches}")
    errs = [float((a - b).abs().max())
            for a, b in zip(logits["cpu"], logits["cuda"])]
    flips = ""
    if pool_dtype is not None:   # quantized pools: entries rounded apart
        kv_cpu, kv_gpu = (pm.pool_parts(pools[d])[0].cpu()
                          for d in ("cpu", "cuda"))
        flips = (f"; pool bytes differing card vs CPU "
                 f"{int((kv_cpu != kv_gpu).sum())} of {kv_cpu.numel()}")
    check(max(errs) <= tol, f"card vs CPU logits ({label}): max err "
          f"{max(errs)} > {tol}")
    phase(f"numerics 2L {label} prefill(520)+8 decode: per-step max "
          f"|dlogit| {errs} (tol {tol}){flips}; launches {launches}")
    return launches


def phase_w8a8_linears(torch, np, tt, qm, pm):
    """Every W8A8 linear of the 2-layer fp32 model (phase 16's), on the
    inputs it saw in a CPU prefill of 520 tokens: card (``torch._int_mm``)
    against CPU. The int32 sum is exact on both and the epilogue the same
    fp32 ops; what may differ is an activation code that the two devices'
    division rounds to either side of .5. So each output is held to 1e-6 of
    the largest, plus, per flipped code of its row, the most one code can
    move it: the row's scale times the largest dequantized weight."""
    import copy
    cfg = tt.QwenConfig(num_hidden_layers=2)
    cpu = tt.ModelForCausalLM(cfg, device="cpu", dtype=torch.float32)
    cpu.init(torch.Generator().manual_seed(3)).requires_grad_(False)
    tt.quantize_model(cpu, bits=8, act_bits=8)
    gpu = copy.deepcopy(cpu).to("cuda")
    seen = {}
    hooks = [mod.register_forward_pre_hook(
        lambda m, args, name=name: None if name in seen
        else seen.__setitem__(name, args[0]))
        for name, mod in cpu.named_modules()
        if getattr(mod, "act_q", False)]
    t, bs, maxb = 520, 16, 64
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, t))[None]
    pos = torch.arange(t)[None]
    table = torch.arange(maxb, dtype=torch.int32)[None]
    pm.prefill(cpu, pm.init_pool(cfg, maxb, bs, dtype=torch.float32,
                                 device="cpu"),
               ids, pos, table[0][pos // bs].int(), pos % bs, table,
               torch.tensor([t]), torch.tensor([t]))
    for h in hooks:
        h.remove()
    check(len(seen) == 14, f"{len(seen)} W8A8 linears ran, not 14")
    worst, flipped = 0.0, 0
    for name, x in seen.items():
        mod = cpu.get_submodule(name)
        want = mod(x)
        got = gpu.get_submodule(name)(x.cuda()).cpu()
        q_cpu, xs = qm.quantize_activation(x)
        flips = (q_cpu != qm.quantize_activation(x.cuda())[0].cpu()).sum(
            dim=-1, keepdim=True)
        flipped += int(flips.sum())
        w_max = float((mod.weight_q.float().abs()
                       * mod.scale[:, None]).max())
        top = float(want.abs().max())
        bound = flips * xs * w_max + 1e-6 * top
        check(bool(torch.all((got - want).abs() <= bound)),
              f"W8A8 {name}: card vs CPU beyond the bound")
        worst = max(worst, float((got - want).abs().max()) / top)
    phase(f"W8A8 linears on identical inputs (14, M={t}): card vs CPU "
          f"within {worst:.3g} of each output's max; {flipped} activation "
          f"codes rounded apart (each bounded as above)")


def phase_training(torch, bench, kernels, card):
    """The JAX ``bench.py`` model and step at full width through
    ``vyomai_tpu_torch.bench``: naive, then fused with the launch counts
    zeroed just before and read just after."""
    naive = bench.train(False, steps=10, warmup=3)
    torch.cuda.empty_cache()
    for fn in kernels:
        fn.launches = 0
    fused = bench.train(True, steps=10, warmup=3)
    launches = {fn.__name__: fn.launches for fn in kernels}
    torch.cuda.empty_cache()
    for name, run in (("naive", naive), ("fused", fused)):
        losses = run["losses"]
        check(all(math.isfinite(x) for x in losses),
              f"training {name}: a loss is not finite: {losses}")
        check(losses[-1] < losses[0],
              f"training {name}: the loss did not fall: {losses}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel never ran on the training path: {launches}")
    check(all(n > 0 for n in fused["launches"].values()),
          f"a kernel never ran in the timed window: {fused['launches']}")
    mfu = (bench.model_flops_per_token(fused["n_params"])
           * fused["tokens_per_s"] / bench.H100_PEAK_BF16)
    phase(f"training bench.py width ({fused['n_params']} params, bf16, "
          f"B={bench.BATCH} S={bench.SEQ}): fused "
          f"{fused['tokens_per_s']:.1f} tok/s, {fused['ms_per_step']:.2f} "
          f"ms/step, peak {fused['peak_bytes']} bytes; naive "
          f"{naive['tokens_per_s']:.1f} tok/s, {naive['ms_per_step']:.2f} "
          f"ms/step, peak {naive['peak_bytes']} bytes; fused/naive "
          f"{fused['tokens_per_s'] / naive['tokens_per_s']:.4f}, MFU "
          f"{mfu:.4f}; fused losses {[round(x, 4) for x in fused['losses']]}"
          f"; launches {launches} (timed window {fused['launches']}) "
          f"[{card}]")
    return launches


GRAD_RTOL_OF_MAX = 1e-4   # fp32 card vs CPU; each side is ~1.5e-6 of the
LOSS_RTOL = 1e-5          # max from fp64 at this size (CPU rehearsal)


def phase_train_numerics(torch, np, tt, bench, dev="cuda"):
    """2 layers at bench width, fp32, B=2, S=256, pad-mask zeros and pad
    token ids: the fused loss and every gradient on the card (K1-K3 on the
    flash route) against the CPU (their plain versions), then one AdamW
    step (lr 1e-4, clip 1.0) and the params."""
    from vyomai_tpu_torch.layers.attention import set_sdpa_impl
    from vyomai_tpu_torch.training import (create_train_state,
                                           make_optimizer, make_train_step)
    cfg = bench.CFG.replace(num_hidden_layers=2)
    rng = np.random.default_rng(7)
    ids = rng.integers(2, cfg.vocab_size, (2, 256))
    ids[0, [3, 100]] = ids[1, 50] = cfg.pad_token_id
    mask = np.ones_like(ids)
    mask[1, 200:] = 0
    lr = 1e-4
    init = bench.build(cfg, device="cpu", dtype=torch.float32).state_dict()
    runs = {}
    set_sdpa_impl("flash")
    try:
        for where in ("cpu", dev):
            model = tt.DecoderModel(cfg, "rope", "gqa", device=where)
            model.load_state_dict(init)
            batch = {"ids": torch.from_numpy(ids).to(where),
                     "mask": torch.from_numpy(mask).to(where)}
            loss, _ = bench.fused_loss(model, batch)
            loss.backward()
            grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
            opt = make_optimizer(lr)
            make_train_step(bench.fused_loss, opt)(
                create_train_state(model, opt), batch)
            # the step recomputed the gradients and clipped them in place:
            # .grad now holds what AdamW read
            runs[where] = (float(loss.detach()), grads,
                           {n: p.grad.cpu()
                            for n, p in model.named_parameters()},
                           {n: p.detach().cpu()
                            for n, p in model.named_parameters()})
    finally:
        set_sdpa_impl("auto")
    (l_cpu, g_cpu, c_cpu, p_cpu) = runs["cpu"]
    (l_gpu, g_gpu, c_gpu, p_gpu) = runs[dev]
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    check(loss_err <= LOSS_RTOL, f"training loss card {l_gpu} vs CPU {l_cpu}")
    grad_err = param_err = 0.0
    for name, want in g_cpu.items():
        top = float(want.abs().max())
        diff = (g_gpu[name] - want).abs()
        err = float(diff.max()) / top if top else float(diff.max())
        check(err <= GRAD_RTOL_OF_MAX, f"grad {name}: {err} of its max")
        grad_err = max(grad_err, err)
        # Adam's first step moves a param by lr * g / (|g| + eps) for the
        # clipped gradient g: two of them, g and g', move it apart by at
        # most lr * min(2, 2|g - g'| / |g|); on top, fp32 rounding of the
        # param (1e-6 of its max)
        seen = c_cpu[name].abs()
        spread = torch.clamp(2 * (c_gpu[name] - c_cpu[name]).abs() / seen,
                             max=2.0).nan_to_num(2.0)
        bound = lr * spread + 1e-6 * float(p_cpu[name].abs().max())
        moved = (p_gpu[name] - p_cpu[name]).abs()
        check(bool(torch.all(moved <= bound)),
              f"param {name} after one AdamW step: {float(moved.max())}")
        param_err = max(param_err, float((moved / bound).max()))
    phase(f"training numerics 2L fp32 B=2 S=256: loss card {l_gpu} vs CPU "
          f"{l_cpu} (rel {loss_err:.3g}, tol {LOSS_RTOL}); max grad err "
          f"{grad_err:.3g} of each tensor's max (tol {GRAD_RTOL_OF_MAX}); "
          f"params after one AdamW step within {param_err:.3g} of the "
          f"bound lr*min(2, 2|dg|/|g|) + 1e-6*max|p|")


def phase_short(torch, sa, fa, flush, card):
    """K5/K6/K7 against their plain versions at the ViT shapes (packed
    [128, 197, 2304] and [32, 197, 2304], bf16), the MLM shapes (B=64 L=128
    and B=16 L=512, H=12, D=64, bf16 key-pad bias, batch row 0 with every
    key padded) and the edges (odd H, D=32 and 128, L=8, 300 and 512, bf16
    and fp32);
    each beside SDPA (forward, and its backward through autograd) and K1
    at the same unpacked shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    bf, f32 = torch.bfloat16, torch.float32
    neg = float(torch.finfo(torch.float32).min)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [  # (label, b, h, l, d, dtype, key-pad bias?, packed?)
        ("ViT fwd B=128 packed", 128, 12, 197, 64, bf, False, True),
        ("ViT train B=32 packed", 32, 12, 197, 64, bf, False, True),
        ("MLM S=128 B=64", 64, 12, 128, 64, bf, True, False),
        ("MLM S=512 B=16", 16, 12, 512, 64, bf, True, False),
        ("odd H=5 D=32 L=8", 4, 5, 8, 32, f32, True, False),
        ("odd H=5 D=32 L=8", 4, 5, 8, 32, bf, True, False),
        ("odd H=3 D=32 L=300", 8, 3, 300, 32, bf, True, False),
        ("D=128 L=512", 2, 4, 512, 128, f32, True, False),
        ("D=128 L=512", 2, 4, 512, 128, bf, True, False),
        ("odd H=3 D=128 L=100 packed", 3, 3, 100, 128, bf, False, True),
    ]
    found = {}
    for label, b, h, l, d, dtype, pad, packed in cases:
        if packed:
            qkv = torch.randn(b, l, 3 * h * d, device=dev,
                              generator=g).to(dtype)
            q, k, v = sa._unpack(qkv, h)
            fwd = lambda: sa.short_attention_qkv_fwd(qkv, h)  # noqa: E731
            ref_fwd = lambda: sa.short_attention_qkv_ref(qkv, h)  # noqa
        else:
            q, k, v = (torch.randn(b, h, l, d, device=dev, generator=g)
                       .to(dtype) for _ in range(3))
        do = torch.randn(b, h, l, d, device=dev, generator=g).to(dtype)
        bias = None
        if pad:
            lens = torch.randint(l // 2, l + 1, (b,), device=dev, generator=g)
            lens[0] = 0                   # every key of row 0 padded
            bias = torch.where(torch.arange(l, device=dev)[None]
                               < lens[:, None], 0.0, neg)[:, None, None]
        if not packed:
            fwd = lambda: sa.short_attention_fwd(q, k, v, bias)  # noqa
            ref_fwd = lambda: sa.short_attention_fwd_ref(  # noqa: E731
                q, k, v, bias)
        out, stats = fwd()
        torch.cuda.synchronize()
        ref, _ = ref_fwd()
        err = float((out.float() - ref.float()).abs().max())
        atol = FP32_ATOL if dtype == f32 else attn_bf16_atol(ref, v)
        check(err <= atol, f"K5/K6 {label} {dtype}: max err {err} > {atol}")
        out4 = out.view(b, l, h, d).transpose(1, 2) if packed else out
        if pad:   # a row whose keys are all padded: the mean of V
            mean_v = v[0].float().mean(dim=1, keepdim=True)
            m_err = float((out4[0].float() - mean_v).abs().max())
            check(m_err <= atol, f"K5 {label}: padded row vs mean of V "
                  f"{m_err} > {atol}")
        delta = sa._delta(out4, do)
        grads = sa._unpack(torch.empty_like(qkv), h) if packed else None
        got = sa.short_attention_bwd(q, k, v, bias, do, stats, delta,
                                     grads=grads)
        torch.cuda.synchronize()
        want = sa.short_attention_bwd_ref(q, k, v, bias, do, stats, delta)
        rounding = (k7_rounding(torch, q, k, v, bias, do, stats, delta)
                    if dtype == bf else {})
        g_err, g_txt = 0.0, []
        for name, x, w in zip(("dq", "dk", "dv"), got, want):
            e = float((x.float() - w.float()).abs().max())
            check(bool(torch.isfinite(x).all()), f"K7 {label}: {name} not "
                  "finite")
            a = grad_atol(w, dtype == bf, rounding.get(name, 0.0))
            check(e <= a, f"K7 {label}: {name} max err {e} > {a}")
            g_err = max(g_err, e)
            g_txt.append(f"{name} {e:.3g} (atol {a:.3g})")
        mask = None if bias is None else bias.to(dtype)
        t = {"fwd": cuda_ms(fwd, flush, 10),
             "fwd plain": cuda_ms(ref_fwd, flush, 10),
             "fwd SDPA": cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask),
                                 flush, 10),
             "bwd": cuda_ms(lambda: sa.short_attention_bwd(
                 q, k, v, bias, do, stats, delta, grads=grads), flush, 10),
             "bwd plain": cuda_ms(lambda: sa.short_attention_bwd_ref(
                 q, k, v, bias, do, stats, delta), flush, 10)}
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        lib_out = sdpa(*leaves, attn_mask=mask)
        t["bwd SDPA"] = cuda_ms(lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True), flush, 10)
        if d in (64, 128):   # K1 on the same operands, contiguous
            qc, kc, vc = (x.contiguous() for x in (q, k, v))
            t["K1 fwd"] = cuda_ms(lambda: fa.flash_attention_fwd(
                qc, kc, vc, bias), flush, 10)
        pairs = live_pairs(torch, bias, b, h, l, l)
        fwd_rec = dict(max_abs_err=err, ms=t["fwd"], plain_ms=t["fwd plain"],
                       library_ms=t["fwd SDPA"], **bound(
                           4 * d * pairs, nbytes(q, k, v, bias, out, stats),
                           dtype))
        rate = achieved(4 * d * pairs, t["fwd"], fwd_rec)
        bwd_rec = dict(max_abs_err=g_err, ms=t["bwd"],
                       plain_ms=t["bwd plain"], library_ms=t["bwd SDPA"],
                       **bound(10 * d * pairs, nbytes(
                           q, k, v, do, stats, delta, bias, *got), dtype))
        issued = k7_issued_flops(b, h, l, d, dtype == bf)
        phase(f"K5/K6/K7 short {label} H={h} L={l} D={d} {str(dtype)[6:]}: "
              f"fwd max_abs_err={err:.3g} (atol {atol:.3g}), bwd "
              + ", ".join(g_txt) + "; "
              + ", ".join(f"{n} {ms:.4f} ms" for n, ms in t.items())
              + f"; fwd {rate}; bwd {issued / t['bwd'] / 1e9:.1f} TFLOP/s "
              f"issued ({issued} FLOP), {10 * d * pairs / t['bwd'] / 1e9:.1f} "
              f"on live pairs, {bwd_rec['bound_ms'] / t['bwd']:.3f} of the "
              f"bound"
              + f"; bounds fwd {fwd_rec['bound_ms']:.4f} ms "
              f"({fwd_rec['bound_by']}), bwd {bwd_rec['bound_ms']:.4f} ms "
              f"({bwd_rec['bound_by']}) [{card}]")
        found[label] = (fwd_rec, bwd_rec)
        del q, k, v, do, out, stats, ref, got, want, leaves, lib_out
    torch.cuda.empty_cache()
    return {"K5": found["MLM S=128 B=64"][0],
            "K6": found["ViT fwd B=128 packed"][0],
            "K7": found["ViT train B=32 packed"][1]}


def _losses_fall(name: str, losses):
    check(all(math.isfinite(x) for x in losses),
          f"{name}: a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"{name}: the loss did not fall: {losses}")


def phase_vit(torch, eb, kernels, card):
    """ViT-base/16 at 12 layers, bf16: forward img/s at B=128, then 3
    warm-up and 10 timed train steps at B=32, on the "auto" and "xla"
    routes (``encoder_bench.bench_vit``)."""
    for fn in kernels:
        fn.launches = 0
    rec = eb.bench_vit(steps=10, warmup=3)
    launches = {fn.__name__: fn.launches for fn in kernels}
    torch.cuda.empty_cache()
    timed = rec["short"]["launches"]
    check(timed["short_attention_qkv_fwd"] > 0
          and timed["short_attention_bwd"] > 0,
          f"K6/K7 never ran in ViT's timed window: {timed}")
    for route in ("short", "xla"):
        _losses_fall(f"ViT {route}", rec[route]["losses"])
    phase(f"ViT-base/16 bf16: fwd B={rec['batch']} "
          f"{rec['short']['fwd_img_s']:.1f} img/s (xla "
          f"{rec['xla']['fwd_img_s']:.1f}), train B={rec['train_batch']} "
          f"{rec['short']['train_img_s']:.1f} img/s, "
          f"{rec['short']['step_ms']:.2f} ms/step, peak "
          f"{rec['short']['peak_bytes']} bytes (xla "
          f"{rec['xla']['train_img_s']:.1f} img/s, "
          f"{rec['xla']['step_ms']:.2f} ms, peak {rec['xla']['peak_bytes']}"
          f"); losses {[round(x, 4) for x in rec['short']['losses']]}; "
          f"launches {launches} (timed window {timed}) [{card}]")
    return launches


def phase_mlm(torch, eb, kernels, card):
    """RoBERTa-base MLM at 12 layers, bf16, right-padded: S=128 B=64 and
    S=512 B=16 on the "auto" and "xla" routes
    (``encoder_bench.bench_mlm``)."""
    for fn in kernels:
        fn.launches = 0
    recs = [eb.bench_mlm(seq, b, steps=10, warmup=3)
            for seq, b in eb.MLM_SHAPES]
    launches = {fn.__name__: fn.launches for fn in kernels}
    torch.cuda.empty_cache()
    for rec in recs:
        timed = rec["short_launches"]
        check(timed["short_attention_fwd"] > 0
              and timed["short_attention_bwd"] > 0,
              f"K5/K7 never ran in MLM S={rec['seq']}'s timed window: "
              f"{timed}")
        for route in ("short", "xla"):
            _losses_fall(f"MLM S={rec['seq']} {route}",
                         rec[f"{route}_losses"])
        phase(f"RoBERTa-base MLM bf16 S={rec['seq']} B={rec['batch']} "
              f"({rec['real_tokens']} real tokens): train "
              f"{rec['short_tokens_per_sec']:.1f} tok/s, "
              f"{rec['short_step_ms']:.2f} ms/step, peak "
              f"{rec['short_peak_bytes']} bytes (xla "
              f"{rec['xla_tokens_per_sec']:.1f} tok/s, "
              f"{rec['xla_step_ms']:.2f} ms, peak {rec['xla_peak_bytes']}); "
              f"fwd {rec['fwd_short_tokens_per_sec']:.1f} tok/s (xla "
              f"{rec['fwd_xla_tokens_per_sec']:.1f}); losses "
              f"{[round(x, 4) for x in rec['short_losses']]}; timed window "
              f"{timed} [{card}]")
    phase(f"MLM launches {launches}")
    return launches


def _grads_close(label, l_cpu, g_cpu, l_dev, g_dev):
    loss_err = abs(l_dev - l_cpu) / abs(l_cpu)
    check(loss_err <= LOSS_RTOL, f"{label} loss card {l_dev} vs CPU {l_cpu}")
    # a tensor's scale is its largest value, floored at 1e-3 of the
    # largest gradient of the model: the key projection's bias gets an
    # exactly-zero gradient (softmax ignores a per-row shift), which both
    # sides leave as fp32 noise of different orders
    floor = 1e-3 * max(float(g.abs().max()) for g in g_cpu.values())
    worst = 0.0
    for name, want in g_cpu.items():
        top = max(float(want.abs().max()), floor)
        diff = float((g_dev[name] - want).abs().max())
        err = diff / top
        check(err <= GRAD_RTOL_OF_MAX, f"{label} grad {name}: {err} of its "
              "max")
        worst = max(worst, err)
    phase(f"{label} numerics: loss card {l_dev} vs CPU {l_cpu} (rel "
          f"{loss_err:.3g}, tol {LOSS_RTOL}); max grad err {worst:.3g} of "
          f"each tensor's max (tol {GRAD_RTOL_OF_MAX})")


def phase_encoder_numerics(torch, np, eb, kernels, dev="cuda"):
    """ViT and RoBERTa MLM at 2 layers, fp32, on the "short" route: the
    loss and every gradient on the card (K5/K6/K7) against the CPU (their
    plain versions)."""
    from vyomai_tpu_torch.layers.attention import set_sdpa_impl
    f32 = torch.float32
    rng = np.random.default_rng(8)
    vcfg = eb.VIT_CFG.replace(num_hidden_layers=2)
    h, w = vcfg.image_size
    vit_batch = {"images": rng.standard_normal((2, 3, h, w), np.float32),
                 "labels": rng.integers(0, 10, 2)}
    mcfg = eb.MLM_CFG.replace(num_hidden_layers=2)
    mlm_batch, _ = eb.mlm_batch(mcfg, 128, 2, device="cpu", seed=9)

    def vit_model(where):
        return eb.VitClassifier(vcfg, 10, device=where, dtype=f32)

    def mlm_model(where):
        from vyomai_tpu_torch import EncoderForMaskedLM
        return EncoderForMaskedLM(mcfg, "absolute", device=where, dtype=f32)

    gen = torch.Generator().manual_seed(10)
    vit_init = vit_model("cpu")
    vit_init.vit.init(gen)
    torch.nn.init.normal_(vit_init.head.weight, 0.0, 0.02, generator=gen)
    torch.nn.init.zeros_(vit_init.head.bias)
    mlm_init = mlm_model("cpu").init(gen)
    cases = (("ViT 2L fp32 B=2", vit_model, vit_init.state_dict(),
              eb.vit_loss, {k: torch.as_tensor(x)
                            for k, x in vit_batch.items()}),
             ("MLM 2L fp32 S=128 B=2", mlm_model, mlm_init.state_dict(),
              eb.mlm_loss, mlm_batch))
    set_sdpa_impl("short")
    try:
        for label, build, init, loss_fn, batch in cases:
            runs = {}
            for where in ("cpu", dev):
                model = build(where)
                model.load_state_dict(init)
                before = sum(fn.launches for fn in kernels)
                loss, _ = loss_fn(model, {k: x.to(where)
                                          for k, x in batch.items()})
                loss.backward()
                if where != "cpu":
                    check(sum(fn.launches for fn in kernels) > before,
                          f"{label}: no short-attention kernel ran")
                runs[where] = (float(loss.detach()),
                               {n: p.grad.cpu()
                                for n, p in model.named_parameters()})
            _grads_close(label, *runs["cpu"], *runs[dev])
    finally:
        set_sdpa_impl("auto")


def qm_atol(ref, dtype) -> float:
    """Quantized matmul kernel vs plain on the same inputs: bf16 as
    ``bf16_atol`` (one ulp of the output after the final cast); fp32 by
    summation order over up to 3,072 fp32 products, 1e-5 of the largest
    output."""
    if str(dtype) == "torch.bfloat16":
        return bf16_atol(ref)
    return 1e-5 * float(ref.float().abs().max()) + 1e-5


# (K, N) of Mistral-7B's linears (q/o, k/v, gate/up, down) and its head
MISTRAL_LINEARS = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
MISTRAL_HEAD = (4096, 32768)
# (K, N) of Qwen3-0.6B's linears: q, k/v, o, gate/up, down
QWEN3_LINEARS = ((1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
                 (3072, 1024))
QWEN3_HEAD = (1024, 151936)
# static-cache generation at full width (phase 17): batch, prompt, new
# tokens, and the decode steps traced for the device time
GEN_B, GEN_PROMPT, GEN_NEW, GEN_TRACE_STEPS = 8, 128, 64, 8


def phase_quant_matmul(torch, qm, qb, flush, card):
    """K8 (kn and nk) at decode M=16 over every Qwen3-0.6B linear shape and
    the tied head, at prefill M=2,048 for 1024->3072, at ragged M (1, 7,
    17, 100) and N (1,000), and bf16 ``nk`` at the served int8 decode
    (M=64 over Mistral-7B's linears and head: the 64-row tiles, split
    along K where they would not fill the SMs); K9 fold and split (kn and
    nk, gs=128) at the linear shapes, fold at the prefill shape and the
    ragged M; bf16 K8 (kn
    and nk) and K9 fold (kn and nk) at phase 17's shapes: its decode step
    (M=``GEN_B``: every linear, and the tied head for K8) and its prefill
    (M=``GEN_B * GEN_PROMPT``: every linear; at k/v, o and down the
    64-row tiles alone would not fill the SMs and split K);
    K10 stream
    and noscale at M=8, K=N=2,048; bf16 and fp32, each against its plain
    version, with the dense bf16 ``torch.matmul`` (and
    ``torch._weight_int8pack_mm`` where it runs) as library times. Each
    case prints its route (``int8_route`` / ``int4_route``: bf16 ``nk``
    on the tensor cores, K9's split mode on the CUDA cores) and, on the
    tensor cores, its tile, splits and grid. Five calls at a split-K shape
    of K8 (16- and 64-row plans) and of K9 must give the same bits and
    leave the tile counters at 0. Then the K10 path: ``quant_bench``'s
    int4 attribution, counts zeroed before and read after."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    bf, f32 = torch.bfloat16, torch.float32
    cases = []   # (kernel, label, m, k, n, dtype, variant)
    for k, n in QWEN3_LINEARS + (QWEN3_HEAD,):
        for dt in (bf, f32):
            cases += [("K8", "decode", 16, k, n, dt, lay)
                      for lay in ("kn", "nk")]
    cases += [("K8", "prefill", 2048, 1024, 3072, dt, lay)
              for dt in (bf, f32) for lay in ("kn", "nk")]
    cases += [("K8", "ragged", m, 1024, 1000, bf, lay)
              for m in (1, 7, 17, 100) for lay in ("kn", "nk")]
    # the served int8 decode: Mistral-7B's linears and head at 64 lanes
    cases += [("K8", "decode-64", 64, k, n, bf, "nk")
              for k, n in MISTRAL_LINEARS + (MISTRAL_HEAD,)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # K9 / K10 variants: (mode, layout)
    for k, n in QWEN3_LINEARS:
        cases += [("K9", "decode", 16, k, n, dt, var) for dt, var in (
            (bf, ("fold", "nk")), (bf, ("split", "nk")), (bf, ("fold", "kn")),
            (f32, ("fold", "nk")), (f32, ("split", "nk")))]
    cases += [("K9", "prefill", 2048, 1024, 3072, dt, var) for dt, var in (
        (bf, ("fold", "nk")), (bf, ("fold", "kn")))]
    cases += [("K9", "ragged", m, 1024, 1000, bf, ("fold", "nk"))
              for m in (1, 7, 17, 100)]
    # phase 17's generation shapes, bf16 as it runs them
    gen_pre = GEN_B * GEN_PROMPT
    for k, n in QWEN3_LINEARS + (QWEN3_HEAD,):
        cases += [("K8", "gen-decode", GEN_B, k, n, bf, lay)
                  for lay in ("kn", "nk")]
        if (k, n) != QWEN3_HEAD:
            cases += [("K9", "gen-decode", GEN_B, k, n, bf, ("fold", lay))
                      for lay in ("kn", "nk")]
    for k, n in QWEN3_LINEARS:
        cases += [("K8", "gen-prefill", gen_pre, k, n, bf, lay)
                  for lay in ("kn", "nk")]
        cases += [("K9", "gen-prefill", gen_pre, k, n, bf, ("fold", lay))
                  for lay in ("kn", "nk")]
    cases += [("K10", "attribution", 8, 2048, 2048, dt, (mode, lay))
              for dt, lay in ((bf, "nk"), (f32, "nk"), (bf, "kn"))
              for mode in ("stream", "noscale")]
    # the cases whose records the kernels' JSON line carries
    main_case = {
        "K8": ("K8", "decode", bf, "nk", QWEN3_HEAD),
        "K8-cuda": ("K8", "decode", bf, "kn", QWEN3_HEAD),
        "K9": ("K9", "decode", bf, ("fold", "nk"), (1024, 3072)),
        # the CUDA-core K9 as phase 16's fp32 numerics run it
        "K9-cuda": ("K9", "decode", f32, ("fold", "nk"), (1024, 3072)),
        "K10": ("K10", "attribution", bf, ("stream", "nk"), (2048, 2048))}
    weights, main, lib_seen = {}, {}, {}
    for kern, label, m, k, n, dt, var in cases:
        if (k, n) not in weights:
            weights.clear()
            w = torch.randn(k, n, device=dev, generator=g) * 0.02
            q, s = qm.quantize_weight(w)
            p, s4 = qm.quantize_weight_int4(w, group_size=128)
            weights[(k, n)] = (q, s, {"kn": p, "nk": p.t().contiguous()},
                               s4)
            del w
        q, s, packed, s4 = weights[(k, n)]
        x = torch.randn(m, k, device=dev, generator=g).to(dt)
        if kern == "K8":
            wq = q if var == "kn" else q.t().contiguous()
            fn = lambda: qm.int8_matmul(x, wq, s, w_layout=var)  # noqa
            ref_fn = lambda: qm.int8_matmul_ref(x, wq, s, var)  # noqa
            wbytes = nbytes(wq, s)
            route, wide = qm.int8_route(x, wq, var), True
            name = var
        else:
            mode, lay = var
            p = packed[lay]
            row = 0 if kern == "K9" else qm.k10_scale_row(k, 128)
            if kern == "K9":
                fn = lambda: qm.int4_matmul(  # noqa: E731
                    x, p, s4, kernel=mode, w_layout=lay)
                wbytes = nbytes(p, s4)
            else:
                fn = lambda: qm.int4_attribution(  # noqa: E731
                    x, p, s4, mode=mode, scale_row=row, w_layout=lay)
                wbytes = nbytes(p) + n * 4
            ref_fn = lambda: qm.int4_matmul_ref(  # noqa: E731
                x, p, s4, mode, row, lay)
            route, wide = qm.int4_route(x, p, lay, mode, 128), mode == "fold"
            name = f"{mode} {lay}"
        if route == "tc":
            bm, bn, splits = qm.int8_tc_plan(m, k, n, sms, wide=wide)
            grid = -(-m // bm) * -(-n // bn) * splits
            route += f" tile {bm}x{bn} splits {splits} grid {grid} CTAs"
        route = f" route {route},"
        out = fn()
        torch.cuda.synchronize()
        ref = ref_fn()
        err = float((out.float() - ref.float()).abs().max())
        atol = qm_atol(ref, dt)
        check(bool(torch.isfinite(out).all()) and err <= atol,
              f"{kern} {name} {label} M={m} K={k} N={n} {dt}: max err {err} "
              f"> {atol}")
        ms = cuda_ms(fn, flush)
        plain_ms = cuda_ms(ref_fn, flush)
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=None, **bound(
                       2 * m * k * n, nbytes(x, out) + wbytes, dt))
        extra = ""
        if dt == bf:
            key = (m, k, n)
            if key not in lib_seen:
                # the dense time a quantized kernel must beat, and PyTorch's
                # own int8 weight-only kernel where it runs here
                w_bf = (q.float() * s).to(bf)
                lib = cuda_ms(lambda: torch.matmul(x, w_bf), flush)
                qt = q.t().contiguous()
                try:
                    pack = cuda_ms(lambda: torch._weight_int8pack_mm(
                        x, qt, s.to(bf)), flush)
                    pack_txt = f"{pack:.4f} ms"
                except (RuntimeError, NotImplementedError) as e:
                    pack_txt = f"none ({type(e).__name__}: {str(e)[:80]})"
                lib_seen[key] = (lib, pack_txt)
                del w_bf, qt
            rec["library_ms"] = lib_seen[key][0]
            extra = (f", bf16 matmul {lib_seen[key][0]:.4f} ms "
                     f"(ratio {ms / lib_seen[key][0]:.3f}), "
                     f"_weight_int8pack_mm {lib_seen[key][1]}")
        phase(f"{kern} {name} {label} M={m} K={k} N={n} {str(dt)[6:]}:"
              f"{route} max_abs_err={err:.3g} (atol {atol:.3g}) kernel "
              f"{ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}){extra} [{card}]")
        for rec_name, want in main_case.items():
            if (kern, label, dt, var, (k, n)) == want:
                main[rec_name] = rec
        del x, out, ref
    weights.clear()
    # determinism of the split-K reduction: same bits, counters back at 0
    stream = torch.cuda.current_stream().cuda_stream
    for kern, m, k, n in (("K8", 16, 3072, 1024), ("K8", 64, 4096, 1024),
                          ("K9", 16, 1024, 3072)):
        x = torch.randn(m, k, device=dev, generator=g).to(bf)
        w = torch.randn(n, k, device=dev, generator=g)
        if kern == "K8":
            q, s = qm.quantize_weight(w, contract_axis=1)
            call = lambda: qm.int8_matmul(x, q, s, w_layout="nk")  # noqa
        else:
            p, s = qm.quantize_weight_int4(w.t(), group_size=128)
            p = p.t().contiguous()
            call = lambda: qm.int4_matmul(x, p, s, w_layout="nk")  # noqa
        splits = qm.int8_tc_plan(m, k, n, sms)[2]
        outs = [call() for _ in range(5)]
        torch.cuda.synchronize()
        same = all(torch.equal(o, outs[0]) for o in outs[1:])
        counters = int(qm._WORKSPACE[(0, stream)][1].abs().sum())
        check(splits > 1 and same and counters == 0,
              f"{kern} split-K M={m} K={k} N={n}: splits {splits}, "
              f"identical bits {same}, counters left {counters}")
        phase(f"{kern} split-K determinism M={m} K={k} N={n} plan "
              f"{qm.int8_tc_plan(m, k, n, sms)}: 5 calls bit-identical, "
              f"tile counters back at 0")
        del x, w, outs
    torch.cuda.empty_cache()
    zero_launches((qm.int4_attribution,))
    att = qb.int4_attribution()
    launches = kernel_launches((qm.int4_attribution,))
    check(launches["int4_attribution_kernel_tc"] > 0,
          f"K10 never ran on the tensor cores on its path: {launches}")
    phase(f"K10 path quant_bench.int4_attribution: {json.dumps(att)}; "
          f"launches {launches} [{card}]")
    return main, launches


def phase_quant_decode(torch, pdm, pa, flush, card):
    """K4's int8 and int4 variants at phase 2's cases (B=16, H=16, H_kv=8,
    BS=16, MAXB=64, D=128 and 64: ragged lengths with a dead lane and -1
    table entries, phase 5's tick, one lane at 1,024 tokens), pools written
    by ``write_kv`` from random rows."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    h, h_kv, bs, maxb = 16, 8, 16, 64
    main = {}
    for kind in ("int8", "int4"):
        for case, lens in K4_LENS.items():
            b = len(lens)
            nb = b * maxb
            for d, dtype in ((128, torch.bfloat16), (128, torch.float32),
                             (64, torch.bfloat16)):
                q = torch.randn(b, h, d, device=dev, generator=g).to(dtype)
                width = h_kv * d // (2 if kind == "int4" else 1)
                pool = torch.zeros(nb, 2, bs, width, dtype=torch.int8,
                                   device=dev)
                sc = torch.ones((nb, 2, h_kv, bs) if kind == "int4"
                                else (nb, 2, bs), device=dev)
                rows = torch.randn(nb * bs, 2, h_kv, d, device=dev,
                                   generator=g)
                pa.write_kv(pool, rows[:, 0], rows[:, 1],
                            torch.arange(nb, device=dev).repeat_interleave(
                                bs),
                            torch.arange(bs, device=dev).repeat(nb),
                            scales=sc)
                del rows
                bt = torch.randperm(nb, device=dev, generator=g).reshape(
                    b, maxb).int()
                if case == "ragged":
                    bt[3, 7:] = -1
                sl = torch.tensor(lens, dtype=torch.int32, device=dev)
                per_row = width + 4 * (h_kv if kind == "int4" else 1)
                rec = k4_case(torch, pdm, flush, card,
                              f"paged_decode_{kind} {case} D={d} "
                              f"{str(dtype)[6:]}", q, pool, bt, sl, h_kv,
                              sc, per_row)
                main.setdefault(kind, rec)
                del q, pool, sc
    torch.cuda.empty_cache()
    return main


# K1 at the shapes of static-cache generation (D=128): (label, B, H,
# H_kv, Lq, Lk, start position). The decode case at Lk=197 has bias rows
# that are not 16-byte aligned, so a bf16 call takes ``_aligned_bias``'s
# copy, as a generation step does when prompt + new is not a multiple of 4.
K1_GEN_CASES = (
    ("static prefill Lq=128 Lk=192 G=2", 8, 16, 8, 128, 192, 0),
    ("static prefill Lq=128 Lk=192 G=4", 8, 16, 4, 128, 192, 0),
    ("decode Lq=1 Lk=192 G=2", 8, 16, 8, 1, 192, 150),
    ("decode Lq=1 Lk=192 G=4", 8, 16, 4, 1, 192, 150),
    ("decode Lq=1 Lk=197 G=2", 8, 16, 8, 1, 197, 150),
)


def phase_flash_generation(torch, fa, masks, attn, flush, card,
                           dev="cuda"):
    """K1 at the shapes static-cache generation gives it (``K1_GEN_CASES``,
    bf16 and fp32): the prefill of a 128-token prompt against the whole
    192-slot buffer under ``causal_mask_static_kv``'s bias ``[B, 1, Lq,
    Lk]``, and a decode step at Lq=1 with its bias ``[B, 1, 1, Lk]``, each
    against its plain version at phase 3's bounds, and timed beside SDPA
    on the same operands and mask and beside the port's ``"xla"`` route
    (``_sdpa_xla`` after ``repeat_kv``). Returns one record a case."""
    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(17)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    recs = []
    for label, b, h, h_kv, lq, lk, start in K1_GEN_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            d = 128
            q = torch.randn(b, h, lq, d, device=dev, generator=g).to(dtype)
            k = torch.randn(b, h_kv, lk, d, device=dev, generator=g).to(dtype)
            v = torch.randn(b, h_kv, lk, d, device=dev, generator=g).to(dtype)
            # a prefill passes the all-valid prompt mask, a step none
            am = (torch.ones(b, start + lq, dtype=torch.int32, device=dev)
                  if lq > 1 else None)
            bias = masks.causal_mask_static_kv(lq, lk, start, am,
                                               batch_size=b, device=dev)
            out, lse = fa.flash_attention_fwd(q, k, v, bias)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_attention_fwd_ref(q, k, v, bias)
            err = float((out.float() - ref.float()).abs().max())
            lse_err = float((lse - ref_lse).abs().max())
            atol = (FP32_ATOL if dtype == torch.float32
                    else attn_bf16_atol(ref, v))
            check(err <= atol, f"K1 {label} {dtype}: max err {err} > {atol}")
            check(lse_err <= 1e-3, f"K1 {label}: lse err {lse_err}")
            rep = h // h_kv
            mask = sdpa_mask(torch, bias, lq, lk, False, None, dtype)
            times = {
                "ms": lambda: fa.flash_attention_fwd(q, k, v, bias),
                "plain_ms": lambda: fa.flash_attention_fwd_ref(q, k, v,
                                                               bias),
                "library_ms": lambda: sdpa(q, k, v, attn_mask=mask,
                                           enable_gqa=True),
                "xla_route_ms": lambda: attn._sdpa_xla(
                    q, attn.repeat_kv(k, rep), attn.repeat_kv(v, rep),
                    bias),
            }
            rec = {"label": label, "dtype": str(dtype)[6:], "lq": lq,
                   "lk": lk, "group": rep, "max_abs_err": err}
            rec.update({name: cuda_ms(fn, flush, iters=10)
                        for name, fn in times.items()})
            flops = 4 * d * live_pairs(torch, bias, b, h, lq, lk)
            rec.update(bound(flops, nbytes(q, k, v, bias, out, lse), dtype))
            recs.append(rec)
            phase(f"K1 flash_fwd generation {label} {rec['dtype']}: "
                  f"max_abs_err={err} (atol {atol}) kernel {rec['ms']:.4f} "
                  f"ms ({achieved(flops, rec['ms'], rec)}), plain "
                  f"{rec['plain_ms']:.4f}, SDPA {rec['library_ms']:.4f}, "
                  f"xla route {rec['xla_route_ms']:.4f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms [{card}]")
    return recs


def gen_model(torch, tt, cfg, quant=None, dev="cuda"):
    """Qwen ``cfg`` in bf16 on ``dev`` from seeded random weights (the
    same weights on every call), through ``quantize_model(**quant)``."""
    dev = torch.device(dev)
    model = tt.ModelForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    model.init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    if quant is not None:
        tt.quantize_model(model, **quant)
    return model


def gen_step_ms(torch, tt, model, ids, steps: int = GEN_TRACE_STEPS,
                walls: int = 3):
    """One greedy ``generate_hf(max_new_tokens=steps + 1)`` on ``ids``,
    its prefill (the model's first call) and its ``steps`` decode steps
    (each a model call and the emit of its token; the prefill's own emit
    falls in the steps) measured apart: hooks on the model synchronise
    before and after its first call. Unprofiled (median of ``walls``
    runs): the prefill's ms between those synchronises, and the wall ms
    per step from the second to the synchronise after ``generate_hf``
    returns. Then one run under two ``torch.profiler`` traces, one of the
    prefill and one from its end to the end of the run: the prefill's
    device ms, the steps' device ms per step, the idle share ``1 - device
    / wall``, K1's, K8's and K9's device ms per step and the three kernels
    with the most time."""
    at = {}

    def pre(module, args):
        at["calls"] = at.get("calls", 0) + 1
        if at["calls"] == 1:
            at["before"]()

    def post(module, args, out):
        if at["calls"] == 1:
            at["after"]()

    def run(before, after):
        at.update(calls=0, before=before, after=after)
        tt.generate_hf(model, ids, max_new_tokens=steps + 1,
                       eos_token_id=-1)
        torch.cuda.synchronize()

    def mark(name):
        def fn():
            torch.cuda.synchronize()
            at[name] = time.perf_counter()
        return fn

    hooks = (model.register_forward_pre_hook(pre),
             model.register_forward_hook(post))
    try:
        pre_ms, times = [], []
        for _ in range(walls):
            run(mark("t0"), mark("t1"))
            t2 = time.perf_counter()
            pre_ms.append((at["t1"] - at["t0"]) * 1e3)
            times.append((t2 - at["t1"]) * 1e3 / steps)
        act = torch.profiler.ProfilerActivity
        traces = [torch.profiler.profile(activities=[act.CPU, act.CUDA])
                  for _ in "ab"]

        def start():
            torch.cuda.synchronize()
            traces[0].start()

        def switch():
            torch.cuda.synchronize()
            traces[0].stop()
            traces[1].start()
        run(start, switch)
        traces[1].stop()
    finally:
        for h in hooks:
            h.remove()
    pre_kern, _ = device_kernels(torch, traces[0],
                                 expect=("flash_fwd_kernel",))
    kern, source = device_kernels(torch, traces[1],
                                  expect=("flash_fwd_kernel",))
    total = sum(ms for ms, _ in kern.values())
    pre_dev = sum(ms for ms, _ in pre_kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:3]
    wall = statistics.median(times)

    def per_step(name):
        ms = sum(v[0] for k, v in kern.items() if name in k)
        return ms / steps if total > 0 else None
    return {"prefill_ms": statistics.median(pre_ms),
            "prefill_device_ms": pre_dev if pre_dev > 0 else None,
            "step_wall_ms": wall,
            "step_wall_range_ms": (min(times), max(times)),
            "step_device_ms": total / steps if total > 0 else None,
            "idle": (1 - total / steps / wall) if total > 0 else None,
            "k1_ms": per_step("flash_fwd_kernel"),
            "k8_ms": per_step("int8_matmul_kernel"),
            "k9_ms": per_step("int4_matmul_kernel"),
            "top": [(k[:60], round(v[0] / steps, 4)) for k, v in top],
            "source": source}


def phase_generation(torch, np, tt, fa, qm, card, dev="cuda"):
    """Static-cache generation at Qwen3-0.6B width (``QwenConfig()``, 28
    layers, tied 151,936 head), seeded random bf16 weights: ``GEN_B``
    all-valid prompts of ``GEN_PROMPT`` tokens, ``GEN_NEW`` greedy new
    tokens, eos -1 (never fires), through ``generate_hf`` and, in bf16,
    ``generate(use_cache=True)`` too (identical tokens required); then the
    same weights through ``quantize_model`` int8 and int4 (gs 128),
    through ``generate_hf``. Each run's launch counts of K1, K8 and K9
    are zeroed just before it and read just after: K1 must run once a
    layer a model call, K8 in both quantized runs (int4 keeps an int8 tied
    head), K9 in the int4 run. Each model also gets ``gen_step_ms``."""
    cfg = tt.QwenConfig()
    dev = torch.device(dev)
    rng = np.random.default_rng(21)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (GEN_B, GEN_PROMPT))).to(dev)
    kernels = (fa.flash_attention_fwd, qm.int8_matmul, qm.int4_matmul)
    calls = cfg.num_hidden_layers * GEN_NEW     # a prefill + GEN_NEW-1 steps
    res, ref = {}, None
    for label, quant in (("bf16", None), ("int8", dict(bits=8)),
                         ("int4", dict(bits=4, group_size=128))):
        model = gen_model(torch, tt, cfg, quant, dev)
        # first calls (cuBLAS handles, the split-K workspaces) out of the
        # timed run
        tt.generate_hf(model, ids, max_new_tokens=2, eos_token_id=-1)
        torch.cuda.synchronize()
        zero_launches(kernels)
        t0 = time.perf_counter()
        toks = tt.generate_hf(model, ids, max_new_tokens=GEN_NEW,
                              eos_token_id=-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches(kernels)
        check(tuple(toks.shape) == (GEN_B, GEN_PROMPT + GEN_NEW)
              and torch.equal(toks[:, :GEN_PROMPT].long(), ids)
              and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"generation {label}: bad token buffer")
        check(launches["flash_attention_fwd"] == calls,
              f"generation {label}: K1 ran {launches['flash_attention_fwd']}"
              f" times, not once a layer a call ({calls})")
        if quant is not None:
            check(launches["int8_matmul_kernel_tc"] > 0,
                  f"generation {label}: K8 never ran: {launches}")
        if label == "int4":
            check(launches["int4_matmul_kernel_tc"] > 0,
                  f"generation {label}: K9 never ran: {launches}")
        rec = {"tok_s": GEN_B * GEN_NEW / wall, "wall_s": wall,
               "launches": launches}
        if ref is None:
            zero_launches(kernels)
            t0 = time.perf_counter()
            toks_g = tt.generate(model, ids, max_new_tokens=GEN_NEW,
                                 use_cache=True)
            torch.cuda.synchronize()
            rec["generate_tok_s"] = GEN_B * GEN_NEW / (
                time.perf_counter() - t0)
            rec["generate_launches"] = kernel_launches(kernels)
            check(torch.equal(toks_g.to(torch.int32), toks),
                  "generate and generate_hf give different tokens")
            check(rec["generate_launches"]["flash_attention_fwd"] == calls,
                  f"generate: K1 launches {rec['generate_launches']}")
            ref = toks
        rec["agree_bf16"] = float((toks[:, GEN_PROMPT:]
                                   == ref[:, GEN_PROMPT:]).float().mean())
        rec.update(gen_step_ms(torch, tt, model, ids))
        rec["step_wall_from_run_ms"] = (wall * 1e3 - rec["prefill_ms"]) / (
            GEN_NEW - 1)
        res[label] = rec
        dev_txt = ("device not measured" if rec["step_device_ms"] is None
                   else f"device per step {rec['step_device_ms']:.4f} ms "
                   f"(K1 {rec['k1_ms']:.4f}, K8 {rec['k8_ms']:.4f}, K9 "
                   f"{rec['k9_ms']:.4f}), idle {rec['idle']:.3f}, prefill "
                   f"device {rec['prefill_device_ms']} ms, top "
                   f"{rec['top']} ({rec['source']})")
        extra = ("" if label != "bf16" else
                 f"; generate(use_cache=True) {rec['generate_tok_s']:.1f} "
                 "tok/s, tokens identical to generate_hf")
        phase(f"generation Qwen3-0.6B width {label} B={GEN_B} prompt "
              f"{GEN_PROMPT} new {GEN_NEW}: generate_hf {rec['tok_s']:.1f} "
              f"tok/s ({wall:.3f} s), prefill {rec['prefill_ms']:.3f} ms, "
              f"wall per step {rec['step_wall_ms']:.4f} ms (generate_hf of "
              f"{GEN_TRACE_STEPS} steps, range {rec['step_wall_range_ms']}; "
              f"{rec['step_wall_from_run_ms']:.4f} ms over the run), "
              f"{dev_txt}; greedy tokens agreeing with bf16 "
              f"{rec['agree_bf16']:.4f}; launches {launches}{extra} [{card}]")
        del model
        torch.cuda.empty_cache()
    return res


def phase_generation_numerics(torch, np, tt, fa, attn, tol=2e-3,
                              dev="cuda"):
    """2 layers, fp32, card against CPU: the Qwen width (phase 6's model)
    prefilling a 64-token prompt (B=2) and 8 cached steps teacher-forced
    along the CPU's greedy tokens, logits within phase 6's ``tol``; cached
    and uncached ``generate`` on the card token-exact, and equal to the
    CPU's; ``DecoderModel.generate`` (rope + GQA, absolute + MHA; hidden
    256, D=64) cached and uncached, card against CPU token-exact; and a
    left-padded batch, whose pad queries are fully masked in the cached
    prefill, on the ``"flash"`` route on both devices (K1's contract on
    the card, its plain version on the CPU: such rows give 0, where the
    CPU's ``"xla"`` route gives the mean of V). K1 must run on the card."""
    import copy
    dev = torch.device(dev)
    cfg = tt.QwenConfig(num_hidden_layers=2)
    cpu = tt.ModelForCausalLM(cfg, device="cpu")
    cpu.init(torch.Generator().manual_seed(3)).requires_grad_(False)
    gpu = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(8)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    zero_launches((fa.flash_attention_fwd,))
    logits, cpu_tokens = {}, None
    with torch.no_grad():
        for side, model in (("cpu", cpu), ("card", gpu)):
            d = model.device
            cache = model.init_cache(batch_size=2, max_len=72)
            out = model(ids.to(d), cache=cache, start_pos=0)
            steps = [out.logits.float().cpu()]
            for i in range(8):
                tok = (steps[-1][:, -1].argmax(-1) if side == "cpu"
                       else cpu_tokens[i])
                out = model(tok[:, None].to(d), cache=cache,
                            start_pos=64 + i)
                steps.append(out.logits.float().cpu())
            logits[side] = steps
            if side == "cpu":
                cpu_tokens = [s[:, -1].argmax(-1) for s in steps[:-1]]
    errs = [float((a - b).abs().max())
            for a, b in zip(logits["cpu"], logits["card"])]
    check(max(errs) <= tol, f"generation numerics: card vs CPU logits "
          f"{max(errs)} > {tol}")
    gen = {name: tt.generate(m, ids, max_new_tokens=8, use_cache=c).cpu()
           for name, m, c in (("card cached", gpu, True),
                              ("card uncached", gpu, False),
                              ("cpu cached", cpu, True))}
    check(torch.equal(gen["card cached"], gen["card uncached"]),
          f"card: cached and uncached generate differ: {gen}")
    check(torch.equal(gen["card cached"], gen["cpu cached"]),
          f"generate card vs CPU: {gen}")
    ecfg = tt.EncoderConfig(hidden_size=256, num_attention_heads=4,
                            num_key_value_heads=2, num_hidden_layers=2,
                            vocab_size=1024, max_position_embeddings=128,
                            intermediate_size=1024, hidden_dropout_prob=0.0)
    x = torch.from_numpy(rng.integers(2, 1024, (3, 20)))
    mask = torch.ones_like(x)
    mask[0, :5] = 0
    xp = x.clone()
    xp[0, :5] = ecfg.pad_token_id
    dec_tokens = {}
    for pe, at in (("rope", "gqa"), ("absolute", None)):
        dcpu = tt.DecoderModel(ecfg, pe, at, device="cpu")
        dcpu.init(torch.Generator().manual_seed(4)).requires_grad_(False)
        dgpu = copy.deepcopy(dcpu).to(dev)
        for use_cache in (True, False):
            a = dgpu.generate(x.to(dev), max_len=10,
                              use_cache=use_cache).cpu()
            b = dcpu.generate(x, max_len=10, use_cache=use_cache)
            check(torch.equal(a, b), f"DecoderModel.generate {pe}/{at} "
                  f"cache={use_cache}: card {a} vs CPU {b}")
            dec_tokens[f"{pe}/{at} cache={use_cache}"] = a[:, 20:].tolist()
        attn.set_sdpa_impl("flash")
        try:
            for use_cache in (True, False):
                a = dgpu.generate(xp.to(dev), mask.to(dev), max_len=10,
                                  use_cache=use_cache).cpu()
                b = dcpu.generate(xp, mask, max_len=10, use_cache=use_cache)
                check(torch.equal(a, b), f"DecoderModel.generate {pe}/{at} "
                      f"left-padded, flash route, cache={use_cache}: card "
                      f"{a} vs CPU {b}")
        finally:
            attn.set_sdpa_impl("auto")
    launches = fa.flash_attention_fwd.launches
    check(launches > 0, "generation numerics: K1 never ran on the card")
    phase(f"generation numerics 2L fp32: Qwen width prefill(64) + 8 cached "
          f"steps, per-call max |dlogit| card vs CPU {errs} (tol {tol}); "
          f"generate cached = uncached on the card = CPU: "
          f"{gen['card cached'][:, 64:].tolist()}; DecoderModel.generate "
          f"card = CPU (rope/gqa, absolute/mha; cached, uncached; a "
          f"left-padded batch on the flash route): {dec_tokens}; K1 "
          f"launches {launches}")
    return launches


# K12's cases: (configuration, call, norm site, rows, width, residual add)
# at the served shapes: decode steps of 64 lanes (128 for LFM2), prefill
# calls of 4 x 512 slots; per-head q and k rows are tokens x heads
K12_CASES = (
    ("qwen3-0.6b", "decode", "hidden", 64, 1024, True),
    ("qwen3-0.6b", "decode", "q", 64 * 16, 128, False),
    ("qwen3-0.6b", "decode", "k", 64 * 8, 128, False),
    ("qwen3-0.6b", "prefill", "hidden", 2048, 1024, True),
    ("qwen3-0.6b", "prefill", "q", 2048 * 16, 128, False),
    ("qwen3-0.6b", "prefill", "k", 2048 * 8, 128, False),
    ("mistral-7b-v0.3-int8", "decode", "hidden", 64, 4096, True),
    ("mistral-7b-v0.3-int8", "prefill", "hidden", 2048, 4096, True),
    ("lfm2-8b-a1b", "decode", "hidden", 128, 2048, True),
    ("lfm2-8b-a1b", "decode", "q", 128 * 32, 64, False),
    ("lfm2-8b-a1b", "decode", "k", 128 * 8, 64, False),
    ("lfm2-8b-a1b", "prefill", "hidden", 2048, 2048, True),
    ("lfm2-8b-a1b", "prefill", "q", 2048 * 32, 64, False),
    ("lfm2-8b-a1b", "prefill", "k", 2048 * 8, 64, False),
)
# norm sites a decode step or prefill call, for phase 20's extrapolated
# step: 2 a layer, 2 more a layer with per-head QK-norm, and the final norm
K12_SITES = {"qwen3-0.6b": {"hidden": 2 * 28 + 1, "q": 28, "k": 28},
             "mistral-7b-v0.3-int8": {"hidden": 2 * 32 + 1},
             "lfm2-8b-a1b": {"hidden": 2 * 24 + 1, "q": 6, "k": 6}}


def phase_k12(torch, flush, card):
    """K12 at every ``K12_CASES`` shape, bf16: against its plain version
    (``core.nn.rms_norm`` after the add) within one bf16 ulp, at least 99 %
    of the outputs identical and the residual sum exact, five calls
    bit-identical; then its time beside the plain chain's (about nine
    kernels), the library's (the add, then ``F.rms_norm``) and its bound
    (each operand read once, each output written once). Returns the cases'
    records. A phase line a configuration and call extrapolates a step's
    norm time from them (``K12_SITES`` x each site's time alone); the
    kernels line takes K12's launches from the served runs instead."""
    import torch.nn.functional as F
    from vyomai_tpu_torch.core import nn as cnn
    from vyomai_tpu_torch.ops.rms_norm import rms_norm
    dev, eps, bf16 = torch.device("cuda"), 1e-6, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(12)
    recs, steps = [], {}
    for conf, call, site, rows, d, res in K12_CASES:
        x, h = (torch.randn(rows, d, generator=g, device=dev).to(bf16)
                for _ in range(2))
        w = (1.0 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf16)
        if res:
            def kernel():
                return rms_norm(w, x, eps, residual=h)

            def plain():
                s = h + x
                return s, cnn.rms_norm(w, s, eps=eps)

            def library():
                s = h + x
                return s, F.rms_norm(s, (d,), w, eps)
        else:
            def kernel():
                return None, rms_norm(w, x, eps)

            def plain():
                return None, cnn.rms_norm(w, x, eps=eps)

            def library():
                return None, F.rms_norm(x, (d,), w, eps)
        s, got = kernel()
        s_want, want = plain()
        check(s is None or torch.equal(s, s_want),
              f"K12 {conf} {call} {site}: the residual sum differs")
        _, e = torch.frexp(torch.maximum(got.float().abs(),
                                         want.float().abs()))
        err = (got.float() - want.float()).abs()
        same = float((got == want).float().mean())
        check(bool((err <= torch.ldexp(torch.ones_like(err), e - 8)).all())
              and same >= 0.99, f"K12 {conf} {call} {site}: over one ulp "
              f"or {same:.4f} identical")
        check(all(torch.equal(kernel()[1], got) for _ in range(5)),
              f"K12 {conf} {call} {site}: calls differ")
        moved = nbytes(x, w, got) + (nbytes(h, s) if res else 0)
        rec = bound(0.0, moved, bf16)
        rec.update(config=conf, call=call, site=site, rows=rows, width=d,
                   residual=res, identical=same, ms=cuda_ms(kernel, flush),
                   plain_ms=cuda_ms(plain, flush),
                   library_ms=cuda_ms(library, flush))
        phase(f"K12 {conf} {call} {site} [{rows}, {d}]"
              f"{' + residual' if res else ''}: {same:.4f} identical; "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"library {rec['library_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms [{card}]")
        recs.append(rec)
        n = K12_SITES[conf][site]
        step = steps.setdefault(f"{conf}.{call}", {
            "sites": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "bound_ms": 0.0})
        step["sites"] += n
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            step[k] += n * rec[k]
        del x, h, w, s, got, want, s_want, err
    for name, step in steps.items():
        phase(f"K12 a {name}, extrapolated, not measured: {step['sites']} "
              f"sites x each site's time alone (L2 flushed): "
              f"{step['ms']:.4f} ms (plain {step['plain_ms']:.4f}, library "
              f"{step['library_ms']:.4f}, bound {step['bound_ms']:.4f}) "
              f"[{card}]")
    torch.cuda.empty_cache()
    return {"cases": recs}


def main():
    check((ROOT / "vyomai_tpu_torch" / "csrc").is_dir(),
          "run from a checkout: vyomai_tpu_torch/ not found beside this "
          "script")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    phase("1/21 device and set-up")
    check(torch.cuda.is_available(), "no CUDA device: this script runs the "
          "port on an NVIDIA card and does not fall back to the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = smi
    phase(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    import vyomai_tpu_torch as tt
    from vyomai_tpu_torch import bench
    from vyomai_tpu_torch import quant_bench as qb
    from vyomai_tpu_torch import encoder_bench as eb
    from vyomai_tpu_torch.core import masks
    from vyomai_tpu_torch.layers import attention as attn
    from vyomai_tpu_torch.ops import _build
    from vyomai_tpu_torch.ops import flash_attention as fa
    from vyomai_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_ref)
    from vyomai_tpu_torch.ops.paged_decode import paged_decode
    from vyomai_tpu_torch.ops import short_attention as sa
    from vyomai_tpu_torch.ops import paged_attention as pa
    from vyomai_tpu_torch.ops import paged_decode as pdm
    from vyomai_tpu_torch.ops import quant_matmul as qm
    from vyomai_tpu_torch.serving import paged_model as pm
    from vyomai_tpu_torch.layers import moe
    from vyomai_tpu_torch.ops import grouped_matmul as gm
    from vyomai_tpu_torch.ops.rms_norm import rms_norm
    from vyomai_tpu_torch.ops import mla_attention as mla
    t0 = time.perf_counter()
    _build.library()
    phase(f"kernels built/loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds} s)")
    tc = tensor_core_kernels(_build.path)
    phase("bf16 tensor-core kernels (HMMA instructions, registers, stack "
          f"bytes): {tc}")
    check(sorted(tc) == sorted(TC_KERNELS)
          and all(hmma > 0 for hmma, _, _ in tc.values()),
          f"a bf16 tensor-core kernel without tensor-core code: {tc}")
    check(all(stack == 0 for _, _, stack in tc.values()),
          f"a bf16 tensor-core kernel spills: {tc}")
    k13_res = k13_kernels(_build.path)
    phase("K13 (HMMA instructions, registers, shared memory bytes, stack "
          f"bytes): {k13_res}")
    check(sorted(k13_res) == sorted(K13_KERNELS)
          and k13_res["k13_decode_split_kernel"][0] > 0
          and k13_res["k13_prefill_kernel"][0] > 0
          and all(v[3] == 0 for v in k13_res.values()),
          f"K13 without its tensor-core kernels, or spilling: {k13_res}")
    k4_res = k4_kernels(_build.path)
    phase("K4 split-KV pair (registers, shared memory bytes, stack bytes) "
          f"<q type, D, pool, group rows> / <q type, D>: {k4_res}")
    # 24 split kernels (2 q types x 2 D x 3 pools x 2 group sizes) and 4
    # combine kernels (2 q types x 2 D); nothing else reads the pool
    check({name.split("<")[0] for name in k4_res} == set(K4_KERNELS)
          and len(k4_res) == 28,
          f"K4's kernels are not the split-KV pair: {sorted(k4_res)}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    phase("2/21 K4 paged decode vs plain")
    k4 = phase_decode(torch, pdm, flush, card)
    phase("3/21 K1 flash forward vs plain")
    k1 = phase_flash(torch, flash_attention_fwd, flash_attention_fwd_ref,
                     flush, card)
    k1_gen = phase_flash_generation(torch, fa, masks, attn, flush, card)
    phase("4/21 K2/K3 flash backward vs plain")
    k23 = phase_flash_bwd(torch, fa, flush, card)
    del flush
    phase("5/21 end-to-end serving")
    served = phase_serving(torch, np, tt, pm,
                           (paged_decode, flash_attention_fwd, rms_norm),
                           card, sync_rerun=True)
    phase("6/21 serving numerics")
    phase_numerics(torch, np, tt, pm, kernels=(paged_decode,
                                                flash_attention_fwd))
    phase_graph_numerics(torch, np, tt, pm)
    phase("7/21 end-to-end training")
    trained = phase_training(torch, bench, bench.KERNELS, card)
    phase("8/21 training numerics")
    phase_train_numerics(torch, np, tt, bench)
    phase("9/21 K5/K6/K7 short attention vs plain")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    k567 = phase_short(torch, sa, fa, flush, card)
    del flush
    phase("10/21 end-to-end ViT-base")
    vit = phase_vit(torch, eb, eb.KERNELS, card)
    phase("11/21 end-to-end RoBERTa-base MLM")
    mlm = phase_mlm(torch, eb, eb.KERNELS, card)
    phase("12/21 encoder numerics")
    phase_encoder_numerics(torch, np, eb, eb.KERNELS)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    phase("13/21 K8/K9/K10 quantized matmuls vs plain, and the K10 path")
    qmm, k10_path = phase_quant_matmul(torch, qm, qb, flush, card)
    phase("14/21 K4 int8/int4 pools vs plain")
    k4q = phase_quant_decode(torch, pdm, pa, flush, card)
    del flush
    phase("15/21 end-to-end quantized serving")
    q8 = phase_serving(
        torch, np, tt, pm, (flash_attention_fwd, pdm.paged_decode_int8,
                            qm.int8_matmul, rms_norm), card,
        label="int8 weights + int8 pool", quant=dict(bits=8),
        pool_dtype=torch.int8, reference=served["outs"])
    q4 = phase_serving(
        torch, np, tt, pm, (flash_attention_fwd, pdm.paged_decode_int4,
                            qm.int8_matmul, qm.int4_matmul), card,
        label="int4 weights (gs 128) + int4 pool",
        quant=dict(bits=4, group_size=128), pool_dtype="int4",
        reference=served["outs"])
    bf_ms = served["tick"]["graph"]["device_ms"]
    for label, run in (("int8", q8), ("int4", q4)):
        ms = run["tick"]["graph"]["device_ms"]
        if bf_ms and ms:
            phase(f"graph tick device ms per step {label} {ms:.4f} vs bf16 "
                  f"{bf_ms:.4f} (ratio {ms / bf_ms:.4f}) [{card}]")
    phase("16/21 quantized numerics")
    n8 = phase_numerics(torch, np, tt, pm, "fp32 int8 weights + int8 pool",
                        quant=dict(bits=8), pool_dtype=torch.int8,
                        kernels=(qm.int8_matmul, pdm.paged_decode_int8))
    # K/V computed on the two devices differ in fp32 rounding, and where
    # one lies at a rounding boundary its int4 entry lands a whole step
    # (amax/7 of its head) apart: a wider bound than int8's (the count of
    # such pool bytes is printed)
    n4 = phase_numerics(torch, np, tt, pm, "fp32 int4 weights + int4 pool",
                        quant=dict(bits=4, group_size=128),
                        pool_dtype="int4", tol=2e-2,
                        kernels=(qm.int8_matmul, qm.int4_matmul,
                                 pdm.paged_decode_int4))
    # W8A8 re-quantizes every linear's input per token on each device, so
    # fp32 rounding differences flip activation codes at all 14 linears:
    # the logits bound is wide, and each linear is also held exact on
    # identical inputs
    phase_numerics(torch, np, tt, pm, "fp32 W8A8",
                   quant=dict(bits=8, act_bits=8), tol=0.1,
                   kernels=(qm.int8_matmul, paged_decode))
    phase_w8a8_linears(torch, np, tt, qm, pm)
    phase("17/21 end-to-end static-cache generation")
    gen = phase_generation(torch, np, tt, fa, qm, card)
    phase("18/21 generation numerics")
    phase_generation_numerics(torch, np, tt, fa, attn)
    gen_k1 = sum(r["launches"]["flash_attention_fwd"] for r in gen.values()
                 ) + gen["bf16"]["generate_launches"]["flash_attention_fwd"]
    phase("19/21 LFM2-8B-A1B: K11 vs plain, and end-to-end serving")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    k11 = phase_k11(torch, gm, moe, flush, card)
    del flush
    lfm2 = phase_lfm2_serving(torch, np, tt, (paged_decode,
                                              flash_attention_fwd,
                                              gm.grouped_swiglu, rms_norm),
                              card)
    phase("20/21 K12 RMSNorm vs plain at the served norm sites")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    k12 = phase_k12(torch, flush, card)
    del flush
    phase("21/21 Moonlight-16B-A3B: K13 vs plain, and end-to-end serving")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    k13 = phase_k13(torch, mla, flush, card)
    del flush
    moon = phase_moonlight_serving(torch, np, tt, (
        mla.mla_decode, mla.mla_prefill, gm.grouped_swiglu, rms_norm), card)

    record = {"kernels": [
        {"name": "paged_decode[split+combine]", "route": "cuda",
         "kernels": list(K4_KERNELS),
         "source": "vyomai_tpu_torch/csrc/paged_decode.cu",
         "replaces": "vyomai_tpu/ops/paged_decode_pallas.py:40",
         "launches": served["launches"]["paged_decode"], **k4},
        {"name": "flash_fwd", "route": "cuda",
         "source": "vyomai_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "vyomai_tpu/ops/flash_attention.py:157",
         "launches": sum(run["launches"]["flash_attention_fwd"]
                         for run in (served, q8, q4))
         + trained["flash_attention_fwd"] + gen_k1, **k1,
         "generation_cases": k1_gen},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "vyomai_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "vyomai_tpu/ops/flash_attention.py:362",
         "launches": trained["flash_bwd_dq"], **k23["flash_bwd_dq"]},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": "vyomai_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "vyomai_tpu/ops/flash_attention.py:411",
         "launches": trained["flash_bwd_dkv"], **k23["flash_bwd_dkv"]},
        {"name": "short_attention_fwd", "route": "cuda",
         "source": "vyomai_tpu_torch/csrc/short_attention.cu",
         "replaces": "vyomai_tpu/ops/short_attention.py:96",
         "launches": mlm["short_attention_fwd"], **k567["K5"]},
        {"name": "short_attention_qkv_fwd", "route": "cuda",
         "source": "vyomai_tpu_torch/csrc/short_attention.cu",
         "replaces": "vyomai_tpu/ops/short_attention.py:207",
         "launches": vit["short_attention_qkv_fwd"], **k567["K6"]},
        {"name": "short_attention_bwd", "route": "cuda",
         "source": "vyomai_tpu_torch/csrc/short_attention.cu",
         "replaces": "vyomai_tpu/ops/short_attention.py:309",
         "launches": vit["short_attention_bwd"]
         + mlm["short_attention_bwd"], **k567["K7"]},
        {"name": "int8_matmul_kernel_tc", "route": "cuda",
         "source": "vyomai_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "vyomai_tpu/ops/quant_matmul.py:123",
         "launches": sum(run["launches"]["int8_matmul_kernel_tc"]
                         for run in (q8, q4, gen["int8"], gen["int4"])),
         **qmm["K8"]},
        # fp32 and kn stay on the CUDA cores: phase 16's fp32 path
        {"name": "int8_matmul", "route": "cuda",
         "source": "vyomai_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "vyomai_tpu/ops/quant_matmul.py:107",
         "launches": n8["int8_matmul"], **qmm["K8-cuda"]},
        {"name": "int4_matmul_kernel_tc", "route": "cuda",
         "source": "vyomai_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "vyomai_tpu/ops/quant_matmul.py:276",
         "launches": q4["launches"]["int4_matmul_kernel_tc"]
         + gen["int4"]["launches"]["int4_matmul_kernel_tc"], **qmm["K9"]},
        # fp32, kn and split stay on the CUDA cores: phase 16's fp32 path
        {"name": "int4_matmul", "route": "cuda",
         "source": "vyomai_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "vyomai_tpu/ops/quant_matmul.py:276",
         "launches": n4["int4_matmul"], **qmm["K9-cuda"]},
        {"name": "int4_attribution_kernel_tc", "route": "cuda",
         "source": "vyomai_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "benchmarks/int4_dense_bench.py:62",
         "launches": k10_path["int4_attribution_kernel_tc"],
         **qmm["K10"]},
        {"name": "paged_decode_int8[split+combine]", "route": "cuda",
         "kernels": list(K4_KERNELS),
         "source": "vyomai_tpu_torch/csrc/paged_decode.cu",
         "replaces": "vyomai_tpu/ops/paged_decode_pallas.py:40",
         "launches": q8["launches"]["paged_decode_int8"], **k4q["int8"]},
        {"name": "paged_decode_int4[split+combine]", "route": "cuda",
         "kernels": list(K4_KERNELS),
         "source": "vyomai_tpu_torch/csrc/paged_decode.cu",
         "replaces": "vyomai_tpu/ops/paged_decode_pallas.py:40",
         "launches": q4["launches"]["paged_decode_int4"], **k4q["int4"]},
        {"name": "grouped_swiglu", "route": "triton",
         "kernels": ["k11_gate_up_kernel", "k11_down_kernel"],
         "source": "vyomai_tpu_torch/ops/grouped_matmul.py",
         "replaces": "vyomai_tpu/layers/moe.py:60",
         "launches": lfm2["launches"]["grouped_swiglu"], **k11["decode"],
         "prefill": k11["prefill"]},
        {"name": "rms_norm", "route": "cuda", "kernels": ["rms_norm_kernel"],
         "source": "vyomai_tpu_torch/csrc/rms_norm.cu",
         "replaces": "none (XLA fuses the JAX package's norms)",
         "launches": sum(run["launches"]["rms_norm"]
                         for run in (served, q8, lfm2)), **k12},
        {"name": "mla_attention", "route": "cuda",
         "kernels": list(K13_KERNELS),
         "source": "vyomai_tpu_torch/csrc/mla_attention.cu",
         "replaces": "none (the JAX package has no MLA)",
         "launches": {k: moon["launches"][k] for k in ("mla_decode",
                                                       "mla_prefill")},
         "resources": k13_res, **k13["decode"], "prefill": k13["prefill"]},
    ]}
    # the decode tick per step, eager against graph, and phase 5's
    # throughput pipelined against synchronous
    record["decode_tick"] = {
        label: {name: {k: run["tick"][name][k] for k in
                       ("device_ms", "wall_ms", "wall_range_ms",
                        "event_ms", "idle", "k4_ms", "k8_ms", "k9_ms",
                        "source")}
                for name in ("eager", "graph")}
        for label, run in (("bf16", served), ("int8", q8), ("int4", q4))}
    record["serving_bf16"] = {
        "pipelined_tok_s": served["tok_s"], "sync_tok_s": served["sync_tok_s"],
        "pipelined_ttft_s": served["ttft_s"],
        "sync_ttft_s": served["sync_ttft_s"],
        "chained_ticks": served["chained"], "card": card}
    # static-cache generation at Qwen3-0.6B width (phase 17)
    record["generation"] = {
        label: {k: run[k] for k in (
            "tok_s", "prefill_ms", "prefill_device_ms", "step_wall_ms",
            "step_wall_range_ms",
            "step_wall_from_run_ms", "step_device_ms", "idle", "k1_ms",
            "k8_ms", "k9_ms", "agree_bf16", "source")}
        for label, run in gen.items()}
    record["generation"]["bf16"]["generate_tok_s"] = gen["bf16"][
        "generate_tok_s"]
    record["generation"]["card"] = card
    # LFM2-8B-A1B through the engine (phase 19)
    record["serving_lfm2"] = {k: v for k, v in lfm2.items()
                              if k != "launches"}
    record["serving_lfm2"]["card"] = card
    # Moonlight-16B-A3B through the engine (phase 21)
    record["serving_moonlight"] = {k: v for k, v in moon.items()
                                   if k != "launches"}
    record["serving_moonlight"]["card"] = card
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
