"""Quantized matmuls and quantized generation on one NVIDIA card
(counterpart of the JAX package's ``benchmarks/quant_bench.py`` and of
``benchmarks/int4_dense_bench.py``).

    python -m vyomai_tpu_torch.quant_bench [--m 16] [--gs 128]
    python -m vyomai_tpu_torch.quant_bench --e2e

For each linear shape of Qwen3-0.6B (and its tied head) at M decode
tokens, bf16 activations: ``torch.matmul`` on the bf16 weight, the plain
int8 version, K8 (int8, the modules' ``nk`` layout), K9 fold and split
(int4, group ``gs``, the modules' ``nk`` packed layout). Then the int4 attribution of ``int4_dense_bench``
at M=8, K=N=2048: bf16, K8, K9 fold, and K10's ``stream`` (the packed bytes
dotted as int8: K9's traffic without unpack or group scales) and
``noscale`` (unpack, one scale row) modes. One JSON line per shape.

Times are medians of CUDA-event launches with the 50 MB L2 flushed before
each (the weights come from device memory, as in a decode step) and a
~1 ms sleep kernel queued behind the flush, so the events time the
device's work and not the host's enqueue (as ``chip_smoke.cuda_ms``).

``--e2e`` is part 2 of the JAX bench (``bench_e2e``): dense static-cache
greedy decode through the port's ``generate(use_cache=True)`` at the JAX
bench's config (vocab 32,768, hidden 2,048, intermediate 8,192, 12 layers,
16/4 heads, head_dim 128, QK-norm, tied head; random bf16 weights from a
seed), B=8, a 128-token prompt, 256 new tokens: bf16 weights, then the
same weights through ``quantize_model`` int8, then int4 (gs 128). Each is
timed on the host clock between two synchronises, after a short warm-up
run; one JSON line each with tokens/s, ms per step, the card's name and
its power limit.
"""

import argparse
import json
import statistics
import subprocess
import time

import torch

from .ops import quant_matmul as qm

# (K, N) of Qwen3-0.6B's linears: q, k/v, o, gate/up, down, tied head
QWEN3_SHAPES = ((1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
                (3072, 1024), (1024, 151936))


# cycles of the sleep kernel queued before each timed call (~1 ms)
SLEEP_CYCLES = 2_000_000


def time_ms(fn, flush: torch.Tensor, iters: int = 20,
            warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events), the L2 flushed
    and a sleep kernel queued before each timed launch."""
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


def _flush() -> torch.Tensor:
    return torch.empty(256 << 20, dtype=torch.uint8, device="cuda")


def _weights(k: int, n: int, gs: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(k, n, device="cuda", generator=g) * 0.02
    q, s = qm.quantize_weight(w.t(), contract_axis=1)
    q = q.contiguous()   # [N, K], k contiguous, as the modules store it
    p, s4 = qm.quantize_weight_int4(w, group_size=gs)
    p = p.t().contiguous()   # [N, K/2], k contiguous, as the modules
    return w.to(torch.bfloat16), q, s, p, s4


def bench_shape(m: int, k: int, n: int, gs: int = 128,
                iters: int = 20) -> dict:
    """ms of each variant at one shape, and its weight bytes per ms."""
    w_bf, q, s, p, s4 = _weights(k, n, gs, k + n)
    x = torch.randn(m, k, device="cuda").to(torch.bfloat16)
    flush = _flush()
    variants = {
        "bf16": (lambda: x @ w_bf, 2 * k * n),
        "int8_plain": (lambda: qm.int8_matmul_ref(x, q, s, "nk"), k * n),
        "int8": (lambda: qm.int8_matmul(x, q, s, w_layout="nk"), k * n),
        "int4_fold": (lambda: qm.int4_matmul(x, p, s4, kernel="fold",
                                             w_layout="nk"), k * n // 2),
        "int4_split": (lambda: qm.int4_matmul(x, p, s4, kernel="split",
                                              w_layout="nk"), k * n // 2),
    }
    out = {"m": m, "k": k, "n": n, "gs": gs}
    for name, (fn, nbytes) in variants.items():
        ms = time_ms(fn, flush, iters)
        out[f"{name}_ms"] = ms
        out[f"{name}_weight_GBps"] = nbytes / ms / 1e6
    return out


def int4_attribution(m: int = 8, k: int = 2048, n: int = 2048,
                     gs: int = 128, iters: int = 20) -> dict:
    """Where the int4 kernel's time goes (``int4_dense_bench``): K9 fold
    against K10's stream floor (same bytes, no unpack, no group scales)
    and noscale (unpack, one scale row), beside bf16 and K8."""
    w_bf, q, s, p, s4 = _weights(k, n, gs, 0)
    x = torch.randn(m, k, device="cuda").to(torch.bfloat16)
    row = qm.k10_scale_row(k, gs)
    flush = _flush()
    variants = {
        "bf16": lambda: x @ w_bf,
        "int8": lambda: qm.int8_matmul(x, q, s, w_layout="nk"),
        "int4": lambda: qm.int4_matmul(x, p, s4, kernel="fold",
                                       w_layout="nk"),
        "int4_stream": lambda: qm.int4_attribution(
            x, p, s4, mode="stream", scale_row=row, w_layout="nk"),
        "int4_noscale": lambda: qm.int4_attribution(
            x, p, s4, mode="noscale", scale_row=row, w_layout="nk"),
    }
    us = {name: 1e3 * time_ms(fn, flush, iters)
          for name, fn in variants.items()}
    return {
        "metric": "int4_dense_attribution", "m": m, "k": k, "n": n,
        "gs": gs, **{f"{name}_us": t for name, t in us.items()},
        "int4_vs_int8": us["int8"] / us["int4"],
        "unpack_tax_us": us["int4_noscale"] - us["int4_stream"],
        "scale_tax_us": us["int4"] - us["int4_noscale"],
        "stream_floor_us": us["int4_stream"],
    }


def card_name_and_limit() -> str:
    """``name, power.limit`` of card 0, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def bench_e2e(batch: int = 8, prompt: int = 128, new: int = 256,
              warmup_new: int = 4):
    """Greedy static-cache ``generate`` of the JAX bench's ~0.8B model,
    bf16 then int8 then int4 (gs 128) weights; one record each."""
    import vyomai_tpu_torch as tt
    cfg = tt.QwenConfig(vocab_size=32768, hidden_size=2048,
                        intermediate_size=8192, num_hidden_layers=12,
                        num_attention_heads=16, num_key_value_heads=4,
                        head_dim=128, max_position_embeddings=1024,
                        qk_norm=True, eos_token_id=-1,
                        tie_word_embeddings=True)
    dev = torch.device("cuda")
    ids = torch.randint(5, cfg.vocab_size, (batch, prompt), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    card = card_name_and_limit()
    out = []
    for label, quant in (("bf16", None), ("int8", dict(bits=8)),
                         ("int4", dict(bits=4, group_size=128))):
        model = tt.ModelForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
        model.init(torch.Generator(device=dev).manual_seed(0))
        model.requires_grad_(False)
        n_params = sum(p.numel() for p in model.parameters())
        if quant is not None:
            tt.quantize_model(model, **quant)
        tt.generate(model, ids, max_new_tokens=warmup_new, use_cache=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tt.generate(model, ids, max_new_tokens=new, use_cache=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out.append({"metric": "e2e_generate", "weights": label,
                    "params": n_params, "batch": batch, "prompt": prompt,
                    "new": new, "tok_s": batch * new / dt,
                    "ms_per_step": dt * 1e3 / new, "card": card})
        del model
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--gs", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--e2e", action="store_true",
                    help="static-cache generate, bf16 / int8 / int4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("quant_bench measures the CUDA card; none found")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.e2e:
        for rec in bench_e2e():
            print(json.dumps(rec), flush=True)
        return
    card = torch.cuda.get_device_name(0)
    for k, n in QWEN3_SHAPES:
        rec = bench_shape(args.m, k, n, args.gs, args.iters)
        print(json.dumps({"device": card, **rec}), flush=True)
    print(json.dumps({"device": card, **int4_attribution(
        gs=args.gs, iters=args.iters)}), flush=True)


if __name__ == "__main__":
    main()
