"""Headline benchmark of the port: decoder training throughput on one
NVIDIA card, fused path vs naive path.

    python -m vyomai_tpu_torch.bench [--steps N] [--profile]

The same model, batch, steps and losses as the JAX package's ``bench.py``:
``DecoderModel`` with RoPE + GQA, 12 layers, hidden 1024, 16 query / 4 KV
heads, FFN 4096, vocab 32,768, bf16 params and compute, B=4, S=1024, AdamW
lr 1e-4 with clip 1.0, random weights and tokens from seeded generators.

- fused: flash attention (K1 forward, K2/K3 backward) and the chunked
  LM-head cross-entropy (``ops.fused.lm_head_ce_loss``);
- naive: full-matrix attention (the ``"xla"`` route) and cross-entropy over
  the full ``[B, S, V]`` logits.

Both optimize the same objective. Prints the card's name and power limit
(``nvidia-smi``), then one JSON line with the fused path's tokens/s, the
fused/naive ratio (``vs_baseline``) and MFU against the H100's dense bf16
peak; ``--profile`` adds the fused step's device time by kind from a
``torch.profiler`` window (``step_profile``). Needs a CUDA device.
"""

import argparse
import json
import subprocess
import time

import torch

from .config import EncoderConfig
from .layers.attention import set_sdpa_impl
from .models.decoder import DecoderModel
from .models.encoder import lm_head_transform
from .ops import flash_attention as fa
from .ops.fused import cross_entropy, lm_head_ce_loss
from .training import create_train_state, make_optimizer, make_train_step

CFG = EncoderConfig(
    hidden_size=1024, num_attention_heads=16, num_key_value_heads=4,
    num_hidden_layers=12, vocab_size=32768, max_position_embeddings=1024,
    intermediate_size=4096, hidden_dropout_prob=0.0)
BATCH, SEQ = 4, 1024
STEPS = 20
H100_PEAK_BF16 = 989e12   # dense bf16 FLOP/s of one H100 SXM at 700 W
KERNELS = (fa.flash_attention_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)


def fused_loss(model, batch, generator=None):
    """The LM head's dense + GELU + LN, then the vocab projection fused
    into the chunked cross-entropy (the objective of ``naive_loss``)."""
    hidden = model.hidden_states(batch["ids"], batch["mask"])
    h = lm_head_transform(model.lm_head, hidden, model.config)
    head = model.lm_head.decoder
    return lm_head_ce_loss(h, head.weight, head.bias, batch["ids"],
                           shift=True, chunk_size=2048), {}


def naive_loss(model, batch, generator=None):
    out = model(batch["ids"], batch["mask"])
    return cross_entropy(out.logits[:, :-1], batch["ids"][:, 1:]), {}


def make_batch(config, batch: int, seq: int, *, device, seed: int = 1):
    g = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(0, config.vocab_size, (batch, seq), generator=g,
                        device=device)
    return {"ids": ids, "mask": torch.ones_like(ids)}


def build(config=CFG, *, device, dtype=torch.bfloat16, seed: int = 0):
    """A seeded ``DecoderModel(config, "rope", "gqa")``."""
    model = DecoderModel(config, "rope", "gqa", device=device, dtype=dtype)
    return model.init(torch.Generator(device=device).manual_seed(seed))


def train(fused: bool, *, steps: int = STEPS, warmup: int = 1,
          config=CFG, batch: int = BATCH, seq: int = SEQ,
          device="cuda") -> dict:
    """Train ``warmup`` then ``steps`` timed steps on one seeded batch.
    Returns every step's loss, the timed window's tokens/s and ms per
    step, peak device memory, the parameter count and the kernels'
    launches in the timed window."""
    torch.cuda.reset_peak_memory_stats(device)
    set_sdpa_impl("flash" if fused else "xla")
    try:
        model = build(config, device=device)
        opt = make_optimizer(1e-4)
        step = make_train_step(fused_loss if fused else naive_loss, opt)
        state = create_train_state(model, opt)
        data = make_batch(config, batch, seq, device=device)
        losses = []
        for _ in range(warmup):
            state, m = step(state, data)
            losses.append(m["loss"])
        torch.cuda.synchronize(device)
        before = [fn.launches for fn in KERNELS]
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, data)
            losses.append(m["loss"])
        torch.cuda.synchronize(device)
        dt = (time.perf_counter() - t0) / steps
    finally:
        set_sdpa_impl("auto")
    return {
        "losses": torch.stack(losses).float().tolist(),
        "tokens_per_s": batch * seq / dt,
        "ms_per_step": dt * 1e3,
        "peak_bytes": torch.cuda.max_memory_allocated(device),
        "n_params": sum(p.numel() for p in model.parameters()),
        "launches": {fn.__name__: fn.launches - b
                     for fn, b in zip(KERNELS, before)},
    }


# device kernels by name: the three attention kernels, cuBLAS/CUTLASS
# matrix products, and everything else (elementwise, reductions, copies)
_KINDS = (("K1 flash_fwd", ("flash_fwd_kernel",)),
          ("K2 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
          ("K3 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
          ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")))


def _kind(name: str, kinds=_KINDS) -> str:
    low = name.lower()
    for kind, keys in kinds:
        if any(key in low for key in keys):
            return kind
    return "other"


def device_split(run, *, steps: int, kinds=_KINDS, device="cuda") -> dict:
    """Where a step's time goes. ``run(n)`` runs ``n`` steps; a window of
    ``steps`` steps is timed unprofiled (CUDA events), then one is traced
    with ``torch.profiler``, whose device kernels' time per step is summed
    by kind (``kinds``: (label, name fragments) pairs, the rest "other").
    The idle share is what the kernels leave of the unprofiled step (one
    stream, so kernels do not overlap); the profiled window is longer, by
    the profiler's own host cost, and is reported beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    windows = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for traced in (False, True):
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if traced:
            prof.start()
        start.record()
        run(steps)
        end.record()
        torch.cuda.synchronize(device)
        if traced:
            prof.stop()
        windows.append(start.elapsed_time(end) / steps)
    by_kind, by_name = {}, {}
    for evt in prof.key_averages():
        # host ops carry their kernels' device time, and a user annotation
        # (the optimizer's step) spans its kernels on the device: skip both
        if evt.device_type != DeviceType.CUDA or evt.is_user_annotation:
            continue
        ms = evt.self_device_time_total / 1e3 / steps
        kind = _kind(evt.key, kinds)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        by_name[evt.key] = by_name.get(evt.key, 0.0) + ms
    busy = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"step_ms": windows[0], "profiled_step_ms": windows[1],
            "kernel_ms_per_step": dict(sorted(by_kind.items())),
            "busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / windows[0],
            "top_kernels_ms_per_step": {k[:100]: v for k, v in top}}


def step_profile(*, steps: int = 5, warmup: int = 3, config=CFG,
                 batch: int = BATCH, seq: int = SEQ, device="cuda") -> dict:
    """Where the fused step's time goes (``device_split`` by ``_KINDS``)."""
    set_sdpa_impl("flash")
    try:
        model = build(config, device=device)
        opt = make_optimizer(1e-4)
        step = make_train_step(fused_loss, opt)
        state = create_train_state(model, opt)
        data = make_batch(config, batch, seq, device=device)

        def run(n):
            for _ in range(n):
                step(state, data)

        run(warmup)
        return device_split(run, steps=steps, device=device)
    finally:
        set_sdpa_impl("auto")


def model_flops_per_token(n_params: int, config=CFG, seq: int = SEQ):
    """6N (forward + backward matmuls) plus the causal attention score and
    value products, ``12 * layers * seq * hidden`` (the JAX bench's
    count)."""
    return 6 * n_params + 12 * config.num_hidden_layers * seq * \
        config.hidden_size


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--profile", action="store_true",
                    help="add the fused step's device time by kind")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("vyomai_tpu_torch.bench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    naive = train(False, steps=args.steps)
    torch.cuda.empty_cache()
    fused = train(True, steps=args.steps)
    mfu = (model_flops_per_token(fused["n_params"]) * fused["tokens_per_s"]
           / H100_PEAK_BF16)
    extra = {}
    if args.profile:
        torch.cuda.empty_cache()
        extra["step_profile"] = step_profile()
    print(json.dumps({
        "metric": "clm_train_tokens_per_sec_per_chip",
        "value": fused["tokens_per_s"],
        "unit": "tokens/s",
        "vs_baseline": fused["tokens_per_s"] / naive["tokens_per_s"],
        "mfu": mfu,
        "naive_tokens_per_s": naive["tokens_per_s"],
        "fused_ms_per_step": fused["ms_per_step"],
        "fused_peak_bytes": fused["peak_bytes"],
        "naive_peak_bytes": naive["peak_bytes"],
        "device": torch.cuda.get_device_name(0),
        **extra,
    }))


if __name__ == "__main__":
    main()
