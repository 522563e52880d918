"""Encoder-family benchmark of the port on one NVIDIA card: right-padded
masked-LM training and ViT classification, on the ``"auto"`` route (the
short-attention kernels K5/K6/K7) against the forced ``"xla"`` route
(full-matrix attention). The port's counterpart of the JAX package's
``benchmarks/encoder_train_bench.py``.

    python -m vyomai_tpu_torch.encoder_bench [--part mlm|vit|all] [--profile]

- MLM: RoBERTa-base as ``EncoderConfig``'s defaults give it at 12 layers
  (hidden 768, 12 heads, FFN 3072, vocab 50,265, 514 positions, pad id 1,
  absolute positions, no dropout), bf16, AdamW (lr 1e-4, warmup 10), on
  right-padded batches whose lengths are uniform in [S/2, S], at S=128 with
  B=64 and S=512 with B=16; CE over the valid positions. Reports train and
  forward tokens/s (real tokens), peak memory and, with ``--profile``, the
  train step's device-time split.
- ViT: ViT-base/16 (``VisionConfig(num_hidden_layers=12,
  hidden_dropout_prob=0.0)``: 224 px, L = 197), bf16: forward img/s at
  B=128, train img/s at B=32 with a zero-initialised 1000-class head on the
  CLS token and AdamW.

Each part prints one JSON line with the JAX bench's fields (``short_*`` is
the ``"auto"`` route, ``xla_*`` the ``"xla"`` route), the kernels' launches
in the timed train window, and the card's name. Weights and data are random
from fixed seeds. Needs a CUDA device; the functions also run on the CPU at
a tiny width for the tests, where every time is the CPU's.
"""

import argparse
import json
import time

import numpy as np
import torch
from torch import nn

from . import bench
from .config import EncoderConfig, VisionConfig
from .layers.attention import set_sdpa_impl
from .models.encoder import EncoderForMaskedLM
from .models.vision import Vit
from .ops import short_attention as sa
from .ops.fused import cross_entropy
from .training import create_train_state, make_optimizer, make_train_step

MLM_CFG = EncoderConfig(num_hidden_layers=12, hidden_dropout_prob=0.0)
VIT_CFG = VisionConfig(num_hidden_layers=12, hidden_dropout_prob=0.0)
MLM_SHAPES = ((128, 64), (512, 16))      # (S, B)
VIT_BATCH, VIT_TRAIN_BATCH, VIT_CLASSES = 128, 32, 1000
KERNELS = (sa.short_attention_fwd, sa.short_attention_qkv_fwd,
           sa.short_attention_bwd)
KINDS = (("K5/K6 short_fwd", ("short_fwd_kernel",)),
         ("K7 short_bwd", ("short_bwd_",)),
         bench._KINDS[-1])                # cuBLAS/CUTLASS/cuDNN products
ROUTES = (("short", "auto"), ("xla", "xla"))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _seconds(fn, n: int, device) -> float:
    """Wall time per call of ``fn`` over ``n`` calls, ending in a sync."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / n


def _peak_reset(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return None


def _train(model, loss_fn, data, *, steps, warmup, device, profile):
    """``warmup`` then ``steps`` timed AdamW steps (lr 1e-4, warmup 10) on
    one batch. Returns every loss, seconds per step, the kernels'
    launches in the timed window and, with ``profile``, the step's
    device-time split."""
    opt = make_optimizer(1e-4, warmup_steps=10)
    step = make_train_step(loss_fn, opt)
    state = create_train_state(model, opt)
    losses = []

    def run(n):
        for _ in range(n):
            losses.append(step(state, data)[1]["loss"])

    run(warmup)
    before = [fn.launches for fn in KERNELS]
    dt = _seconds(lambda: run(1), steps, device)
    launches = {fn.__name__: fn.launches - b
                for fn, b in zip(KERNELS, before)}
    split = None
    if profile:
        split = bench.device_split(run, steps=min(steps, 5), kinds=KINDS,
                                   device=device)
    return (torch.stack(losses[:warmup + steps]).float().tolist(), dt,
            launches, split)


def mlm_batch(config, seq: int, batch: int, *, device, seed: int = 0):
    """Right-padded ids and mask (lengths uniform in [S/2, S]) and the
    number of real tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, config.vocab_size - 10, size=(batch, seq))
    lens = rng.integers(seq // 2, seq + 1, size=batch)
    mask = np.arange(seq)[None, :] < lens[:, None]
    return ({"ids": torch.from_numpy(ids).to(device),
             "mask": torch.from_numpy(mask.astype(np.int64)).to(device)},
            int(lens.sum()))


def mlm_loss(model, batch, generator=None):
    """CE of the MLM logits against the inputs over the valid positions
    (labels = inputs, a speed bench's objective)."""
    out = model(batch["ids"], batch["mask"])
    labels = torch.where(batch["mask"] > 0, batch["ids"], -100)
    return cross_entropy(out.logits, labels), {}


def bench_mlm(seq: int, batch: int, *, config=MLM_CFG, steps: int = 10,
              warmup: int = 3, fwd_reps: int = 8, device="cuda",
              dtype=torch.bfloat16, profile: bool = False) -> dict:
    data, real = mlm_batch(config, seq, batch, device=device)
    rec = {"metric": "masked_encoder_train", "seq": seq, "batch": batch,
           "real_tokens": real}
    for label, impl in ROUTES:
        set_sdpa_impl(impl)
        try:
            model = EncoderForMaskedLM(config, "absolute", device=device,
                                       dtype=dtype)
            model.init(torch.Generator(device=device).manual_seed(1))
            with torch.no_grad():
                def fwd():
                    model(data["ids"], data["mask"]).logits[..., :8].float(
                        ).sum()
                fwd()
                t_fwd = _seconds(fwd, fwd_reps, device)
            _peak_reset(device)
            losses, dt, launches, split = _train(
                model, mlm_loss, data, steps=steps, warmup=warmup,
                device=device, profile=profile and label == "short")
        finally:
            set_sdpa_impl("auto")
        rec[f"{label}_tokens_per_sec"] = real / dt
        rec[f"fwd_{label}_tokens_per_sec"] = real / t_fwd
        rec[f"{label}_step_ms"] = dt * 1e3
        rec[f"{label}_peak_bytes"] = _peak(device)
        rec[f"{label}_losses"] = losses
        rec[f"{label}_launches"] = launches
        if split is not None:
            rec["step_profile"] = split
        del model
    rec["speedup"] = rec["short_tokens_per_sec"] / rec["xla_tokens_per_sec"]
    rec["fwd_speedup"] = (rec["fwd_short_tokens_per_sec"]
                          / rec["fwd_xla_tokens_per_sec"])
    return rec


class VitClassifier(nn.Module):
    """``vit`` and a linear ``head`` on the CLS token."""

    def __init__(self, config, n_classes: int, *, device, dtype):
        super().__init__()
        self.vit = Vit(config, device=device, dtype=dtype)
        self.head = nn.Linear(config.hidden_size, n_classes, device=device,
                              dtype=dtype)

    def forward(self, images):
        return self.head(self.vit(images).logits[:, 0])


def vit_loss(model, batch, generator=None):
    return cross_entropy(model(batch["images"]), batch["labels"]), {}


def bench_vit(*, config=VIT_CFG, batch: int = VIT_BATCH,
              train_batch: int = VIT_TRAIN_BATCH,
              n_classes: int = VIT_CLASSES, steps: int = 10,
              warmup: int = 3, fwd_reps: int = 8, device="cuda",
              dtype=torch.bfloat16, profile: bool = False) -> dict:
    rng = np.random.default_rng(0)
    h, w = config.image_size
    images = torch.from_numpy(rng.standard_normal(
        (batch, config.num_channels, h, w), np.float32)).to(device, dtype)
    data = {"images": images[:train_batch],
            "labels": torch.from_numpy(rng.integers(
                0, n_classes, train_batch)).to(device)}
    rec = {"metric": "vit_train", "batch": batch,
           "train_batch": train_batch}
    for label, impl in ROUTES:
        set_sdpa_impl(impl)
        try:
            model = VitClassifier(config, n_classes, device=device,
                                  dtype=dtype)
            model.vit.init(torch.Generator(device=device).manual_seed(1))
            with torch.no_grad():
                model.head.weight.zero_()
                model.head.bias.zero_()

                def fwd():
                    model.vit(images).logits.float().sum()
                fwd()
                t_fwd = _seconds(fwd, fwd_reps, device)
            _peak_reset(device)
            losses, dt, launches, split = _train(
                model, vit_loss, data, steps=steps, warmup=warmup,
                device=device, profile=profile and label == "short")
        finally:
            set_sdpa_impl("auto")
        rec[label] = {"fwd_img_s": batch / t_fwd,
                      "train_img_s": train_batch / dt, "step_ms": dt * 1e3,
                      "peak_bytes": _peak(device), "losses": losses,
                      "launches": launches}
        if split is not None:
            rec["step_profile"] = split
        del model
    rec["train_speedup"] = (rec["short"]["train_img_s"]
                            / rec["xla"]["train_img_s"])
    rec["fwd_speedup"] = rec["short"]["fwd_img_s"] / rec["xla"]["fwd_img_s"]
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("mlm", "vit", "all"), default="all")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--profile", action="store_true",
                    help="add the short route's train-step device split")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("vyomai_tpu_torch.encoder_bench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench.card()
    print(card, flush=True)
    runs = []
    if args.part in ("mlm", "all"):
        runs += [lambda s=seq, b=b: bench_mlm(s, b, steps=args.steps,
                                              profile=args.profile)
                 for seq, b in MLM_SHAPES]
    if args.part in ("vit", "all"):
        runs.append(lambda: bench_vit(steps=args.steps,
                                      profile=args.profile))
    for run in runs:
        print(json.dumps({**run(), "device": torch.cuda.get_device_name(0),
                          "card": card}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
