"""A tiny configuration and tiny mixes of the benchmark's shapes, for the
harness's CPU tests (float32, plain paths of the program)."""

import copy

from .. import spec

CONFIG = {
    "name": "tiny", "source": "tests", "hidden_size": 64,
    "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "max_position_embeddings": 512, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "tie_word_embeddings": True, "vocab_size": 256,
    "qk_norm": True, "pad_token_id": 0, "eos_token_id": 1,
    "weights": {"dtype": "float32", "init_std": 0.02, "quant": None},
    "pool": {"dtype": "float32"},
    "engine": {"max_batch": 4, "block_size": 4, "decode_horizon": 2,
               "prefill_group": 2, "prefill_buckets": [8, 16, 32],
               "radix_cache": True, "max_prefill_per_tick": 2},
    "reference": {"quant": None},
    "control": {"weights": {"quant": {"bits": 8}}, "pool": {"dtype": "int8"}},
}

MIXES = {
    "chat": {"entry": "engine", "kind": "open_loop", "base_seed": 3,
             "arrivals": {"process": "poisson", "rate_per_s": 12.0},
             "shared_prefix": {"count": 3, "length": {
                 "dist": "uniform", "min": 8, "max": 20},
                 "pick": {"dist": "zipf", "s": 1.1}},
             "prompt": {"dist": "lognormal", "median": 8, "sigma": 0.5,
                        "min": 2, "max": 24},
             "output": {"dist": "lognormal", "median": 6, "sigma": 0.5,
                        "min": 2, "max": 12}},
    "backlog": {"entry": "engine", "kind": "backlog", "base_seed": 4,
                "requests": 400, "depth": 4,
                "prompt": {"dist": "uniform", "min": 4, "max": 30},
                "output": {"dist": "lognormal", "median": 8, "sigma": 0.5,
                           "min": 4, "max": 16}},
    "calls": {"entry": "generate", "kind": "calls", "base_seed": 5,
              "calls": 3, "batch": 2, "prompt_len": 12, "new_tokens": 6},
}


def cell(mix: str, **config_changes) -> dict:
    """A cell dict as ``spec.cell`` returns it, over the tiny config."""
    cfg = copy.deepcopy(CONFIG)
    cfg.update(config_changes)
    bench = spec.benchmark()
    e2e = {"open_loop": ["ttft_p95_ms", "tpot_p95_ms"],
           "calls": ["generate_tok_s"]}.get(
        MIXES[mix]["kind"], ["output_tok_s"]) + ["setup_s"]
    mods = spec.e2e_metrics()      # a metric no cell reports yet too
    return {"name": f"tiny.{mix}", "chips": 1, "config": cfg,
            "traffic": copy.deepcopy(MIXES[mix]),
            "end_to_end": [{"name": n, "unit": mods[n].UNIT} for n in e2e],
            "per_layer": [m for m in bench["per_layer"]
                          if m["source"] == "program_counter"]}
