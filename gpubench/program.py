"""What the benchmark takes from the program under test,
``vyomai_tpu_torch``: its model (through the configuration's family),
quantizer, serving engine and ``generate_hf``, built from a configuration
file and seeded weights.

``precision="control"`` builds the configuration's ``control``: the
program's own path one precision step lower (its quantized weights and
pool), which the check of ``correct`` has to fail.
"""

import torch

from . import spec, weights as W

POOL_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
               "int8": torch.int8, "int4": "int4"}


def precision(cfg: dict, which: str) -> dict:
    """``{"weights": {...}, "pool": {...}}`` as the program runs them."""
    if which == "program":
        return {"weights": cfg["weights"], "pool": cfg["pool"]}
    if which == "control":
        return {"weights": dict(cfg["weights"], **cfg["control"]["weights"]),
                "pool": dict(cfg["pool"], **cfg["control"]["pool"])}
    raise ValueError(f"precision {which!r}: program or control")


@torch.no_grad()
def build_model(cfg: dict, seed: int, device, which: str = "program"):
    """The family's port model (``families/<name>.py``) holding the seeded
    weights, made on ``device`` one group (one buffer) at a time, then
    quantized as the configuration says."""
    from vyomai_tpu_torch import quantize_model
    prec = precision(cfg, which)
    w = prec["weights"]
    dtype = W.DTYPES[w["dtype"]]
    fam = spec.family(cfg)
    model = fam.port_model(cfg, device, dtype)
    for group in fam.groups(cfg):
        for name, t in W.make_group(cfg, seed, group, device, dtype,
                                    w["init_std"]).items():
            model.get_parameter(name).data = t
    if w.get("quant"):
        quantize_model(model, bits=w["quant"]["bits"],
                       group_size=w["quant"].get("group_size", 128))
    return model


def pool_dtype(cfg: dict, which: str = "program"):
    return POOL_DTYPES[precision(cfg, which)["pool"]["dtype"]]
