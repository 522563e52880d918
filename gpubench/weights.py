"""Seeded random weights, made on the device, for every model family.

The weights come in groups, which the configuration's family lays out
(``families/<name>.py``: ``groups`` and ``shapes``, under the port's
module paths; the dense family's are the token table, each decoder layer,
the final norm and, untied, the head). Each group is one buffer filled by
one ``normal_`` call of a ``torch.Generator`` on the device, seeded from
the run seed and the group's index, so any group can be made again alone:
the program gets every group at set-up, the plain reference makes them
again one layer at a time. Matrices are views of the buffer (normal, std
``init_std``); norm weights are ``1 + 5 x`` of their slice of it, so a
fault that drops a norm's weight shows.
"""

from typing import Dict

import numpy as np
import torch

from . import spec

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def group_seed(seed: int, index: int) -> int:
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, index])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


@torch.no_grad()
def make_group(cfg: dict, seed: int, group: str, device,
               dtype=torch.bfloat16, std: float = 0.02
               ) -> Dict[str, torch.Tensor]:
    """One group's tensors: one buffer, one ``normal_`` call."""
    fam = spec.family(cfg)
    index = fam.groups(cfg).index(group)
    layout = fam.shapes(cfg, group)
    total = sum(int(np.prod(s)) for _, s, _ in layout)
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, index))
    buf = torch.empty(total, dtype=dtype, device=device)
    buf.normal_(0.0, std, generator=gen)
    out, off = {}, 0
    for name, shape, is_norm in layout:
        n = int(np.prod(shape))
        t = buf[off:off + n].view(shape)
        out[name] = 1.0 + 5.0 * t if is_norm else t
        off += n
    return out
