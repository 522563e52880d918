"""Model families: one module per family, ``families/<name>.py``, found by
the name under a configuration's top-level ``"family"`` key (``dense``
where it has none; ``spec.family``). Each declares:

- ``port_model(cfg, device, dtype)``: the program's model object, its
  weights not yet filled;
- ``groups(cfg)`` and ``shapes(cfg, group)``: the seeded weight layout,
  ``(name, shape, is_norm)`` of each group's tensors under the port's
  module paths, one buffer a group (``weights.make_group``);
- ``served_gaps(cfg, seed, seqs, device, *, weight_dtype, std, quant,
  head_rows)``: the family's plain float32 reference
  (``reference/<name>.py``), in plain ``torch``, importing neither JAX nor
  anything of the program;
- ``linears(cfg)``: the ``(n_out, k_in)`` of every matmul weight that one
  token passes through, the head last;
- ``attn_layers(cfg)``: how many layers hold KV and run attention.
"""
