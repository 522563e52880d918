"""Paged-KV model execution for the serving engine (counterpart of
``vyomai_tpu.serving.paged_model``).

Runs a ``models.qwen.ModelForCausalLM`` over the paged pool
``[L, NB, 2, BS, H_kv*D]``: prefill writes prompt K/V into pool blocks and
attends over cached prefix + suffix through the flash-forward kernel;
decode is a batched single-token step through the paged-decode kernel.

The pool is updated IN PLACE. Each layer's K/V writes go straight into the
``[L*NB, 2, BS, W]`` view of the pool (a view costs nothing), and both
attention kernels address it through layer-offset block tables: table
entry ``j >= 0`` of layer ``l`` becomes ``j + l*NB``, while ``-1`` entries
stay ``-1`` in prefill AND decode and are read as block 0 under the mask
(the JAX prefill offsets padded entries as well, leaving the context-length
mask alone to hide what they address).

A pool is a float tensor, or for the quantized pools of the JAX package a
dict ``{"kv": int8 [L, NB, 2, BS, W'], "scale": fp32 sidecar}`` (W' = H_kv*D
for int8 with scales ``[L, NB, 2, BS]``, H_kv*D/2 for int4 with scales
``[L, NB, 2, H_kv, BS]``). Prefill attends over ``gather_kv``'s dequantized
K/V, including the suffix it has just written, so the quantized path sees
its own quantization as JAX's does.

Linears, the token table and the tied head go through ``core.nn``'s module
dispatch, so a model from ``quant.quantize_model`` runs unchanged.
"""

from typing import Optional

import torch

from ..core import nn as cnn
from ..core.device import resolve_device
from ..core.masks import NEG_INF
from ..generation.sampling import _min_p_mask, _top_p_mask
from ..layers.modern import (lm_logits, mlp_residual, qkv_heads, rope_tables,
                             rotate)
from ..ops.flash_attention import flash_attention_fwd
from ..ops.paged_attention import gather_kv, write_kv
from ..ops.paged_decode import (paged_decode, paged_decode_int4,
                                paged_decode_int8)
from ..ops.quant_matmul import int4_matmul, int8_matmul


def init_pool(config, num_blocks: int, block_size: int,
              dtype=torch.bfloat16, device=None):
    """Combined K/V pool ``[L, NB, 2, BS, H_kv*D]`` (k row 0, v row 1), on
    the card unless ``device`` names another.

    ``dtype=torch.int8`` stores rows quantized at write time with one fp32
    scale per (layer, block, k/v, slot); ``dtype="int4"`` packs two values
    per byte with one scale per (row, kv head). Both return the dict of the
    module docstring, the scales initialised to 1 as in JAX."""
    device = resolve_device(device)
    h_kv = config.num_key_value_heads
    shape = (config.num_hidden_layers, num_blocks, 2, block_size,
             h_kv * config.head_dim)
    if dtype == "int4":
        return {"kv": torch.zeros(shape[:4] + (shape[4] // 2,),
                                  dtype=torch.int8, device=device),
                "scale": torch.ones(shape[:3] + (h_kv, block_size),
                                    dtype=torch.float32, device=device)}
    if dtype == torch.int8:
        return {"kv": torch.zeros(shape, dtype=torch.int8, device=device),
                "scale": torch.ones(shape[:4], dtype=torch.float32,
                                    device=device)}
    if dtype not in (torch.bfloat16, torch.float32, torch.float64):
        raise NotImplementedError(f"pool dtype {dtype}: float, torch.int8 "
                                  'or "int4"')
    return torch.zeros(shape, dtype=dtype, device=device)


def pool_parts(pool):
    """``(kv [L, NB, 2, BS, W'], scales or None)`` of a pool."""
    if isinstance(pool, dict):
        return pool["kv"], pool["scale"]
    return pool, None


def pool_bytes(pool) -> int:
    return sum(t.numel() * t.element_size() for t in pool_parts(pool)
               if t is not None)


def _flat(pool):
    """The pool's ``[L*NB, ...]`` views (views cost nothing) and NB."""
    kv, sc = pool_parts(pool)
    nl, nb = kv.shape[:2]
    flat_sc = None if sc is None else sc.view(nl * nb, *sc.shape[2:])
    return kv.view(nl * nb, *kv.shape[2:]), flat_sc, nb


def _layer_tables(tables: torch.Tensor, layer: int, nb: int) -> torch.Tensor:
    return torch.where(tables >= 0, tables + layer * nb, tables)


def _multi_core(model, pool, ids, positions, slot_blocks, slot_offsets,
                block_tables, ctx_len) -> torch.Tensor:
    """Multi-token paged step: writes each token's K/V at its slot and
    attends causally-with-offset over the gathered paged context.

    ids/positions/slot_blocks/slot_offsets: [N, T] (slot -1 = padding or
    dead lane, write dropped); block_tables: [N, MAXB]; ctx_len: [N] total
    valid context (0 = dead lane). Returns final-normed hidden [N, T, Dm].
    """
    cfg = model.config
    n, t_pad = ids.shape
    flat_pool, flat_sc, nb = _flat(pool)
    bs = flat_pool.shape[2]
    nkv = cfg.num_key_value_heads
    maxb = block_tables.shape[1]
    hidden = cnn.apply_embedding(model.embed_tokens, ids)       # [N, T, Dm]

    # causal-with-offset additive mask over the gathered context
    k_pos = torch.arange(maxb * bs, device=ids.device)[None, None, :]
    ok = (k_pos <= positions[:, :, None]) & (k_pos < ctx_len[:, None, None])
    bias = torch.where(ok, 0.0, NEG_INF).to(torch.float32)[:, None]
    cos, sin = rope_tables(model, positions, hidden.dtype)      # [N,T,1,D]
    flat_blocks = slot_blocks.reshape(-1)
    flat_offsets = slot_offsets.reshape(-1)

    for layer_i, layer in enumerate(model.layers):
        normed = cnn.rms_norm(layer.input_layernorm.weight, hidden,
                              eps=cfg.rms_norm_eps)
        q, k, v = qkv_heads(layer.self_attn, cfg, normed, (n, t_pad))
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        write_kv(flat_pool, k.reshape(n * t_pad, nkv, -1),
                 v.reshape(n * t_pad, nkv, -1),
                 _layer_tables(flat_blocks, layer_i, nb), flat_offsets,
                 scales=flat_sc)
        tables = _layer_tables(block_tables, layer_i, nb).clamp_min(0)
        # [N, H_kv, MAXB*BS, D]; a quantized pool's come back dequantized
        # in fp32, and K1 attends q against them in (at least) fp32, as the
        # JAX prefill does: a bf16 q widens exactly, and the output returns
        # to q's dtype
        kk, vv = gather_kv(flat_pool, tables, nkv, flat_sc)
        qh = q.transpose(1, 2).contiguous()          # [N, H, T, D]
        acc = qh.dtype if flat_sc is None else torch.promote_types(
            qh.dtype, torch.float32)
        attn, _ = flash_attention_fwd(qh.to(acc), kk.to(acc).contiguous(),
                                      vv.to(acc).contiguous(), bias)
        attn = attn.to(qh.dtype).transpose(1, 2).reshape(n, t_pad, -1)
        hidden = hidden + cnn.apply_linear(layer.self_attn.o_proj, attn)
        hidden = mlp_residual(layer, cfg, hidden)
    return cnn.rms_norm(model.norm.weight, hidden, eps=cfg.rms_norm_eps)


@torch.no_grad()
def prefill(model, pool, ids, positions, slot_blocks, slot_offsets,
            block_tables, ctx_len, true_len) -> torch.Tensor:
    """Batched prefill of uncached prompt suffixes; writes ``pool`` in
    place. ids/positions/slot_blocks/slot_offsets: [N, T_pad];
    block_tables: [N, MAXB]; ctx_len/true_len: [N] (0 = dead lane).
    Returns last-real-token logits [N, V]."""
    hidden = _multi_core(model, pool, ids, positions, slot_blocks,
                         slot_offsets, block_tables, ctx_len)
    last = (true_len.long() - 1).clamp_min(0)
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    return lm_logits(model, hidden[rows, last])


@torch.no_grad()
def decode(model, pool, tokens, positions, block_tables, seq_lens,
           slot_blocks, slot_offsets) -> torch.Tensor:
    """Batched single-token decode; writes ``pool`` in place.

    tokens: [B]; positions: [B] absolute positions; block_tables: [B, MAXB]
    int32; seq_lens: [B] int32 context lengths incl. the new token;
    slot_blocks/slot_offsets: [B] write targets (-1 = dead lane).
    Returns logits [B, V]."""
    cfg = model.config
    b = tokens.shape[0]
    flat_pool, flat_sc, nb = _flat(pool)
    nkv = cfg.num_key_value_heads
    hidden = cnn.apply_embedding(model.embed_tokens, tokens)     # [B, Dm]
    cos, sin = rope_tables(model, positions, hidden.dtype)       # [B,1,D]
    for layer_i, layer in enumerate(model.layers):
        normed = cnn.rms_norm(layer.input_layernorm.weight, hidden,
                              eps=cfg.rms_norm_eps)
        q, k, v = qkv_heads(layer.self_attn, cfg, normed, (b,))
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        write_kv(flat_pool, k, v, _layer_tables(slot_blocks, layer_i, nb),
                 slot_offsets, scales=flat_sc)
        attn = paged_decode(q.contiguous(), flat_pool,
                            _layer_tables(block_tables, layer_i, nb),
                            seq_lens, nkv, scales=flat_sc)       # [B, H, D]
        hidden = hidden + cnn.apply_linear(layer.self_attn.o_proj,
                                           attn.reshape(b, -1))
        hidden = mlp_residual(layer, cfg, hidden)
    hidden = cnn.rms_norm(model.norm.weight, hidden, eps=cfg.rms_norm_eps)
    return lm_logits(model, hidden)


def sampling_tensors(device, temperature=1.0, top_p=1.0, min_p=0.0):
    """``(temperature, top_p, min_p)`` as fp32 tensors on ``device`` (scalars
    or ``[B]``), made once: :func:`sampling_mask` turns a Python number into
    a tensor on each call, a host-to-device copy that a captured step may
    not make."""
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in (temperature, top_p, min_p))


def sampling_mask(logits, temperature, top_p, min_p=0.0) -> torch.Tensor:
    """Temperature + nucleus (top-p) + min-p masked fp32 logits.
    ``temperature``/``top_p``/``min_p``: scalars or [B] per-lane."""
    def lane(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=logits.device)
        return x[:, None] if x.dim() == 1 else x

    logits = logits.to(torch.float32) / lane(temperature).clamp_min(1e-6)
    return _min_p_mask(_top_p_mask(logits, lane(top_p)), lane(min_p))


def sample_tokens(logits, generator: Optional[torch.Generator], temperature,
                  top_p, min_p=0.0) -> torch.Tensor:
    """Sample [B] int32 tokens from the masked distribution."""
    probs = torch.softmax(sampling_mask(logits, temperature, top_p, min_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


class _Carry:
    """A horizon's inputs and carry, as tensors updated in place: tokens
    ``[B]`` int32, positions ``[B]`` int64, tables ``[B, MAXB]`` int32,
    ``alive``/``eos_dead`` ``[B]`` bool, budget ``[B]`` int32, the step
    counter (a 0-d int64 tensor) and the output ``[B, horizon]`` int32."""

    def __init__(self, b: int, maxb: int, horizon: int, device):
        def zeros(*shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        self.tokens = zeros(b, dtype=torch.int32)
        self.pos = zeros(b, dtype=torch.int64)
        self.tables = torch.full((b, maxb), -1, dtype=torch.int32,
                                 device=device)
        self.alive = zeros(b, dtype=torch.bool)
        self.eos_dead = zeros(b, dtype=torch.bool)
        self.budget = zeros(b, dtype=torch.int32)
        self.step = zeros(dtype=torch.int64)
        self.out = zeros(b, horizon, dtype=torch.int32)
        self.lanes = torch.arange(b, device=device)

    def start(self, positions, tables, live, budget, tokens=None,
              dead_mask=None, non_blocking: bool = False):
        """Load a tick's inputs. ``tokens=None`` keeps the last tick's
        final tokens, the carry of a chained tick. ``dead_mask`` (the JAX
        argument: lanes an earlier chained tick killed by eos) is taken off
        ``live`` and seeds ``eos_dead``, so the flag accumulates across
        chained ticks; it may be ``self.eos_dead`` itself."""
        nb = non_blocking
        if tokens is not None:
            self.tokens.copy_(tokens, non_blocking=nb)
        self.pos.copy_(positions, non_blocking=nb)
        self.tables.copy_(tables, non_blocking=nb)
        self.budget.copy_(budget, non_blocking=nb)
        self.alive.copy_(live, non_blocking=nb)
        if dead_mask is None:
            self.eos_dead.zero_()
        elif dead_mask is not self.eos_dead:
            self.eos_dead.copy_(dead_mask, non_blocking=nb)
        self.alive &= ~self.eos_dead
        self.step.zero_()
        self.out.zero_()


def _step(model, pool, c: _Carry, do_sample: bool, eos: int, generator,
          samp) -> torch.Tensor:
    """One step of the horizon on ``c``, in place, with nothing read back
    to the host: a CUDA graph captures it as it is. A dead lane is a no-op:
    its write slot is -1 (dropped), its context length 0 (K4 gives 0), its
    token and position stay and its output is 0. Returns the step's logits
    [B, V]."""
    bs = pool_parts(pool)[0].shape[3]
    maxb = c.tables.shape[1]
    blk = c.tables[c.lanes, (c.pos // bs).clamp_max(maxb - 1)]
    slot_blocks = torch.where(c.alive, blk, -1)
    seq_lens = torch.where(c.alive, c.pos + 1, 0).to(torch.int32)
    logits = decode(model, pool, c.tokens, c.pos, c.tables, seq_lens,
                    slot_blocks, c.pos % bs)
    if do_sample:
        nxt = sample_tokens(logits, generator, *samp)
    else:
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    nxt = torch.where(c.alive, nxt, c.tokens)            # freeze dead lanes
    c.out.scatter_(1, c.step.expand(c.out.shape[0], 1),
                   torch.where(c.alive, nxt, 0)[:, None])
    # eos-death apart from the budget freeze: the next chained tick
    # revives a budget-frozen lane, never an eos'd one
    c.eos_dead |= c.alive & (nxt == eos)
    c.alive &= (nxt != eos) & (c.step + 1 < c.budget)
    c.pos.copy_(torch.where(c.alive, c.pos + 1, c.pos))
    c.tokens.copy_(nxt)
    c.step += 1
    return logits


@torch.no_grad()
def decode_horizon(model, pool, tokens, positions, block_tables, live,
                   horizon: int, do_sample: bool = False, eos: int = -1,
                   generator: Optional[torch.Generator] = None,
                   temperature=1.0, top_p=1.0, min_p=0.0, budget=None,
                   dead_mask=None, return_logits: bool = False):
    """Up to ``horizon`` decode steps per lane, run eagerly. The engine
    pre-allocates blocks for ``positions + budget`` so ``table[pos // BS],
    pos % BS`` always lands on a live block.

    Lanes that emit ``eos`` (-1 disables) or exhaust ``budget`` [B] go dead:
    their writes are dropped and their token/position freeze. The loop runs
    all ``horizon`` steps and reads nothing back: a dead lane's step
    changes nothing, so the tokens are those of the JAX ``while_loop``,
    which stops once every lane is dead (the engine's tick runs
    ``min(horizon, max budget)`` steps, a count its host knows).
    tokens/positions: [B] latest token and its position; live: [B] bool;
    ``dead_mask`` [B] bool: lanes an earlier chained tick killed by eos
    (JAX semantics: taken off ``live``, and seeding ``eos_dead``). Returns
    ``(generated [B, horizon] int32, final_tokens [B] int32, eos_dead [B]
    bool)`` (dead entries are 0), and with ``return_logits`` the last
    step's logits; ``(final_tokens, eos_dead)`` is the carry a chained tick
    starts from."""
    b, maxb = block_tables.shape
    c = _Carry(b, maxb, horizon, tokens.device)
    if budget is None:
        budget = torch.full((b,), horizon, dtype=torch.int32)
    c.start(positions, block_tables, live, budget, tokens=tokens,
            dead_mask=dead_mask)
    samp = sampling_tensors(tokens.device, temperature, top_p, min_p)
    logits = None
    for _ in range(horizon):
        logits = _step(model, pool, c, do_sample, eos, generator, samp)
    if return_logits:
        return c.out, c.tokens, c.eos_dead, logits
    return c.out, c.tokens, c.eos_dead


# the kernels' wrappers that a decode step may call, and their counters
_COUNTED = (paged_decode, paged_decode_int8, paged_decode_int4, int8_matmul,
            int4_matmul)


def _launch_counts() -> dict:
    return {(fn, name): getattr(fn, name) for fn in _COUNTED
            for name in ("launches", "tc_launches") if hasattr(fn, name)}


class HorizonGraph:
    """The engine's decode tick: :func:`decode_horizon`'s step over static
    buffers (a :class:`_Carry`) for ``batch`` lanes, ``max_blocks`` table
    entries and ``horizon`` steps, bound to one ``pool`` (updated in place,
    never reallocated, so the graph may hold its pointers).

    On a CUDA device the step is captured once as a CUDA graph at
    construction and a tick replays it ``n`` times: one launch of the graph
    a step, and no host work between steps. Before the capture the step
    runs once eagerly on the capture stream with every lane dead (its
    writes change nothing), so that whatever a first call creates exists
    when the capture starts: the kernels' library and their shared-memory
    attributes, cuBLAS's handle and workspace of that stream, the split-K
    workspace that ``ops.quant_matmul`` keys by (device, stream). The
    generator's state is registered with the graph, so each replay draws
    fresh numbers from it, and restored after the warm-up. A failed capture
    raises; there is no eager fallback on the card. On the CPU there is no
    graph, and :meth:`run` calls the same step eagerly.

    The kernels' wrappers count launches in Python, which a replay never
    calls: the counts the capture added are taken back and added once per
    replay instead (``per_replay``). ``logits`` holds the last step's
    logits (the graph's output buffer on the card)."""

    def __init__(self, model, pool, batch: int, max_blocks: int,
                 horizon: int, *, do_sample: bool = False, eos: int = -1,
                 generator: Optional[torch.Generator] = None, samp=None):
        device = pool_parts(pool)[0].device
        self.model, self.pool = model, pool
        self.do_sample, self.eos, self.generator = do_sample, eos, generator
        self.samp = samp if samp is not None else sampling_tensors(device)
        self.c = _Carry(batch, max_blocks, horizon, device)
        self.graph = None
        self.per_replay = {}
        self.logits = None
        if device.type == "cuda":
            self._capture(device)

    @torch.no_grad()
    def _step(self):
        self.logits = _step(self.model, self.pool, self.c, self.do_sample,
                            self.eos, self.generator, self.samp)

    def _capture(self, device):
        gen_state = None if self.generator is None else \
            self.generator.get_state()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            self._step()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = _launch_counts()
        with torch.cuda.graph(graph, stream=stream):
            self._step()
        for (fn, name), n in before.items():
            self.per_replay[(fn, name)] = getattr(fn, name) - n
            setattr(fn, name, n)          # the capture launched nothing
        torch.cuda.current_stream(device).wait_stream(stream)
        if gen_state is not None:
            self.generator.set_state(gen_state)
        self.graph = graph

    def start(self, positions, tables, live, budget, tokens=None,
              non_blocking: bool = False):
        """Load a tick (:meth:`_Carry.start`). ``tokens=None`` chains the
        tick from the last one's carry: its final tokens, and its
        ``eos_dead`` as the dead mask."""
        self.c.start(positions, tables, live, budget, tokens=tokens,
                     dead_mask=None if tokens is not None else self.c.eos_dead,
                     non_blocking=non_blocking)

    def run(self, n: int):
        """``n`` steps; returns ``(generated, final_tokens, eos_dead)``,
        the buffers themselves (the next tick overwrites them)."""
        for _ in range(n):
            if self.graph is None:
                self._step()
                continue
            self.graph.replay()
            for (fn, name), k in self.per_replay.items():
                setattr(fn, name, getattr(fn, name) + k)
        return self.c.out, self.c.tokens, self.c.eos_dead
