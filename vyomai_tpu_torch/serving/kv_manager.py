"""Host-side paged-KV block manager with radix-tree prefix caching
(counterpart of ``vyomai_tpu.serving.kv_manager``, the port's own copy:
``PagedKVManager``, ``SequenceState``, ``RadixNode``; standard library
only, behaviour identical).

Pure host bookkeeping (free lists, radix tree, LRU); the device side is
the preallocated pool in ``serving.paged_model``. Block identity is a pool
index; the radix tree is keyed by block-sized token tuples so a shared
prompt prefix maps to shared (ref-counted) blocks.

Ownership protocol:
- ``match_prefix`` returns cached blocks for the longest whole-block prefix
  and *acquires a reference* on each matched node; the sequence records the
  matched nodes.
- blocks past the match are *owned* by the sequence (from the free list or
  LRU eviction).
- ``free`` releases the matched references, promotes the sequence's full
  owned blocks into the radix tree (refcount 0 -> immediately evictable,
  reusable by future prompts), and returns the partial tail block to the
  free list.
"""

from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence


class RadixNode:
    __slots__ = ("children", "block", "refcount", "parent", "key")

    def __init__(self, parent=None, key=None, block: Optional[int] = None):
        self.children: Dict[tuple, "RadixNode"] = {}
        self.block = block
        self.refcount = 0
        self.parent = parent
        self.key = key


class SequenceState:
    """Per-request state: token ids, block table, decode position."""

    def __init__(self, seq_id: int, prompt: Sequence[int]):
        self.seq_id = seq_id
        self.tokens: List[int] = list(prompt)
        self.prompt_len = len(prompt)
        # radix-key namespace: KV depends on more than token ids when the
        # engine serves per-request adapters (multi-LoRA), so requests with
        # different adapters must never share cached prefixes — the engine
        # sets a per-adapter salt that shifts every radix key token
        # (key = token + salt), splitting the tree into disjoint namespaces
        self.cache_salt: int = 0
        # tokens that must run through prefill on (re-)admission; equals
        # prompt_len initially, grows to len(tokens) after a preemption so
        # generated tokens' KV is recomputed (vLLM-style recompute policy)
        self.prefill_len = len(prompt)
        self.block_table: List[int] = []
        self.cached_nodes: List[RadixNode] = []   # matched radix nodes
        self.num_cached_tokens = 0                # tokens covered by them
        self.finished = False
        # sliding-window serving: True once out-of-window blocks were freed
        # (the block table then contains -1 holes and the sequence must not
        # deposit into the radix cache — its chunk->block chain is broken)
        self.has_holes = False
        # radix bypass: the sequence neither matches nor deposits cached
        # prefixes. Set by the engine when sharing is impossible by
        # construction (unique image, media_key=None) or when the interned
        # media-salt namespace is exhausted — never sharing is always sound.
        self.no_radix = False

    def __len__(self):
        return len(self.tokens)


def _chunks(tokens: Sequence[int], block_size: int, salt: int = 0):
    for i in range(0, len(tokens) - block_size + 1, block_size):
        yield tuple(t + salt for t in tokens[i:i + block_size])


class PagedKVManager:
    """Block pool free-list + radix prefix cache + LRU eviction."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.free_blocks = deque(range(num_blocks))
        self.radix_root = RadixNode()
        # evictable leaves: block -> node, LRU order (oldest first)
        self.evictable: "OrderedDict[int, RadixNode]" = OrderedDict()
        # radix blocks with refcount 0 (leaves AND interior nodes) — all are
        # reclaimable, interior ones transitively after their leaves
        self._idle_radix_blocks = 0
        # observability counters (mirrored in csrc/kv_manager.cc kvm_stats)
        self.radix_lookups = 0     # match_prefix calls
        self.radix_hits = 0        # lookups that matched >= 1 block
        self.radix_hit_blocks = 0  # total blocks served from the cache
        self.radix_evictions = 0   # blocks reclaimed from the radix tree

    def cache_stats(self) -> dict:
        """Radix-cache counters for ``engine.metrics()``."""
        return {"radix_lookups": self.radix_lookups,
                "radix_hits": self.radix_hits,
                "radix_hit_blocks": self.radix_hit_blocks,
                "radix_evictions": self.radix_evictions}

    # -- capacity -----------------------------------------------------------
    def num_free(self) -> int:
        return len(self.free_blocks) + self._idle_radix_blocks

    def blocks_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    # -- radix prefix cache ---------------------------------------------------
    def match_prefix(self, state: SequenceState) -> int:
        """Attach the longest cached whole-block prefix to ``state``.
        Returns the number of prompt tokens covered."""
        self.radix_lookups += 1   # no_radix counts as a (missed) lookup,
        if getattr(state, "no_radix", False):   # matching the native path
            state.num_cached_tokens = 0
            return 0
        node = self.radix_root
        for chunk in _chunks(state.tokens[:state.prefill_len],
                             self.block_size, state.cache_salt):
            child = node.children.get(chunk)
            if child is None:
                break
            self._acquire(child)
            state.cached_nodes.append(child)
            state.block_table.append(child.block)
            node = child
        # Never cover the entire prompt: at least one token must run through
        # prefill so the engine has logits to sample from.
        if state.cached_nodes and \
                len(state.cached_nodes) * self.block_size >= state.prefill_len:
            last = state.cached_nodes.pop()
            self._release(last)
            state.block_table.pop()
        state.num_cached_tokens = len(state.cached_nodes) * self.block_size
        if state.num_cached_tokens > 0:
            self.radix_hits += 1
        self.radix_hit_blocks += len(state.cached_nodes)
        return state.num_cached_tokens

    def peek_prefix(self, tokens: Sequence[int], salt: int = 0) -> int:
        """Longest cached prefix for a prospective prompt WITHOUT acquiring
        refs or touching LRU order — the scheduler's cache-aware-admission
        probe. Same never-cover-the-entire-prompt cap as ``match_prefix``."""
        node = self.radix_root
        covered = 0
        for chunk in _chunks(tokens, self.block_size, salt):
            child = node.children.get(chunk)
            if child is None:
                break
            node = child
            covered += self.block_size
        if covered >= len(tokens) and len(tokens) > 0:
            covered -= self.block_size
        return max(covered, 0)

    def _acquire(self, node: RadixNode):
        if node.refcount == 0:
            self._idle_radix_blocks -= 1
        node.refcount += 1
        self.evictable.pop(node.block, None)

    def _release(self, node: RadixNode):
        node.refcount -= 1
        if node.refcount == 0:
            self._idle_radix_blocks += 1
            if not node.children:
                self.evictable[node.block] = node
                self.evictable.move_to_end(node.block)

    def _evict_one(self) -> Optional[int]:
        while self.evictable:
            block, node = self.evictable.popitem(last=False)
            if node.refcount > 0 or node.children:
                continue  # stale entry
            if node.parent is not None:
                del node.parent.children[node.key]
                # parent may become an evictable leaf now
                p = node.parent
                if p is not self.radix_root and p.refcount == 0 \
                        and not p.children:
                    self.evictable[p.block] = p
            self._idle_radix_blocks -= 1
            self.radix_evictions += 1
            return block
        return None

    # -- allocation -----------------------------------------------------------
    def allocate_block(self) -> Optional[int]:
        if self.free_blocks:
            return self.free_blocks.popleft()
        return self._evict_one()

    def allocate(self, state: SequenceState, num_tokens: int) -> bool:
        """Grow ``state.block_table`` to cover ``num_tokens`` tokens.
        All-or-nothing; returns False if the pool is exhausted."""
        need = self.blocks_needed(num_tokens) - len(state.block_table)
        if need > self.num_free():
            # Pre-check before touching the radix cache: the eviction loop
            # below destroys cached entries as it reclaims them, so a
            # doomed allocation must not run it — one failed admission
            # would wipe the whole reusable prefix cache (code-review r2).
            return False
        got = []
        for _ in range(max(need, 0)):
            b = self.allocate_block()
            if b is None:
                self.free_blocks.extend(got)
                return False
            got.append(b)
        state.block_table.extend(got)
        return True

    def release_sequence(self, state: SequenceState):
        """Rollback for failed admission: drop matched references and
        return owned blocks to the free list (nothing is cached)."""
        for node in state.cached_nodes:
            self._release(node)
        self.free_blocks.extend(
            b for b in state.block_table[len(state.cached_nodes):]
            if b >= 0)
        state.block_table = []
        state.cached_nodes = []
        state.num_cached_tokens = 0

    def release_prewindow(self, state: SequenceState,
                          first_live_block: int,
                          keep_blocks: int = 0) -> int:
        """Sliding-window serving memory reclaim: free this sequence's
        OWNED blocks strictly before ``first_live_block`` — positions no
        future step of this sequence can attend (the band only moves
        forward). The first ``keep_blocks`` blocks (attention sinks) and
        radix-cached prefix blocks are never touched. Freed table entries
        become ``-1`` holes: reads never reach them (the decode kernel
        starts at the band; the XLA fallback masks), writes only target
        the current position, and a holed sequence is excluded from radix
        deposit. Returns the number of blocks freed."""
        start = max(len(state.cached_nodes), keep_blocks)
        freed = 0
        for i in range(start, min(first_live_block,
                                  len(state.block_table))):
            b = state.block_table[i]
            if b >= 0:
                self.free_blocks.append(b)
                state.block_table[i] = -1
                freed += 1
        if freed:
            state.has_holes = True
        return freed

    def free(self, state: SequenceState, *, cache_prefix: bool = True):
        """Release a finished sequence's blocks (see ownership protocol)."""
        n_cached = len(state.cached_nodes)
        for node in state.cached_nodes:
            self._release(node)
        if getattr(state, "has_holes", False) or \
                getattr(state, "no_radix", False):
            # holes: the chunk->block chain is broken; no_radix: the engine
            # ruled out sharing for this sequence — never deposit either way
            cache_prefix = False
        owned = [b for b in state.block_table[n_cached:] if b >= 0]
        # Only tokens whose KV was actually WRITTEN may be cached: the
        # engine appends each sampled token before the step that writes its
        # KV, so a finished sequence's final token has no pool entry —
        # promoting its block would poison the radix cache and break
        # engine-greedy == dense-greedy (code-review r2).
        n_written = max(len(state.tokens) - 1, 0)
        n_full = n_written // self.block_size
        owned_full = owned[:max(n_full - n_cached, 0)]
        tail = owned[max(n_full - n_cached, 0):]

        if cache_prefix and owned_full:
            node = self.radix_root
            chunks = list(_chunks(state.tokens, self.block_size,
                                  state.cache_salt))
            # walk through the cached part
            walk_ok = True
            for chunk in chunks[:n_cached]:
                child = node.children.get(chunk)
                if child is None:
                    walk_ok = False
                    break
                node = child
            if not walk_ok:
                # defensive (unreachable while cached nodes are
                # ref-protected): a broken walk must NOT re-root the
                # insertion — mid-sequence chunks keyed at depth 0 would
                # match future prompts' first blocks with wrong-position
                # KV. Skip caching instead.
                self.free_blocks.extend(owned_full)
                owned_full = []
            # insert owned full blocks
            for chunk, block in zip(chunks[n_cached:], owned_full):
                child = node.children.get(chunk)
                if child is None:
                    child = RadixNode(parent=node, key=chunk, block=block)
                    node.children[chunk] = child
                    self._idle_radix_blocks += 1
                    self.evictable[block] = child
                    self.evictable.move_to_end(block)
                    # parent is no longer an evictable leaf (still idle)
                    if node is not self.radix_root:
                        self.evictable.pop(node.block, None)
                else:
                    # this prefix is already cached elsewhere: drop duplicate
                    self.free_blocks.append(block)
                node = child
        else:
            self.free_blocks.extend(owned_full)
        self.free_blocks.extend(tail)
        state.block_table = []
        state.cached_nodes = []
