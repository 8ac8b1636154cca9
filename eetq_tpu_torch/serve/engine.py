"""Continuous-batching serving engine (slot-based), single-device, over a
dense or a paged KV cache.

Port of `eetq_tpu/serve/engine.py::Engine` with its local backend.
Requests arrive at any time; each scheduler step admits queued requests
into free slots (one grouped prefill of up to `prefill_rows` prompts,
right-padded to a length bucket, its KV rows inserted into the slots and
its first tokens sampled, as `_prefill_commit` does at engine.py:97-136),
then advances every active slot by a decode window of lock-step steps over
the fixed [max_batch] slot array. Inactive slots decode garbage at a safe
position that is never committed. Finished slots are recycled at once.

The decode window (engine.py:1345-1448): `decode_window` steps run as one
program whose tokens come back in one host fetch; the window is 1 while a
queued request could be admitted next step. When the batch is full, the
queue empty and no active request has an eos, up to `max_chain` windows run
back to back with their carry on the device and one fetch at the end.
Tokens past a slot's budget are discarded, and the cache writes of those
extra steps are clamped at the cache's capacity (`modules/attention.py`,
`modules/paged.py`), as JAX's are. Each (window, sampled) program is a
`serve/graph.py::StepGraph` over the engine's static buffers: on the card a
captured CUDA graph, replayed once a window; on the CPU the same steps run
eagerly. The window defaults to 8 on a CUDA device and to 1 on the CPU
(JAX's "8 on the TPU", engine.py:737-739).

The KV caches are preallocated [max_batch, max_len] buffers updated in
place with per-row offsets. On a CUDA device, for a quantized model, the
engine defaults to W8A8 prefill and, for max_len >= 512, an int8 KV cache
(engine.py:686-696, where JAX asks for a TPU); on the CPU both default
off, and a caller may pass either.

With `paged_blocks=N` the decode caches are a shared pool of N blocks of
`paged_block_size` tokens per layer (`modules/paged.py`): slots borrow
blocks as their sequences grow and return them when they retire, so device
memory follows the live tokens, not max_batch x max_len. Block 0 is a trash
block that is never granted: the table rows of idle slots point at it, and
their lock-step writes land there. The allocator runs on the host
(`_alloc_blocks`, `_release_blocks`); a window's blocks (its overshoot
included) are granted before it runs, and the one device table shared by
all layers is refreshed outside the graph by a single copy when it changed
(`_sync_tables`). Prefill still runs on the dense scratch and is handed off
block by block. A paged engine keeps a bf16 pool unless the caller passes
`kv_dtype` (engine.py:690-696).

Outputs are reproducible run to run (the sampler draws Gumbel noise from a
device stream seeded from `seed`, `serve/sampling.py`), greedy outputs do
not depend on the window or the chain, and on the CPU they equal `prefill`
followed by `decode_loop` with the same options (the property
engine.py:21-22 states for JAX).

Later work, which raises NotImplementedError here: `prefill_chunk`,
`spec_ngram`, banked LoRA and a sharded model.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque

import numpy as np
import torch

from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.transformer import ModelParams, forward_inner, init_caches
from eetq_tpu_torch.modules.linear import QuantLinear
from eetq_tpu_torch.modules.paged import init_paged_kv_cache, paged_insert_rows
from eetq_tpu_torch.serve.graph import StepGraph
from eetq_tpu_torch.serve.sampling import rng_state, sample_rows
from eetq_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

DEFAULT_BUCKETS = (32, 128, 512, 1024, 2048)


@dataclasses.dataclass
class Request:
    """One generation request and its accumulated output."""

    uid: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    eos_token_id: int | None = None
    lora_id: int = 0
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # streaming: callback fired per committed token, and the poll cursor
    # (index into out_tokens of the first not-yet-polled token)
    on_token: object = None
    polled: int = 0


class Engine:
    """Continuous-batching generation engine over one model.

    Usage:
        eng = Engine(params, cfg, max_batch=8, max_len=2048)
        uid = eng.add_request([1, 2, 3], max_new_tokens=32)
        eng.run()                      # or step() incrementally
        tokens = eng.result(uid)
    """

    def __init__(
        self,
        params: ModelParams,
        cfg: ModelConfig | None = None,
        max_batch: int = 8,
        max_len: int = 2048,
        prompt_buckets: tuple[int, ...] = DEFAULT_BUCKETS,
        kv_dtype: torch.dtype | None = None,
        seed: int = 0,
        a8_prefill: bool | None = None,
        decode_window: int | None = None,
        prefill_rows: int | None = None,
        prefill_chunk: int | None = None,
        paged_blocks: int | None = None,
        paged_block_size: int = 256,
        topk_cap: int = 64,
        max_chain: int = 8,
        spec_ngram: int | None = None,
    ):
        if cfg is None:
            raise NotImplementedError("a sharded model has no engine backend in the port yet")
        if spec_ngram is not None:
            raise NotImplementedError("n-gram speculative decoding is not ported yet")
        if prefill_chunk is not None:
            raise NotImplementedError("chunked prefill is not ported yet")
        self.device = params.embed.device
        # the accelerator defaults of engine.py:686-696, asked of the
        # parameters' device
        on_cuda = self.device.type == "cuda"
        quantized = bool(params.layers) and isinstance(params.layers[0].qkv, QuantLinear)
        if a8_prefill is None:
            a8_prefill = on_cuda and quantized
        if kv_dtype is None:
            kv_dtype = (torch.int8 if on_cuda and quantized and paged_blocks is None
                        and max_len >= 512 else torch.bfloat16)
        if decode_window is None:
            decode_window = 8 if on_cuda else 1
        self.decode_window = max(1, int(decode_window))
        # back-to-back windows a step at most (window * max_chain tokens
        # between host fetches; step()'s chaining rules)
        self.max_chain = max(1, int(max_chain))
        self.a8_prefill = bool(a8_prefill)
        self.prefill_rows = 1 if prefill_rows is None else max(1, min(prefill_rows, max_batch))
        if max_batch % self.prefill_rows:
            raise ValueError(f"max_batch {max_batch} must divide by prefill_rows "
                             f"{self.prefill_rows}")
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = min(max_len, cfg.max_position)
        self.buckets = tuple(sorted(b for b in prompt_buckets if b <= self.max_len)) or (
            self.max_len,)
        self.kv_dtype = kv_dtype
        self.paged = paged_blocks is not None
        if self.paged:
            bs = paged_block_size
            if paged_blocks < 2:
                raise ValueError("paged_blocks must be >= 2")
            if bs > -(-self.max_len // 128) * 128:
                raise ValueError(f"paged_block_size {bs} exceeds the (rounded) max_len")
            self.paged_bs = bs
            self._max_seq_blocks = -(-self.max_len // bs)
            # the host's copy of the block table, and the one device table
            # every layer's cache holds
            self._table_np = np.zeros((max_batch, self._max_seq_blocks), np.int32)
            self._table = torch.zeros((max_batch, self._max_seq_blocks), dtype=torch.int32,
                                      device=self.device)
            self._table_dirty = False
            self.caches = [
                init_paged_kv_cache(paged_blocks, bs, cfg.num_kv_heads, cfg.head_dim, max_batch,
                                    self._max_seq_blocks, kv_dtype, self.device, self._table)
                for _ in range(cfg.num_layers)
            ]
            # block 0 is the trash block, never granted; the list is popped
            # from its end, so blocks go out in ascending order
            self._free_blocks = list(range(paged_blocks - 1, 0, -1))
            self._slot_blocks: list[list[int]] = [[] for _ in range(max_batch)]
        else:
            self.caches = init_caches(cfg, max_batch, self.max_len, self.device, kv_dtype)
        self._scratch = None  # reused prefill scratch caches
        self._scratch_len = 0
        self.topk_cap = int(topk_cap)
        self._rng = rng_state(seed, self.device)
        # the decode programs' static inputs: next token, length and top-k of
        # every slot (one upload a step), and the temperatures
        self._state = torch.zeros((3, max_batch), dtype=torch.int64, device=self.device)
        self._temps = torch.zeros((max_batch,), dtype=torch.float32, device=self.device)
        self._programs: dict[tuple[int, bool], tuple[StepGraph, torch.Tensor]] = {}
        self._uid = itertools.count()
        self.queue: deque[Request] = deque()
        self.requests: dict[int, Request] = {}
        # host-side slot state
        self.slot_req: list[Request | None] = [None] * max_batch
        self.lengths = np.zeros((max_batch,), np.int64)
        self.next_token = np.zeros((max_batch,), np.int64)
        log.debug("engine: max_batch %d, max_len %d, kv %s, a8 prefill %s, paged blocks %s, "
                  "window %d, device %s", max_batch, self.max_len, kv_dtype, self.a8_prefill,
                  paged_blocks, self.decode_window, self.device)

    # ---- client API ----

    def add_request(
        self,
        prompt,
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: int = 0,
        eos_token_id: int | None = None,
        lora_id: int = 0,
        on_token=None,
    ) -> int:
        prompt = [int(t) for t in np.asarray(prompt).ravel()]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            # admission always commits the first prefill-sampled token
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_len {self.max_len}"
            )
        if top_k >= self.cfg.vocab_size:
            top_k = 0  # filtering the whole vocab is a no-op
        if temperature > 0 and top_k > self.topk_cap:
            raise ValueError(
                f"top_k {top_k} exceeds the engine's topk_cap {self.topk_cap} "
                f"— construct Engine(topk_cap=...) larger"
            )
        if lora_id:
            raise NotImplementedError("banked LoRA serving is not ported yet")
        r = Request(
            uid=next(self._uid),
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_k=top_k,
            eos_token_id=eos_token_id,
            on_token=on_token,
        )
        self.queue.append(r)
        self.requests[r.uid] = r
        return r.uid

    def result(self, uid: int) -> list[int]:
        r = self.requests[uid]
        if not r.done:
            raise ValueError(f"request {uid} not finished")
        return r.out_tokens

    def poll(self, uid: int) -> tuple[list[int], bool]:
        """Incremental streaming fetch: tokens committed since the last
        poll for this request, and whether it has finished."""
        r = self.requests[uid]
        new = r.out_tokens[r.polled:]
        r.polled = len(r.out_tokens)
        return new, r.done

    def warmup(self, temperature: float = 0.0) -> None:
        """Run one request per prompt bucket (and, with max_batch >
        prefill_rows, a queue deeper than one admission round) through the
        normal scheduler before real traffic, then forget those requests;
        slot and cache state is garbage that slot reuse overwrites. Then
        make sure both decode programs (window 1 and the full window) are
        captured, as JAX's warmup compiles both (engine.py:906-946).
        temperature > 0 does all of it for the sampled programs."""
        assert not self.has_work, "warmup() requires an idle engine"
        kw = dict(temperature=temperature,
                  top_k=min(8, self.topk_cap) if temperature > 0 else 0)
        new = self.decode_window + 2
        uids = []
        for b in self.buckets:
            n = min(b, self.max_len - new)
            uids.append(self.add_request([1] * n, new, **kw))
            self.run()
        rows = self.prefill_rows
        if self.max_batch > rows:
            n = min(self.buckets[0], self.max_len - new)
            for _ in range(rows + 1):
                uids.append(self.add_request([1] * n, new, **kw))
            self.run()
        for u in uids:
            del self.requests[u]
        # a program not yet captured is warmed (one garbage step of idle
        # slots at length 1, the trash block's rows when paged) and captured
        self._sync_tables()
        self._state.zero_()
        self._state[1].fill_(1)
        for window in sorted({1, self.decode_window}):
            self._program(window, temperature > 0)[0].prepare()

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slot_req)

    # ---- scheduling ----

    @property
    def free_slots(self) -> int:
        """Number of unoccupied decode slots (callers use it to feed
        arrivals as slots free up)."""
        return sum(1 for s in self.slot_req if s is None)

    def _free_slot(self) -> int | None:
        for i, s in enumerate(self.slot_req):
            if s is None:
                return i
        return None

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_len

    def _ensure_scratch(self, need: int) -> None:
        """(Re)allocate the shared prefill scratch to cover `need` positions:
        max(buckets) normally, max_len once a prompt longer than the largest
        bucket arrives (`_bucket_for` returns max_len for it)."""
        if self._scratch is not None and self._scratch_len >= need:
            return
        size = max(self.buckets) if need <= max(self.buckets) else self.max_len
        self._scratch = init_caches(self.cfg, self.prefill_rows, size, self.device,
                                    self.kv_dtype)
        self._scratch_len = size

    # ---- the paged cache's block allocator (host side) ----

    def _alloc_blocks(self, slot: int, upto_tokens: int) -> None:
        """Grow the slot's block list to cover `upto_tokens` positions."""
        need = min(-(-upto_tokens // self.paged_bs), self._max_seq_blocks)
        blocks = self._slot_blocks[slot]
        while len(blocks) < need:
            if not self._free_blocks:
                raise RuntimeError("paged KV pool exhausted — raise paged_blocks, lower "
                                   "max_batch, or shorten max_new_tokens")
            b = self._free_blocks.pop()
            self._table_np[slot, len(blocks)] = b
            blocks.append(b)
            self._table_dirty = True

    def _release_blocks(self, slot: int) -> None:
        self._free_blocks.extend(reversed(self._slot_blocks[slot]))
        self._slot_blocks[slot] = []
        self._table_np[slot, :] = 0  # point the row at the trash block
        self._table_dirty = True

    def _sync_tables(self) -> None:
        """Bring the device table up to date: one copy for all layers."""
        if self.paged and self._table_dirty:
            self._table.copy_(torch.from_numpy(self._table_np))
            self._table_dirty = False

    @torch.inference_mode()
    def _prefill_group(self, assignments: list[tuple[int, int, Request]]) -> None:
        """Prefill up to prefill_rows requests in one forward over the
        scratch rows, insert each real row's first `upto` positions (k, v
        and, for an int8 cache, their scales) into its slot, and sample the
        first tokens. assignments: (scratch_row, slot, request). A paged
        engine grants each request's blocks and syncs the table first, then
        scatters every scratch row, cut into blocks, into the pool (rows pad
        their block list with the trash block)."""
        rows = self.prefill_rows
        bucket = max(self._bucket_for(len(r.prompt)) for _, _, r in assignments)
        toks = np.zeros((rows, bucket), np.int64)
        lens = np.ones((rows,), np.int64)  # dummy rows: 1 token, discarded
        temps = np.zeros((rows,), np.float32)
        topks = np.zeros((rows,), np.int64)
        for row, _, req in assignments:
            n = len(req.prompt)
            toks[row, :n] = req.prompt
            lens[row] = n
            if req.temperature > 0:
                temps[row] = req.temperature
                topks[row] = req.top_k
        self._ensure_scratch(bucket)
        upto = min(bucket, self.max_len)
        if self.paged:  # before the forward: an exhausted pool admits nothing
            for _, slot, req in assignments:
                self._alloc_blocks(slot, len(req.prompt))
            self._sync_tables()
        dev = self.device
        tokens = torch.as_tensor(toks, device=dev)
        positions = torch.arange(bucket, device=dev).expand(rows, bucket)
        logits, _ = forward_inner(
            self.params, self.cfg, tokens, positions, self._scratch, 0, a8=self.a8_prefill,
            last_pos=torch.as_tensor(lens - 1, device=dev),
        )
        first = sample_rows(logits[:, -1, :], torch.as_tensor(temps, device=dev),
                            torch.as_tensor(topks, device=dev),
                            self.topk_cap if temps.any() else 0, self._rng)
        if self.paged:
            nb = min(-(-upto // self.paged_bs), self._max_seq_blocks)
            blocks_np = np.zeros((rows, nb), np.int64)
            for row, slot, req in assignments:
                bl = self._slot_blocks[slot][:nb]
                blocks_np[row, :len(bl)] = bl
            blocks = torch.as_tensor(blocks_np, device=dev)
            for pool, small in zip(self.caches, self._scratch):
                paged_insert_rows(pool, small, blocks)
        else:
            src = torch.as_tensor([row for row, _, _ in assignments], device=dev)
            dst = torch.as_tensor([slot for _, slot, _ in assignments], device=dev)
            for big, small in zip(self.caches, self._scratch):
                for name in ("k", "v", "k_scale", "v_scale"):
                    b, s = getattr(big, name), getattr(small, name)
                    if b is not None:
                        b[dst, :, :upto] = s[src, :, :upto]
        first_np = first.cpu().numpy()  # the admission's one host fetch
        for row, slot, req in assignments:
            self.slot_req[slot] = req
            self.lengths[slot] = len(req.prompt)
            tok = int(first_np[row])
            self.next_token[slot] = tok
            self._commit(slot, tok)

    def _commit(self, slot: int, tok: int) -> None:
        """Append a sampled token to the slot's request; retire if done."""
        req = self.slot_req[slot]
        req.out_tokens.append(tok)
        if req.on_token is not None:
            req.on_token(req.uid, tok)
        hit_eos = req.eos_token_id is not None and tok == req.eos_token_id
        if hit_eos or len(req.out_tokens) >= req.max_new_tokens:
            req.done = True
            self.slot_req[slot] = None
            self.lengths[slot] = 0
            if self.paged:
                self._release_blocks(slot)

    def _program(self, window: int, sample: bool) -> tuple[StepGraph, torch.Tensor]:
        """The decode program of `window` lock-step steps over all slots
        (`_decode_multi`, engine.py:198-238), and its output buffer [B,
        window]. Each step runs the forward at every slot's length, samples
        (argmax unless `sample`), and advances the static token and length
        rows in place: the carry of the next window of a chain."""
        key = (window, sample)
        if key not in self._programs:
            out = torch.zeros((self.max_batch, window), dtype=torch.int64, device=self.device)
            tok, lens, topks = self._state
            cap = self.topk_cap if sample else 0
            # the step holds what it reads, not the engine (no reference cycle)
            params, cfg, caches, temps, rng = (self.params, self.cfg, self.caches, self._temps,
                                               self._rng)

            def run():
                for j in range(window):
                    logits, _ = forward_inner(params, cfg, tok[:, None], lens[:, None], caches,
                                              lens)
                    logits = logits[:, -1, :]
                    nxt = (sample_rows(logits, temps, topks, cap, rng) if sample
                           else torch.argmax(logits, dim=-1))
                    out[:, j] = nxt
                    tok.copy_(nxt)
                    lens.add_(1)

            self._programs[key] = StepGraph(torch.inference_mode()(run), self.device), out
        return self._programs[key]

    def _decode(self, window: int, chain: int, temps: np.ndarray, topks: np.ndarray) -> np.ndarray:
        """`chain` windows of `window` lock-step steps over all slots, each
        slot's current token at position lengths (inactive slots at 1, never
        committed). Returns the sampled tokens [max_batch, window * chain],
        the chain's one host fetch."""
        sample = bool(temps.any())
        state = np.stack([self.next_token, np.maximum(self.lengths, 1), topks])
        self._state.copy_(torch.from_numpy(state.astype(np.int64)))
        if sample:
            self._temps.copy_(torch.from_numpy(temps))
        program, out = self._program(window, sample)
        parts = []
        for _ in range(chain):
            program()
            parts.append(out if chain == 1 else out.clone())
        return (parts[0] if chain == 1 else torch.cat(parts, dim=1)).cpu().numpy()

    def step(self) -> None:
        """One scheduler step: admit queued requests into free slots (one
        grouped prefill), then advance every active slot by a decode window,
        or a chain of them, in the same step (engine.py:1293-1473)."""
        if self.queue:
            assignments = []
            for row in range(self.prefill_rows):
                slot = self._free_slot()
                if not self.queue or slot is None:
                    break
                req = self.queue.popleft()
                assignments.append((row, slot, req))
                self.slot_req[slot] = req  # reserve
            if assignments:
                self._prefill_group(assignments)
        active = [i for i, s in enumerate(self.slot_req) if s is not None and self.lengths[i] > 0]
        if not active:
            return
        # the full window unless a queued request could be admitted next step
        window = 1
        if self.decode_window > 1 and (not self.queue or self._free_slot() is None):
            window = self.decode_window
        temps = np.zeros((self.max_batch,), np.float32)
        topks = np.zeros((self.max_batch,), np.int64)
        for i in active:
            r = self.slot_req[i]
            if r.temperature > 0:
                temps[i] = r.temperature
                topks[i] = r.top_k
        # chain windows when no retirement can surprise the host: the batch
        # full, the queue empty and no eos to meet; the shortest remaining
        # budget bounds the chain
        chain = 1
        if (window > 1 and not self.queue and self._free_slot() is None
                and all(self.slot_req[i].eos_token_id is None for i in active)):
            min_rem = min(self.slot_req[i].max_new_tokens - len(self.slot_req[i].out_tokens)
                          for i in active)
            chain = max(1, min(-(-min_rem // window), self.max_chain))
        if self.paged:
            # blocks for every write of the chain (its overshoot included),
            # and retired slots' rows pointed at the trash block, before it runs
            for i in active:
                self._alloc_blocks(i, int(self.lengths[i]) + window * chain)
            self._sync_tables()
        toks = self._decode(window, chain, temps, topks)
        for i in active:
            for j in range(window * chain):
                if self.slot_req[i] is None:
                    break  # finished mid-window: the rest is garbage
                tok = int(toks[i, j])
                self.lengths[i] += 1
                self.next_token[i] = tok
                self._commit(i, tok)

    def run(self, max_steps: int | None = None) -> None:
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break

    def generate_all(self, prompts, max_new_tokens: int, **kw) -> list[list[int]]:
        """Submit a batch of prompts, run to completion, return outputs in
        submission order."""
        uids = [self.add_request(p, max_new_tokens, **kw) for p in prompts]
        self.run()
        return [self.result(u) for u in uids]
