"""Continuous-batching serving engine (slot-based) over a dense or a paged
KV cache, on one device or on the ranks of a sharded model.

Port of `eetq_tpu/serve/engine.py::Engine` with its local and its sharded
backend.
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

With `spec_ngram=k` (1 <= k <= 7, any GQA group: the verify's G (k + 1)
query rows a kv head take as many row blocks of the flash-decode as they
need; engine.py:740-760, 1227-1291) a decode window runs n-gram
speculative rounds instead of lock-step steps
(`serve/spec.py::NgramWindow`): drafts matched against each row's prompt
and output, one verify forward over k + 1 tokens a row, greedy acceptance,
until every slot has its window. A round is one replay of a captured graph
and one host fetch of the loop's condition. Spec windows run when the
window is above 1 or a busy slot samples (its tokens come from the
positional sampler, keyed by request and emission index, so its stream
does not depend on the window); greedy window-1 steps take the plain
program. The caches hold max_len + decode_window + 2k + 1 positions a row
(`_kv_len`): the verify writes of a window reach that far past a row's
length, and no write may be clamped onto committed KV.

With `prefill_chunk=c` (engine.py:1137-1212, 1293-1323) a prompt whose
bucket is larger than c and a multiple of it is prefilled one chunk of c
tokens a scheduler step on the shared prefill scratch (its slot reserved at
length 0, so decode skips it), each chunk attending over the scratch's
prefix, while the running slots' decode window still advances in the same
step. The chunks run W8A16 (JAX's `_prefill_chunk_step` passes no `a8`) and
eagerly, as admissions do; after the last one the first token is sampled
and the scratch row goes into the slot (paged: blocks granted, then cut
into the pool). A chunk-eligible prompt queued behind a short one stays at
the head of the queue for the next step's chunked path.

Multi-adapter LoRA serving (engine.py:712-730, 842-882): a model whose
layer 0 carries LoRA banks (`surgery.stack_adapters`) serves one quantized
base with a bank of adapters, each request picking its own by
`add_request(lora_id=...)`. Admissions and chunks run each row through its
request's adapter; the decode and spec programs read the slots' ids from a
device tensor kept at one address beside the static state, which admission
writes in place, so the captured graphs never read a rebound tensor.

The sharded backend (engine.py:234-416, 664-680): `Engine(model)` with a
`dist.sharding.ShardedModel` and no cfg runs the same scheduler in SPMD on
every rank of the model's mesh. Each rank holds its shard and the KV cache
of its kv heads; its forwards all-reduce and gather over the model axis
(`dist/sharding.py`). Under dp > 1 the slots are sharded over `data`: a
rank holds the max_batch / dp slots of its data shard (`_rows`), an
admission round takes up to dp requests, scratch row i going only into a
slot of shard i (`_slots_for_row`), each shard prefilling and inserting its
own row, and the decode and spec windows run on the shard's own rows; at
each host fetch the shards' sampled tokens are gathered over `data`, so
every rank keeps the same host state over all max_batch slots (the
contract of engine.py:263-271). A data shard that admitted nothing or has
no busy slot still takes part in every gather of the step. Spec windows
may run different numbers of rounds in different shards; `spec_rounds`
adds the most of them. Its sampler is positional (`serve/sampling.py`:
each token drawn from (seed, request uid, emission index)), so a sampled
request's tokens depend on neither its slot nor the mesh, and equal the
spec windows' draws. Its defaults are a bf16 cache and W8A16 prefill on any
device, and it refuses what the JAX package refuses there: a8 prefill, an
int8 cache, banked LoRA, a paged cache and prefill chunks. Its decode and
spec windows run eagerly: a collective staged through the host cannot be
captured into a CUDA graph.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque

import numpy as np
import torch

from eetq_tpu_torch.dist.sharding import DATA_AXIS, ShardedModel, cache_spec
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.transformer import ModelParams, forward_inner, init_caches
from eetq_tpu_torch.modules.linear import QuantLinear
from eetq_tpu_torch.modules.paged import init_paged_kv_cache, paged_insert_dense, paged_insert_rows
from eetq_tpu_torch.serve.graph import StepGraph
from eetq_tpu_torch.serve.sampling import row_keys, rng_state, sample_pos_rows, sample_rows
from eetq_tpu_torch.serve.spec import NgramWindow
from eetq_tpu_torch.serve.tracing import Trace, register
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

    `eng.trace` is the serving trace (`serve/tracing.py`: request stamps,
    steps and their phases).
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
        self.mesh = None
        if cfg is None:
            # a sharded model (its cfg comes with it): the refusals and
            # defaults of JAX's sharded backend
            if not isinstance(params, ShardedModel):
                raise TypeError("Engine takes (params, cfg), or a dist.sharding.ShardedModel")
            if a8_prefill:
                raise ValueError("a8_prefill is not supported for sharded models yet")
            if kv_dtype is not None and kv_dtype != torch.bfloat16:
                raise ValueError("int8 KV is not supported for sharded models yet "
                                 "(pass kv_dtype=torch.bfloat16 or omit it)")
            if paged_blocks is not None:
                raise ValueError("paged KV is local-backend only for now")
            if prefill_chunk is not None:
                raise ValueError("prefill_chunk is local-backend only")
            a8_prefill, kv_dtype = False, torch.bfloat16
            self.mesh = params.mesh
            params, cfg = params.params, params.cfg
        if spec_ngram is not None and not 1 <= spec_ngram <= 7:
            raise ValueError("spec_ngram must be in [1, 7] (the k + 1-token verify must stay "
                             "in the m <= 8 decode regime)")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
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
        # under a mesh the admission rows are fixed at dp, one a data shard
        self.dp = 1 if self.mesh is None else self.mesh.dp
        if self.mesh is not None:
            self.prefill_rows = self.dp
        else:
            self.prefill_rows = 1 if prefill_rows is None else max(1, min(prefill_rows,
                                                                          max_batch))
        if max_batch % self.prefill_rows:
            raise ValueError(f"max_batch {max_batch} must divide by "
                             f"{'dp' if self.mesh is not None else 'prefill_rows'} "
                             f"{self.prefill_rows}")
        # this rank's slots (its data shard's) and scratch rows
        bl, d = max_batch // self.dp, 0 if self.mesh is None else self.mesh.dp_rank
        self._rows = slice(d * bl, (d + 1) * bl)
        lr = self.prefill_rows // self.dp
        self._scratch_rows = range(d * lr, (d + 1) * lr)
        self.params = params
        self.cfg = cfg
        # the caches hold this rank's kv heads under a mesh
        self._cache_cfg = cfg if self.mesh is None else cache_spec(cfg, self.mesh)
        # LoRA banks on layer 0 (adapters with a leading [n_adapters] axis):
        # requests pick theirs by add_request(lora_id=...)
        first = params.layers[0] if params.layers else None
        bank = None if first is None else next(
            (ad for ad in (first.qkv_lora, first.o_lora) if ad is not None and ad.banked), None)
        self._lora_banked = bank is not None
        if self._lora_banked and self.mesh is not None:
            raise ValueError("banked LoRA serving is local-backend only for now")
        self._n_adapters = bank.lora_a.shape[0] if bank is not None else 0
        self.lora_ids = np.zeros((max_batch,), np.int64)
        # the slots' ids as the programs read them: one buffer, written in place
        self._lora_ids = (torch.zeros((bl,), dtype=torch.int64, device=self.device)
                          if self._lora_banked else None)
        self.max_batch = max_batch
        self.max_len = min(max_len, cfg.max_position)
        self.buckets = tuple(sorted(b for b in prompt_buckets if b <= self.max_len)) or (
            self.max_len,)
        self.kv_dtype = kv_dtype
        self.spec_ngram = spec_ngram
        # the caches' positions a row: a speculative window's verify writes
        # reach lengths + window + 2k past a row's length (spec_generate's
        # slack s + new + 2k + 1, plus the window's advance); requests are
        # still budgeted against max_len
        self._kv_len = self.max_len + (
            self.decode_window + 2 * spec_ngram + 1 if spec_ngram else 0)
        self.paged = paged_blocks is not None
        if self.paged:
            bs = paged_block_size
            if paged_blocks < 2:
                raise ValueError("paged_blocks must be >= 2")
            if bs > -(-self.max_len // 128) * 128:
                raise ValueError(f"paged_block_size {bs} exceeds the (rounded) max_len")
            self.paged_bs = bs
            self._max_seq_blocks = -(-self._kv_len // bs)
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
            self.caches = init_caches(self._cache_cfg, bl, self._kv_len, self.device, kv_dtype)
        self._scratch = None  # reused prefill scratch caches
        self._scratch_len = 0
        # prompts whose bucket is larger than and a multiple of this prefill
        # a chunk a step; the one in flight: (request, slot, tokens [rows,
        # bucket], bucket, chunks done, the logits of its last real token)
        self.prefill_chunk = prefill_chunk
        self._chunking: tuple | None = None
        self.topk_cap = int(topk_cap)
        self._rng = rng_state(seed, self.device)
        # the decode programs' static inputs: next token, length, top-k and,
        # for the positional sampler of a mesh, the request's key and the
        # emission index of every slot of the rank (one upload a step), and
        # the temperatures
        self._state = torch.zeros((5, bl), dtype=torch.int64, device=self.device)
        self._temps = torch.zeros((bl,), dtype=torch.float32, device=self.device)
        self._programs: dict[tuple[int, bool], tuple[StepGraph, torch.Tensor]] = {}
        # the speculative windows' programs, by (window, sampled); their
        # sampler keys each request's draws by (seed, uid) and emission index
        self._spec_programs: dict[tuple[int, bool], NgramWindow] = {}
        self._spec_seed = (seed * 0x9E3779B1 + 0x5BEC) & 0xFFFFFFFF
        self.spec_rounds = self.spec_tokens = 0  # verify rounds run, tokens they committed
        self._uid = itertools.count()
        self.queue: deque[Request] = deque()
        self.requests: dict[int, Request] = {}
        # host-side slot state
        self.slot_req: list[Request | None] = [None] * max_batch
        self.lengths = np.zeros((max_batch,), np.int64)
        self.next_token = np.zeros((max_batch,), np.int64)
        # the serving trace (serve/tracing.py): requests, steps, phases
        self.trace = Trace()
        register(self.trace)
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
        added = time.monotonic_ns()  # the trace's stamp
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
            if not self._lora_banked:
                raise ValueError("lora_id requires a model with adapter banks "
                                 "(surgery.stack_adapters)")
            if not 0 <= lora_id < self._n_adapters:
                raise ValueError(f"lora_id {lora_id} out of range [0, {self._n_adapters})")
        r = Request(
            uid=next(self._uid),
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_k=top_k,
            eos_token_id=eos_token_id,
            lora_id=int(lora_id),
            on_token=on_token,
        )
        self.queue.append(r)
        self.requests[r.uid] = r
        self.trace.add(r.uid, added)
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
        captured, as JAX's warmup compiles both (engine.py:906-946), or with
        spec_ngram those the serving loop runs: the greedy window-1 program
        and the full spec window, or for temperature > 0 the sampled spec
        windows of both sizes. temperature > 0 does all of it for the
        sampled programs."""
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
        sample = temperature > 0
        for window in sorted({1, self.decode_window}):
            if self._spec_window(window, sample):
                prog = self._spec_program(window, sample)
                bl = prog.hist.shape[0]
                prog.load(np.zeros(prog.hist.shape, np.int64), np.full(bl, 2),
                          np.zeros(bl, np.int64), np.ones(bl, np.int64))
                prog.graph.prepare()
            else:
                self._program(window, sample)[0].prepare()

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

    def _slots_for_row(self, row: int) -> range:
        """The slots scratch row `row` may go into: under a mesh its own data
        shard's (engine.py:337-341, each shard inserts its own row), else
        any."""
        if self.mesh is None:
            return range(self.max_batch)
        size = self.max_batch // self.dp
        return range(row * size, (row + 1) * size)

    def _keys(self, uids) -> torch.Tensor:
        """The positional sampler's key of each request uid (the spec
        windows' keys too)."""
        return row_keys(self._spec_seed, torch.as_tensor(np.asarray(uids, np.int64)))

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every data shard's rows of a result, side by side (a fetch's
        gather over `data`); x itself where dp = 1."""
        return x if self.dp == 1 else self.mesh.gather_rows(x)

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
        self._scratch = init_caches(self._cache_cfg, len(self._scratch_rows), size, self.device,
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

    def _set_lora(self, slot: int, lora_id: int) -> None:
        """The slot's adapter id, on the host and in the programs' buffer."""
        self.lora_ids[slot] = lora_id
        if self._lora_banked:
            self._lora_ids.copy_(torch.from_numpy(self.lora_ids[self._rows]))

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
        their block list with the trash block). Under dp > 1 a rank runs its
        data shard's scratch row (none where that row is empty), inserts it
        into its own slot, and the first tokens are gathered over `data`."""
        rows = self.prefill_rows
        bucket = max(self._bucket_for(len(r.prompt)) for _, _, r in assignments)
        tr = self.trace
        tr.begin_admission([req for _, _, req in assignments], bucket, rows)
        toks = np.zeros((rows, bucket), np.int64)
        lens = np.ones((rows,), np.int64)  # dummy rows: 1 token, discarded
        temps = np.zeros((rows,), np.float32)
        topks = np.zeros((rows,), np.int64)
        lids = np.zeros((rows,), np.int64)
        for row, _, req in assignments:
            n = len(req.prompt)
            toks[row, :n] = req.prompt
            lens[row] = n
            lids[row] = req.lora_id
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
        mine = self._scratch_rows
        local = [(row - mine.start, slot - self._rows.start, req)
                 for row, slot, req in assignments if row in mine]
        sl = slice(mine.start, mine.stop)
        if not local:  # this data shard admits nothing: it joins the gather
            first = torch.zeros((len(mine),), dtype=torch.int64, device=dev)
        else:
            tokens = torch.as_tensor(toks[sl], device=dev)
            positions = torch.arange(bucket, device=dev).expand(len(mine), bucket)
            logits, _ = forward_inner(
                self.params, self.cfg, tokens, positions, self._scratch, 0, a8=self.a8_prefill,
                last_pos=torch.as_tensor(lens[sl] - 1, device=dev),
                lora_idx=torch.as_tensor(lids[sl], device=dev) if self._lora_banked else None,
                mesh=self.mesh,
            )
            temps_t = torch.as_tensor(temps[sl], device=dev)
            topks_t = torch.as_tensor(topks[sl], device=dev)
            cap = self.topk_cap if temps.any() else 0
            if self.mesh is None:
                first = sample_rows(logits[:, -1, :], temps_t, topks_t, cap, self._rng)
            else:  # emission 0 of each request, by its key
                uids = np.zeros((rows,), np.int64)
                for row, _, req in assignments:
                    uids[row] = req.uid
                first = sample_pos_rows(logits[:, -1:, :], torch.zeros_like(topks_t)[:, None],
                                        self._keys(uids[sl]).to(dev), temps_t, topks_t,
                                        cap)[:, 0]
        if self.paged:
            nb = min(-(-upto // self.paged_bs), self._max_seq_blocks)
            blocks_np = np.zeros((rows, nb), np.int64)
            for row, slot, req in assignments:
                bl = self._slot_blocks[slot][:nb]
                blocks_np[row, :len(bl)] = bl
            blocks = torch.as_tensor(blocks_np, device=dev)
            for pool, small in zip(self.caches, self._scratch):
                paged_insert_rows(pool, small, blocks)
        elif local:
            self._insert_scratch(torch.as_tensor([row for row, _, _ in local], device=dev),
                                 torch.as_tensor([slot for _, slot, _ in local], device=dev), upto)
        tr.mark("launched")
        first_np = self._gather(first).cpu().numpy()  # the admission's one host fetch
        tr.mark("fetched")
        for row, slot, req in assignments:
            self._set_lora(slot, req.lora_id)
            self.slot_req[slot] = req
            self.lengths[slot] = len(req.prompt)
            tok = int(first_np[row])
            self.next_token[slot] = tok
            self._commit(slot, tok)
        tr.mark("committed")

    def _chunk_eligible(self, req: Request) -> bool:
        """Whether `req` prefills by chunks: prefill_chunk set, and its bucket
        larger than and a multiple of it (engine.py:1137-1146)."""
        if not self.prefill_chunk:
            return False
        bucket = self._bucket_for(len(req.prompt))
        return bucket > self.prefill_chunk and bucket % self.prefill_chunk == 0

    def _start_chunked(self, slot: int, req: Request) -> None:
        """Begin a chunked prefill: reserve the slot (its length stays 0, so
        decode skips it) and run the first chunk on the scratch."""
        bucket = self._bucket_for(len(req.prompt))
        toks = np.zeros((self.prefill_rows, bucket), np.int64)
        toks[0, :len(req.prompt)] = req.prompt
        self._ensure_scratch(bucket)
        self.slot_req[slot] = req
        self._chunking = (req, slot, toks, bucket, 0, None)
        self._chunk_step()

    @torch.inference_mode()
    def _chunk_step(self) -> None:
        """Advance the chunked prefill in flight by one chunk: W8A16 over the
        scratch at positions offset .. offset + c - 1, the logits gathered at
        the chunk's last real token (`_prefill_chunk_step`, engine.py:492-510).
        After the last chunk: sample the first token with the engine's one
        sampler, hand scratch row 0 to the slot and activate it."""
        req, slot, toks, bucket, done, last_logits = self._chunking
        c, n, rows, dev = self.prefill_chunk, len(req.prompt), self.prefill_rows, self.device
        self.trace.path("chunk")
        offset = done * c
        tokens = torch.as_tensor(toks[:, offset:offset + c], device=dev)
        positions = torch.arange(offset, offset + c, device=dev).expand(rows, c)
        last = min(max(n - 1 - offset, 0), c - 1)  # only the owning chunk's gather is kept
        lids = (torch.full((rows,), req.lora_id, device=dev) if self._lora_banked else None)
        logits, _ = forward_inner(self.params, self.cfg, tokens, positions, self._scratch, offset,
                                  last_pos=torch.full((rows,), last, device=dev), lora_idx=lids)
        if offset <= n - 1 < offset + c:
            last_logits = logits[:1, -1, :]
        done += 1
        if done * c < bucket:
            self._chunking = (req, slot, toks, bucket, done, last_logits)
            return
        self._chunking = None
        temps = torch.full((1,), req.temperature, dtype=torch.float32, device=dev)
        topks = torch.full((1,), req.top_k if req.temperature > 0 else 0, device=dev)
        first = sample_rows(last_logits, temps, topks,
                            self.topk_cap if req.temperature > 0 else 0, self._rng)
        if self.paged:
            self._alloc_blocks(slot, n)
            self._sync_tables()
            blocks = torch.as_tensor(self._slot_blocks[slot], device=dev)
            for pool, small in zip(self.caches, self._scratch):
                paged_insert_dense(pool, small, 0, blocks, len(blocks))
        else:
            self._insert_scratch(0, slot - self._rows.start, min(bucket, self.max_len))
        tok = int(first[0])  # the chunked prefill's one host fetch
        self._set_lora(slot, req.lora_id)
        self.lengths[slot] = n
        self.next_token[slot] = tok
        self._commit(slot, tok)

    def _insert_scratch(self, src, dst, upto: int) -> None:
        """Copy the first `upto` positions of scratch row(s) `src` (k, v and,
        for an int8 cache, their scales) into dense slot(s) `dst`."""
        for big, small in zip(self.caches, self._scratch):
            for name in ("k", "v", "k_scale", "v_scale"):
                b, s = getattr(big, name), getattr(small, name)
                if b is not None:
                    b[dst, :, :upto] = s[src, :, :upto]

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
            self.trace.finish(req.uid)

    def _program(self, window: int, sample: bool) -> tuple[StepGraph, torch.Tensor]:
        """The decode program of `window` lock-step steps over the rank's
        slots (`_decode_multi`, engine.py:198-238), and its output buffer
        [B / dp, window]. Each step runs the forward at every slot's length,
        samples (argmax unless `sample`; under a mesh the positional sampler
        at each slot's emission index), and advances the static token,
        length and emission rows in place: the carry of the next window of a
        chain."""
        key = (window, sample)
        if key not in self._programs:
            tok, lens, topks, keys, emit = self._state
            out = torch.zeros((tok.shape[0], window), dtype=torch.int64, device=self.device)
            cap = self.topk_cap if sample else 0
            # the step holds what it reads, not the engine (no reference cycle)
            params, cfg, caches, temps, rng, lora, mesh = (
                self.params, self.cfg, self.caches, self._temps, self._rng, self._lora_ids,
                self.mesh)

            def run():
                for j in range(window):
                    logits, _ = forward_inner(params, cfg, tok[:, None], lens[:, None], caches,
                                              lens, lora_idx=lora, mesh=mesh)
                    if not sample:
                        nxt = torch.argmax(logits[:, -1, :], dim=-1)
                    elif mesh is None:
                        nxt = sample_rows(logits[:, -1, :], temps, topks, cap, rng)
                    else:
                        nxt = sample_pos_rows(logits[:, -1:, :], emit[:, None], keys, temps,
                                              topks, cap)[:, 0]
                    out[:, j] = nxt
                    tok.copy_(nxt)
                    lens.add_(1)
                    emit.add_(1)

            self._programs[key] = StepGraph(torch.inference_mode()(run), self.device,
                                            eager=mesh is not None), out
        return self._programs[key]

    def _spec_window(self, window: int, sample: bool) -> bool:
        """Whether a window runs speculative rounds: with spec_ngram, a
        window above 1 or one where a slot samples."""
        return self.spec_ngram is not None and (window > 1 or sample)

    def _spec_program(self, window: int, sample: bool) -> NgramWindow:
        """The speculative window of `window` tokens a slot over all slots
        (`_spec_decode_window`, engine.py:1227-1291)."""
        key = (window, sample)
        if key not in self._spec_programs:
            k = self.spec_ngram
            self._spec_programs[key] = NgramWindow(
                self.params, self.cfg, self.caches, self.max_batch // self.dp,
                self.max_len + window + 2 * k + 2, window, k, self.device, sampled=sample,
                topk_cap=self.topk_cap if sample else 0, lora_ids=self._lora_ids,
                mesh=self.mesh)
        return self._spec_programs[key]

    def _spec_decode(self, active: list[int], window: int, temps: np.ndarray,
                     topks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One speculative window over all slots. The history each row's
        drafts match is its committed prompt and output, rebuilt on the host
        and uploaded with the window's inputs (a rank's own rows). Returns
        (tokens [max_batch, window], counts [max_batch]), the window's host
        fetch, gathered over `data`; the window's rounds are the most any
        data shard ran (`make_spec_window_fn` declares them replicated,
        `eetq_tpu/dist/sharding.py:419-420`, where the shards may differ)."""
        k = self.spec_ngram
        sample = bool(temps.any())
        tr = self.trace
        tr.begin_decode(window, 1, self._busy(), spec=True)
        if self.paged:
            # the rounds write KV up to lengths + window - 1 + k for every
            # committed position: blocks for all of it, so no accepted
            # token's KV lands in the trash block
            for i in active:
                self._alloc_blocks(i, int(self.lengths[i]) + window + k + 1)
            self._sync_tables()
        prog = self._spec_program(window, sample)
        hist = np.zeros((self.max_batch, prog.hist.shape[1]), np.int64)
        valid = np.full((self.max_batch,), 2, np.int64)
        uids = np.zeros((self.max_batch,), np.int64)
        emit0 = np.zeros((self.max_batch,), np.int64)
        for i in active:
            req = self.slot_req[i]
            toks = req.prompt + req.out_tokens
            hist[i, :len(toks)] = toks
            valid[i] = len(toks)  # == lengths[i] + 1
            uids[i] = req.uid
            emit0[i] = len(req.out_tokens)
        sample_args = ()
        if sample:
            sample_args = (emit0, self._keys(uids), temps, topks)
        r = self._rows
        prog.load(hist[r], valid[r], self.next_token[r], np.maximum(self.lengths, 1)[r],
                  *(a[r] for a in sample_args))
        tr.mark("uploaded")
        out, counts, rounds = prog.run()
        if self.dp > 1:  # the shards may have run different numbers of rounds
            rounds = int(self.mesh.all_reduce_(torch.tensor([rounds], device=self.device),
                                               DATA_AXIS, op="max").item())
        self.spec_rounds += rounds
        tr.mark("launched")
        toks, counts = self._gather(out).cpu().numpy(), self._gather(counts).cpu().numpy()
        tr.mark("fetched")
        return toks, counts

    def _decode(self, window: int, chain: int, temps: np.ndarray, topks: np.ndarray) -> np.ndarray:
        """`chain` windows of `window` lock-step steps over the rank's slots,
        each slot's current token at position lengths (inactive slots at 1,
        never committed). Returns the sampled tokens [max_batch, window *
        chain], the chain's one host fetch (gathered over `data`)."""
        sample = bool(temps.any())
        tr = self.trace
        tr.begin_decode(window, chain, self._busy())
        keys = np.zeros((self.max_batch,), np.int64)
        emit = np.zeros((self.max_batch,), np.int64)
        if sample and self.mesh is not None:
            for i, req in enumerate(self.slot_req):
                if req is not None:
                    keys[i], emit[i] = int(self._keys([req.uid])[0]), len(req.out_tokens)
        state = np.stack([self.next_token, np.maximum(self.lengths, 1), topks, keys, emit])
        self._state.copy_(torch.from_numpy(state[:, self._rows].astype(np.int64)))
        if sample:
            self._temps.copy_(torch.from_numpy(temps[self._rows]))
        tr.mark("uploaded")
        program, out = self._program(window, sample)
        parts = []
        for _ in range(chain):
            program()
            parts.append(out if chain == 1 else out.clone())
        tr.mark("launched")
        toks = self._gather(parts[0] if chain == 1 else torch.cat(parts, dim=1)).cpu().numpy()
        tr.mark("fetched")
        return toks

    def _busy(self) -> tuple:
        """(length, remaining budget) of each busy slot, in slot order: the
        trace's record of a decode call as it begins."""
        return tuple([(n, r.max_new_tokens - len(r.out_tokens))
                      for n, r in zip(self.lengths.tolist(), self.slot_req)
                      if n > 0 and r is not None])

    def step(self) -> None:
        """One scheduler step: advance a chunked prefill in flight by one
        chunk, or start one for a chunk-eligible queue head, or admit queued
        requests into free slots (one grouped prefill); then advance every
        active slot by a decode window, or a chain of them, in the same step
        (engine.py:1293-1473). Traced as one `tracing.Step`."""
        self.trace.begin_step()
        try:
            self._advance()
        finally:
            self.trace.end_step()

    def _advance(self) -> None:
        """The work of one `step()`."""
        tr = self.trace
        if self._chunking is not None:
            self._chunk_step()
        elif self.queue and self._chunk_eligible(self.queue[0]):
            slot = self._free_slot()
            if slot is not None:
                self._start_chunked(slot, self.queue.popleft())
        elif self.queue:
            assignments = []
            for row in range(self.prefill_rows):  # under dp: scratch row i -> shard i
                # a chunk-eligible prompt stays at the head for the next
                # step's chunked path, never in a grouped admission
                if not self.queue or self._chunk_eligible(self.queue[0]):
                    break
                slot = next((i for i in self._slots_for_row(row) if self.slot_req[i] is None),
                            None)
                if slot is None:
                    continue
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
        # full, the queue empty, no chunked prefill in flight (its next chunk
        # would wait for the chain) and no eos to meet; the shortest
        # remaining budget bounds the chain
        if self._spec_window(window, bool(temps.any())):
            toks, counts = self._spec_decode(active, window, temps, topks)
            for i in active:
                for j in range(int(counts[i])):
                    if self.slot_req[i] is None:
                        break  # finished mid-window: the rest is garbage
                    tok = int(toks[i, j])
                    self.lengths[i] += 1
                    self.next_token[i] = tok
                    self.spec_tokens += 1
                    self._commit(i, tok)
            tr.mark("committed")
            return
        chain = 1
        if (window > 1 and not self.queue and self._free_slot() is None
                and self._chunking is None
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
        tr.mark("committed")

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
