"""Continuous-batching serving engine (slot-based), dense and single-device.

Port of `eetq_tpu/serve/engine.py::Engine` with its local backend.
Requests arrive at any time; each scheduler step admits queued requests
into free slots (one grouped prefill of up to `prefill_rows` prompts,
right-padded to a length bucket, its KV rows inserted into the slots and
its first tokens sampled, as `_prefill_commit` does at engine.py:97-136),
then advances every active slot by one lock-step decode step over the
fixed [max_batch] slot array. Inactive slots decode garbage at a safe
position that is never committed. Finished slots are recycled at once.

The KV caches are preallocated [max_batch, max_len] buffers updated in
place with per-row offsets. On a CUDA device, for a quantized model, the
engine defaults to W8A8 prefill and, for max_len >= 512, an int8 KV cache
(engine.py:686-696, where JAX asks for a TPU); on the CPU both default
off, and a caller may pass either.

Outputs are reproducible run to run (the sampler draws from a
`torch.Generator` seeded from `seed`), and on the CPU greedy outputs equal
`prefill` followed by `decode_loop` with the same options (the property
engine.py:21-22 states for JAX).

Later work, which raises NotImplementedError here: decode windows > 1 and
their chaining, `prefill_chunk`, paged KV, `spec_ngram`, banked LoRA and a
sharded model.
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


def _sample_rows(logits: torch.Tensor, temps: np.ndarray, topks: np.ndarray, topk_cap: int,
                 generator: torch.Generator) -> torch.Tensor:
    """Per-row mixed greedy/sampled next tokens, the one sampler of every
    path (engine.py:161-180, :1461-1462). logits [B, V]; temps [B] (0 =
    greedy row); topks [B] (0 = no top-k filter); topk_cap bounds every
    row's top_k (the top topk_cap are taken once and each row reads its own
    k-th value as its threshold). Only the sampled rows draw from
    `generator`. Returns tokens [B] int64 on the logits' device."""
    tokens = torch.argmax(logits, dim=-1)
    rows = np.flatnonzero(temps > 0)
    if rows.size == 0:
        return tokens
    dev = logits.device
    idx = torch.as_tensor(rows, device=dev)
    scaled = logits[idx].float() / torch.as_tensor(temps[rows], device=dev)[:, None]
    if topk_cap > 0:
        k = torch.as_tensor(topks[rows], device=dev)
        vals = torch.topk(scaled, topk_cap, dim=-1).values
        kth = vals.gather(1, (k - 1).clamp(0, topk_cap - 1)[:, None].long())
        scaled = scaled.masked_fill((k[:, None] > 0) & (scaled < kth), float("-inf"))
    drawn = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=generator)
    tokens[idx] = drawn[:, 0]
    return tokens


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
        topk_cap: int = 64,
        spec_ngram: int | None = None,
    ):
        if cfg is None:
            raise NotImplementedError("a sharded model has no engine backend in the port yet")
        if decode_window is not None and decode_window > 1:
            raise NotImplementedError("decode windows > 1 (and their chaining) are not ported yet")
        if spec_ngram is not None:
            raise NotImplementedError("n-gram speculative decoding is not ported yet")
        if paged_blocks is not None:
            raise NotImplementedError("the paged KV cache is not ported yet")
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
            kv_dtype = torch.int8 if on_cuda and quantized and max_len >= 512 else torch.bfloat16
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
        self.caches = init_caches(cfg, max_batch, self.max_len, self.device, kv_dtype)
        self._scratch = None  # reused prefill scratch caches
        self._scratch_len = 0
        self.topk_cap = int(topk_cap)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._uid = itertools.count()
        self.queue: deque[Request] = deque()
        self.requests: dict[int, Request] = {}
        # host-side slot state
        self.slot_req: list[Request | None] = [None] * max_batch
        self.lengths = np.zeros((max_batch,), np.int64)
        self.next_token = np.zeros((max_batch,), np.int64)
        log.debug("engine: max_batch %d, max_len %d, kv %s, a8 prefill %s, device %s",
                  max_batch, self.max_len, kv_dtype, self.a8_prefill, self.device)

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
        slot and cache state is garbage that slot reuse overwrites.
        temperature > 0 also exercises the sampled path."""
        assert not self.has_work, "warmup() requires an idle engine"
        kw = dict(temperature=temperature,
                  top_k=min(8, self.topk_cap) if temperature > 0 else 0)
        new = 3  # the admission's token and two decode steps
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

    @torch.inference_mode()
    def _prefill_group(self, assignments: list[tuple[int, int, Request]]) -> None:
        """Prefill up to prefill_rows requests in one forward over the
        scratch rows, insert each real row's first `upto` positions (k, v
        and, for an int8 cache, their scales) into its slot, and sample the
        first tokens. assignments: (scratch_row, slot, request)."""
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
        dev = self.device
        tokens = torch.as_tensor(toks, device=dev)
        positions = torch.arange(bucket, device=dev).expand(rows, bucket)
        logits, _ = forward_inner(
            self.params, self.cfg, tokens, positions, self._scratch, 0, a8=self.a8_prefill,
            last_pos=torch.as_tensor(lens - 1, device=dev),
        )
        first = _sample_rows(logits[:, -1, :], temps, topks,
                             self.topk_cap if temps.any() else 0, self._generator)
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

    @torch.inference_mode()
    def _decode(self, active: list[int]) -> np.ndarray:
        """One lock-step decode over all slots: each slot's current token at
        position lengths (inactive slots at 1, never committed). Returns the
        sampled tokens [max_batch]."""
        dev = self.device
        lengths = torch.as_tensor(np.maximum(self.lengths, 1), device=dev)
        tokens = torch.as_tensor(self.next_token[:, None], device=dev)
        logits, _ = forward_inner(self.params, self.cfg, tokens, lengths[:, None], self.caches,
                                  lengths)
        temps = np.zeros((self.max_batch,), np.float32)
        topks = np.zeros((self.max_batch,), np.int64)
        for i in active:
            r = self.slot_req[i]
            if r.temperature > 0:
                temps[i] = r.temperature
                topks[i] = r.top_k
        toks = _sample_rows(logits[:, -1, :], temps, topks,
                            self.topk_cap if temps.any() else 0, self._generator)
        return toks.cpu().numpy()

    def step(self) -> None:
        """One scheduler step: admit queued requests into free slots (one
        grouped prefill), then advance every active slot by one decode step
        in the same step."""
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
        toks = self._decode(active)
        for i in active:
            self.lengths[i] += 1
            tok = int(toks[i])
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
