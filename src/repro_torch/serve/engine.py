"""Token-family ModelRunner and the LLM serving engine.

Port of ``repro.serve.engine`` for the dense, MoE, SSM and hybrid
families (``SERVABLE_FAMILIES``, the reference's; the encoder-decoder
family goes through the ``whisper_*`` entry points, as in the
reference). ``TransformerRunner``
prefills a request's cache on admission and advances every active slot by
one greedy decode step per scheduler tick, on the shared slot scheduler.
Per-slot sequence positions differ, so the decode step runs all slots as
one batch with a per-slot index vector (the reference vmaps a batch-1
step over them); a slot that is not active decodes token 0 at index 0, as
in the reference (which advances its recurrent state and writes its ring
slot 0), and its row is overwritten whole on the next admission: the
prompt's k/v and zeros past it, the recurrent states and the rings whole.

The runner holds the serving parameters (``serving_params``): matmul
weights cast once to the activation dtype, ``F32_LEAVES`` (the embedding
table, the norm weights, the recurrent mixers' convs and gates) float32.
Its KV cache (under MLA the latent cache; under a sliding window a ring)
is bfloat16 whatever the activation dtype, and its recurrent caches
float32, as the reference's; ``cache_dtype`` picks another dtype for the
attention caches (float32: a decode step whose only rounding is the
activations', on which parity checks hold greedy tokens). Greedy argmax
takes the first of tied logits, as ``jnp.argmax`` does.

MoE: each admission prefills its prompt alone, so the prompt's routing
capacity and drops are the reference's; the decode step routes the slots'
tokens together with room for all of them on every expert, so it drops
none for any number of slots, as the reference's one-token steps under
``vmap`` drop none.

Under a mesh policy (``models/policy.py``; every decoder family) every
rank builds the runner alike with its own parameter shards
(``shard_params``) and drives the same scheduler with the same requests.
The slots' cache rows are split over the data group (the batch dim of
``cache_specs``), each data rank holding max_slots/D of them and 1/P of
their prefixes. A slot's prefill runs on the model group of the data rank
that holds it (its policy's data group of one rank, ``model_only``) and
its first token goes to every data rank; a decode step runs every data
rank's rows at once, and the chosen tokens are all-gathered over the data
group, so every rank's scheduler takes the same decisions. The attention caches
without a window are split (``attention.init_kv_cache``): each step
writes a slot's tail, and a slot's tail is flushed into its prefix
(``transformer.flush_tails``) at the start of the step that would
overflow it, every ``TAIL_LEN`` steps. A window's ring and the recurrent
states have no tail and are never flushed.
The reference's engine never flushes its tail (and its split decode is
right only for a prompt that fills the prefix, which its engine sizes to
max_len): this schedule is the port's own.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.partition import gather_dim
from repro_torch.models import transformer as tf_lib
from repro_torch.models.attention import TAIL_LEN
from repro_torch.models.policy import LOCAL, ParallelPolicy
from repro_torch.serve.scheduler import Scheduler

# Families Engine can decode with lm_prefill/lm_decode_step. "encdec"
# (whisper) has a separate encoder pass and its own entry points.
SERVABLE_FAMILIES = ("dense", "moe", "ssm", "hybrid")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list          # token ids
    max_tokens: int = 16
    eos_id: Optional[int] = None
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


class TransformerRunner:
    """ModelRunner for decoder-family LMs: batched greedy decode over slots.

    ``prefill_s`` and ``decode_s`` keep the host wall time of each prefill
    and each decode step; each ends in a read of the chosen tokens, which
    waits for the device, so they are end-to-end times.

    On the card, the reference's rounding also needs bf16 GEMMs that
    accumulate in f32 and round once, as XLA's do: the caller sets
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
    False`` (the entry points do); the runner leaves process-wide settings
    alone."""

    def __init__(self, cfg, params, *, max_len: int = 128, max_slots: int = 4, device=None,
                 policy: ParallelPolicy = LOCAL, cache_dtype=torch.bfloat16):
        if cfg.family not in SERVABLE_FAMILIES:
            raise ValueError(
                f"family {cfg.family!r} is not servable by the token engine "
                f"(supported: {', '.join(SERVABLE_FAMILIES)}); encoder-"
                f"decoder models go through the whisper_* entry points"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.policy = policy
        self.params = tf_lib.serving_params(params, cfg, self.device)
        self.max_len = max_len
        self._lengths = [0] * max_slots
        # each slot's valid prefix length (split caches): the prompt's, plus
        # TAIL_LEN at each flush
        self._prefix = [0] * max_slots
        self.cache = tf_lib.init_cache(cfg, max_slots, max_len, cache_dtype, device=self.device,
                                       policy=policy)
        self.split = tf_lib.has_tails(self.cache)
        # the slots whose rows this rank holds: first .. first + rows - 1
        self.rows = max_slots // policy.dp_size()
        self.first = policy.data_rank() * self.rows
        self.flushes = 0
        self.prefill_s: List[float] = []
        self.decode_s: List[float] = []

    # -- ModelRunner protocol ------------------------------------------------
    @torch.inference_mode()
    def admit(self, slot: int, req: Request) -> None:
        """Prefill the prompt and install the cache into ``slot``."""
        t0 = time.perf_counter()
        nxt = torch.zeros(1, dtype=torch.long, device=self.device)
        row = slot - self.first
        if 0 <= row < self.rows:
            tokens = torch.tensor([req.prompt], dtype=torch.long, device=self.device)
            # the prefill writes the slot's whole row: the prompt, zeros past it
            rows = tf_lib.cache_rows(self.cache, row, row + 1)
            logits, _ = tf_lib.lm_prefill(self.params, tokens, self.cfg, cache=rows,
                                          policy=self.policy.model_only())
            nxt = torch.argmax(logits[0]).reshape(1)
        if self.policy.dp_size() > 1:  # from the data rank that holds the slot
            nxt = gather_dim(nxt, 0, self.policy.data_group)[slot // self.rows]
        req.output.append(int(nxt))
        self._lengths[slot] = len(req.prompt) + 1
        self._prefix[slot] = len(req.prompt)
        self.prefill_s.append(time.perf_counter() - t0)

    @torch.inference_mode()
    def step(self, slots: Sequence[Optional[Request]], active: Sequence[int]) -> list:
        t0 = time.perf_counter()
        mine = range(self.first, self.first + self.rows)
        if self.split:
            self._flush_full_tails(slots, mine)
        tokens = torch.tensor([[slots[i].output[-1] if slots[i] else 0] for i in mine],
                              dtype=torch.long, device=self.device)
        index = [self._lengths[i] - 1 if slots[i] else 0 for i in mine]
        prefix = [self._prefix[i] if slots[i] else 0 for i in mine] if self.split else None
        logits, self.cache = tf_lib.lm_decode_step(self.params, tokens, self.cache, index, self.cfg,
                                                   policy=self.policy, prefix_len=prefix)
        nxt = torch.argmax(logits, dim=-1)
        if self.policy.dp_size() > 1:
            nxt = gather_dim(nxt, 0, self.policy.data_group)
        nxt = nxt.tolist()
        finished = []
        for i in active:
            req = slots[i]
            tok = nxt[i]
            req.output.append(tok)
            self._lengths[i] += 1
            if (
                (req.eos_id is not None and tok == req.eos_id)
                or len(req.output) >= req.max_tokens
                or self._lengths[i] >= self.max_len
            ):
                finished.append(i)
        self.decode_s.append(time.perf_counter() - t0)
        return finished

    def _flush_full_tails(self, slots, mine) -> None:
        """Flush the tail of each of this rank's active slots that holds
        ``TAIL_LEN`` entries into its prefix, before the step writes a
        new one. Every rank counts every slot's flushes alike."""
        for i, req in enumerate(slots):
            if req is not None and self._lengths[i] - 1 - self._prefix[i] == TAIL_LEN:
                if i in mine:
                    tf_lib.flush_tails(self.cache, self.cfg, i - self.first, self._prefix[i],
                                       policy=self.policy)
                self._prefix[i] += TAIL_LEN
                self.flushes += 1

    def retire(self, slot: int, req: Request) -> None:
        self._lengths[slot] = 0  # cache rows are overwritten on next admit
        self._prefix[slot] = 0


class Engine:
    """LLM serving engine: TransformerRunner behind the shared scheduler."""

    def __init__(self, cfg, params, *, max_len: int = 128, max_batch: int = 4, device=None,
                 policy: ParallelPolicy = LOCAL, cache_dtype=torch.bfloat16):
        self.cfg = cfg
        self.runner = TransformerRunner(
            cfg, params, max_len=max_len, max_slots=max_batch, device=device, policy=policy,
            cache_dtype=cache_dtype,
        )
        self.scheduler = Scheduler(self.runner, max_batch)

    # -- API (delegates to the scheduler) ------------------------------------
    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)

    def step(self) -> int:
        return self.scheduler.step()

    def run_until_done(self, max_steps: int = 1000) -> List[Request]:
        return self.scheduler.run_until_done(max_steps)

    @property
    def steps(self) -> int:
        return self.scheduler.steps

    @property
    def finished(self) -> List[Request]:
        return self.scheduler.finished

    @property
    def failed(self) -> list:
        return self.scheduler.failed

    @property
    def queue(self):
        return self.scheduler.queue

    @property
    def slots(self):
        return self.scheduler.slots
