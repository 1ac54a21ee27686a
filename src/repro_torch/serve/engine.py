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
float32, as the reference's. Greedy argmax takes the first of tied
logits, as ``jnp.argmax`` does.

MoE: each admission prefills its prompt alone, so the prompt's routing
capacity and drops are the reference's; the decode step routes the slots'
tokens together with room for all of them on every expert, so it drops
none for any number of slots, as the reference's one-token steps under
``vmap`` drop none.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import torch

from repro_torch.common.device import resolve_device
from repro_torch.models import transformer as tf_lib
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

    def __init__(self, cfg, params, *, max_len: int = 128, max_slots: int = 4, device=None):
        if cfg.family not in SERVABLE_FAMILIES:
            raise ValueError(
                f"family {cfg.family!r} is not servable by the token engine "
                f"(supported: {', '.join(SERVABLE_FAMILIES)}); encoder-"
                f"decoder models go through the whisper_* entry points"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tf_lib.serving_params(params, cfg, self.device)
        self.max_len = max_len
        self._lengths = [0] * max_slots
        self.cache = tf_lib.init_cache(cfg, max_slots, max_len, device=self.device)
        self.prefill_s: List[float] = []
        self.decode_s: List[float] = []

    # -- ModelRunner protocol ------------------------------------------------
    @torch.inference_mode()
    def admit(self, slot: int, req: Request) -> None:
        """Prefill the prompt and install the cache into ``slot``."""
        t0 = time.perf_counter()
        tokens = torch.tensor([req.prompt], dtype=torch.long, device=self.device)
        # the prefill writes the slot's whole row: the prompt, zeros past it
        row = tf_lib.cache_rows(self.cache, slot, slot + 1)
        logits, _ = tf_lib.lm_prefill(self.params, tokens, self.cfg, cache=row)
        nxt = int(torch.argmax(logits[0]))
        req.output.append(nxt)
        self._lengths[slot] = len(req.prompt) + 1
        self.prefill_s.append(time.perf_counter() - t0)

    @torch.inference_mode()
    def step(self, slots: Sequence[Optional[Request]], active: Sequence[int]) -> list:
        t0 = time.perf_counter()
        tokens = torch.tensor([[r.output[-1] if r else 0] for r in slots],
                              dtype=torch.long, device=self.device)
        index = [self._lengths[i] - 1 if slots[i] else 0 for i in range(len(slots))]
        logits, self.cache = tf_lib.lm_decode_step(self.params, tokens, self.cache, index, self.cfg)
        nxt = torch.argmax(logits, dim=-1).tolist()
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

    def retire(self, slot: int, req: Request) -> None:
        self._lengths[slot] = 0  # cache rows are overwritten on next admit


class Engine:
    """LLM serving engine: TransformerRunner behind the shared scheduler."""

    def __init__(self, cfg, params, *, max_len: int = 128, max_batch: int = 4, device=None):
        self.cfg = cfg
        self.runner = TransformerRunner(
            cfg, params, max_len=max_len, max_slots=max_batch, device=device
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
