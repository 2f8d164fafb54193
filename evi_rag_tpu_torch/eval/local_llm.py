"""The reasoner's in-process language model: a batched engine over
``models/llm/moonlight.py`` (Moonlight-16B-A3B, ``deepseek_v3``) or
``models/llm/kimi_linear.py`` (Kimi-Linear-48B-A3B, ``kimi_linear``), picked
by the model file's ``model_type``, and the ``local`` chat backend built on
it.

``LocalLLM.batch(conversations)`` renders each chat into text, tokenises
it, prefills the prompts into the model's cache (Moonlight: the latent
rows of every layer; Kimi-Linear: the latent rows of its MLA layers beside
the recurrent and conv states of its KDA layers) in chunks of whole
sequences that fit ``prefill_tokens`` (the longest first, each chunk one
right-padded block for attention and its real tokens alone for everything
else), then decodes greedily ``max_tokens`` new tokens for every sequence,
one batched step at a time through the cache (the absorbed form; on a card
each step after the first replays a CUDA graph of it).  Random weights
never emit an end token, so no sequence stops early.

The tokenizer is a stand-in until the model's own files are in the
repository: one id per 4 bytes of UTF-8 (``count_tokens``' offline rate),
the little-endian word modulo the vocabulary; its decode writes ``<id>``
per id, as one answer in the reasoner's JSON contract.

Spans and counters (``utils/profiling.py``; recorded only under a
profiler): ``reason.tokenize`` (per batch), ``reason.prefill`` (per chunk),
``reason.decode`` (per step; the last one holds the copy of the tokens to
the host); ``reason.sequences``, ``reason.tokens.prefill`` (prompt tokens),
``reason.tokens.decode`` (tokens through decode steps),
``reason.ctx.prefill`` (causal (query, key) pairs of the prompts, per
layer), ``reason.ctx.decode`` (cache rows read by decode steps, per layer),
``moe.experts.touched`` (held experts with a token, summed over the MoE
layers of each decode step), ``moe.tokens.max`` and ``moe.tokens.routed``
(the busiest held expert's tokens and the (token, expert) pairs routed to
held experts, summed over the MoE layers of each prefill chunk), with a
share of the experts ``moe.tokens.routed.decode`` (the pairs routed to held
experts, summed over the MoE layers of each decode step); with KDA
layers ``kda.tokens.prefill`` / ``kda.tokens.decode`` (tokens x KDA layers
through the recurrence) and ``kda.states.prefill`` / ``kda.states.decode``
(sequence x layer state loads, each followed by one store).  Every count is
a host integer; only the ``moe.*`` counts wait on the card, and only under
a profiler.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Sequence

import numpy as np
import torch

from evi_rag_tpu_torch.models.llm import module_of, moonlight, read_model_file
from evi_rag_tpu_torch.models.llm.config import KimiLinearConfig, MoonlightConfig
from evi_rag_tpu_torch.utils import profiling

Message = dict[str, str]


class StandInTokenizer:
    """One id per 4 bytes of UTF-8 (zero-padded), modulo ``vocab_size``."""

    def __init__(self, vocab_size: int):
        self.vocab_size = int(vocab_size)

    def encode(self, text: str) -> np.ndarray:
        raw = text.encode()
        raw += b"\0" * (-len(raw) % 4)
        return (np.frombuffer(raw, dtype="<u4") % self.vocab_size).astype(np.int64)

    def decode(self, ids: Sequence[int]) -> str:
        """The ids as one answer of the reasoner's JSON contract
        (``{"answers": ["<id><id>..."]}``): the stand-in has no text for an
        id, and the reasoner's strict parse then reads a reply."""
        return json.dumps({"answers": ["".join(f"<{int(i)}>" for i in ids)]})


def render_chat(messages: Sequence[Message]) -> str:
    """Moonlight's chat layout in text: each message between its role
    markers, then the assistant's opening."""
    parts = [f"<|im_{m['role']}|>{m['role']}<|im_middle|>{m['content']}<|im_end|>" for m in messages]
    return "".join(parts) + "<|im_assistant|>assistant<|im_middle|>"


def plan_chunks(lengths: Sequence[int], budget: int) -> list[list[int]]:
    """Sequences, longest first, cut into chunks whose padded block
    (sequences x longest) holds at most ``budget`` tokens; a sequence longer
    than the budget is a chunk alone."""
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    chunks: list[list[int]] = []
    for i in order:
        if chunks and (len(chunks[-1]) + 1) * lengths[chunks[-1][0]] <= budget:
            chunks[-1].append(i)
        else:
            chunks.append([i])
    return chunks


def chunk_inputs(prompts: Sequence[np.ndarray], chunk: Sequence[int], dev):
    """A prefill chunk's arguments: (flat ids [N], their sequences [N] and
    positions [N], their places in the right-padded block [N], the block's
    sequences and width, each sequence's last token [b])."""
    cl = [len(prompts[i]) for i in chunk]
    lc = max(cl)
    put = lambda x: torch.as_tensor(x).to(dev, non_blocking=True)  # noqa: E731
    return (put(np.concatenate([prompts[i] for i in chunk])),
            put(np.repeat(np.asarray(chunk, dtype=np.int64), cl)),
            put(np.concatenate([np.arange(m) for m in cl])),
            put(np.concatenate([j * lc + np.arange(m) for j, m in enumerate(cl)])),
            len(chunk), lc, put(np.cumsum(cl) - 1))


@dataclasses.dataclass
class Kept:
    """What ``generate`` keeps of the sequences asked for, in their order:
    ``logits`` [S, n, V] (f32) at the last prompt position and each decode
    step; ``routes`` [S] of [MoE layers, prompt + n - 1, k], the experts
    each position chose in each MoE layer; ``states`` [S] of each one's KDA
    states after its prompt [KDA layers, H, d, d] (f32; None without KDA
    layers)."""

    logits: torch.Tensor
    routes: list
    states: list | None = None


class _Decoder:
    """The decode step of one batch over static tensors: the current token
    and position of every sequence and the whole cache (rows past each
    position masked).  A step writes the next tokens into ``cur`` and
    advances ``pos``.  On a card the first step runs eagerly on a side
    stream and the rest replay a CUDA graph of it captured then: a step is
    ~2k small operations, whose launches would hold the card back."""

    def __init__(self, model, w, cfg, first: torch.Tensor, pos: torch.Tensor, cache):
        self.model, self.w, self.cfg, self.cache = model, w, cfg, cache
        self.cur, self.pos = first.clone(), pos
        self.graph = self.out = None

    def _step(self):
        rec = moonlight.Record(load=True, routes=True)
        logits = self.model.decode(self.w, self.cfg, self.cur, self.pos, self.cache, rec)
        self.cur.copy_(logits.argmax(-1))
        self.pos.add_(1)
        return logits, rec

    def __call__(self):
        """(logits [B, V], the step's ``Record``); both are overwritten by
        the next step on a card."""
        if self.graph is not None:
            self.graph.replay()
            return self.out
        dev = self.cur.device
        if dev.type != "cuda":
            return self._step()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            first = self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = self._step()
        return first


class LocalLLM:
    """A chat backend that runs the model in this process (``init_llm``
    with ``backend="local"``)."""

    def __init__(self, cfg: MoonlightConfig | KimiLinearConfig, weights: dict[str, torch.Tensor], *,
                 max_tokens: int, max_batch: int = 48, prefill_tokens: int = 32768):
        self.cfg, self.weights, self.model = cfg, weights, module_of(cfg)
        self.device = weights["embed"].device
        self.tokenizer = StandInTokenizer(cfg.vocab_size)
        self.max_tokens, self.max_batch, self.prefill_tokens = int(max_tokens), int(max_batch), int(prefill_tokens)

    @classmethod
    def from_config(cls, config: dict, *, seed: int, device, dtype: str = "bfloat16", **kw) -> "LocalLLM":
        cfg = read_model_file(config)
        return cls(cfg, module_of(cfg).init_weights(cfg, seed, device, getattr(torch, dtype)), **kw)

    @classmethod
    def from_file(cls, path: str | pathlib.Path, **kw) -> "LocalLLM":
        return cls.from_config(json.loads(pathlib.Path(path).read_text()), **kw)

    def __call__(self, messages: list[Message]) -> str:
        return self.batch([messages])[0]

    def batch(self, conversations: Sequence[Sequence[Message]]) -> list[str]:
        """One reply a conversation, all decoded together."""
        return self.run(conversations)[0]

    def run(self, conversations: Sequence[Sequence[Message]], keep: Sequence[int] = ()):
        """``batch`` with what it computed: (replies, prompt ids, new ids,
        ``generate``'s ``Kept`` of the conversations ``keep``)."""
        with profiling.span("reason.tokenize"):
            prompts = [self.tokenizer.encode(render_chat(m)) for m in conversations]
        tokens, kept = self.generate(prompts, keep)
        return [self.tokenizer.decode(t) for t in tokens], prompts, tokens, kept

    @torch.no_grad()
    def generate(self, prompts: Sequence[np.ndarray], keep: Sequence[int] = ()):
        """Greedy ``max_tokens`` new ids for each prompt: (ids [B, n] on the
        host, ``Kept`` of the sequences ``keep`` or None)."""
        cfg, w, dev, n, model = self.cfg, self.weights, self.device, self.max_tokens, self.model
        lens = [len(p) for p in prompts]
        bsz, t_max = len(prompts), max(lens) + n
        if min(lens) < 1 or t_max > cfg.max_positions:
            raise ValueError(f"prompts of {min(lens)}-{max(lens)} tokens and {n} new ones do not fit "
                             f"{cfg.max_positions} positions")
        cache = model.new_cache(cfg, bsz, t_max, w["embed"].dtype, dev)
        n_kda = len(getattr(cfg, "kda_layers", ()))
        out = torch.empty(bsz, n, dtype=torch.long, device=dev)
        kept = None
        if len(keep):
            kept = Kept(torch.empty(len(keep), n, cfg.vocab_size, device=dev), [[] for _ in keep],
                        [None] * len(keep) if n_kda else None)
        where = {s: j for j, s in enumerate(keep)}
        held = cfg.n_routed_experts
        for chunk in plan_chunks(lens, self.prefill_tokens):
            with profiling.span("reason.prefill"):
                mine = [(j, where[s]) for j, s in enumerate(chunk) if s in where]
                rec = moonlight.Record(load=profiling.enabled(), routes=bool(mine))
                cl = [lens[i] for i in chunk]
                ids, seq, pos, pad, b, lc, last = chunk_inputs(prompts, chunk, dev)
                logits = model.prefill(w, cfg, ids, seq, pos, pad, b, lc, cache, last, rec)
                out[torch.tensor(chunk, device=dev), 0] = logits.argmax(-1)
                if mine:
                    routes, starts = torch.stack(rec.routes), np.cumsum([0] + cl)
                    for j, k in mine:
                        kept.logits[k, 0] = logits[j].float()
                        kept.routes[k].append(routes[:, starts[j]:starts[j + 1]])
                        if kept.states is not None:
                            kept.states[k] = cache.state[:, chunk[j]].clone()
                if rec.load is not None:
                    load = torch.stack(rec.load)[:, :held]
                    busiest, routed = torch.stack((load.max(1).values.sum(), load.sum())).tolist()
                    profiling.count("moe.tokens.max", busiest)
                    profiling.count("moe.tokens.routed", routed)
                    profiling.count("reason.tokens.prefill", sum(cl))
                    profiling.count("reason.ctx.prefill", sum(m * (m + 1) // 2 for m in cl))
                    if n_kda:
                        profiling.count("kda.tokens.prefill", sum(cl) * n_kda)
                        profiling.count("kda.states.prefill", len(cl) * n_kda)
        profiling.count("reason.sequences", bsz)
        step = _Decoder(model, w, cfg, out[:, 0], torch.tensor(lens, device=dev), cache)
        host = None
        kept_rows = torch.tensor(list(keep), device=dev, dtype=torch.long) if len(keep) else None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # decode's spans start with the card free
        for t in range(1, n):
            with profiling.span("reason.decode"):
                logits, rec = step()
                out[:, t] = step.cur
                if kept is not None:
                    kept.logits[:, t] = logits.index_select(0, kept_rows).float()
                    routes = torch.stack(rec.routes).index_select(1, kept_rows)
                    for k in range(len(keep)):
                        kept.routes[k].append(routes[:, k:k + 1])
                if profiling.enabled():
                    load = torch.stack(rec.load)[:, :held]
                    touched, routed = torch.stack(((load > 0).sum(), load.sum())).tolist()
                    profiling.count("moe.experts.touched", touched)
                    if held < cfg.router_experts:
                        profiling.count("moe.tokens.routed.decode", routed)
                    profiling.count("reason.tokens.decode", bsz)
                    profiling.count("reason.ctx.decode", sum(lens) + bsz * t)
                    if n_kda:
                        profiling.count("kda.tokens.decode", bsz * n_kda)
                        profiling.count("kda.states.decode", bsz * n_kda)
                if t == n - 1:
                    host = out.cpu().numpy()
        if host is None:
            host = out.cpu().numpy()
        if kept is not None:
            kept.routes = [torch.cat(r, 1) for r in kept.routes]
        return host, kept
