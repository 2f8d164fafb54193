"""Pluggable chat backends for the reasoner.

Copy of ``evi_rag_tpu/eval/llm_client.py`` (the reference ``init_llm`` /
``run_chat``, ``src/utils/llm_client.py:17-124``).  Backends:

* ``ollama``  -- local HTTP via urllib;
* ``openai``  -- OpenAI API (import-gated: raises a clear error if the
  package is absent);
* ``vllm``    -- GPU serving (``tensor_parallel_size`` passthrough);
  import-gated;
* ``mock``    -- deterministic canned-response backend for tests/CI.

No backend falls back to another.  ``backend="auto"`` resolves like the
reference: "gpt" in the model name => openai, else vllm.  Rate-limit retry
uses exponential backoff.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Protocol
from urllib import error, request

Message = dict[str, str]


class ChatBackend(Protocol):
    def __call__(self, messages: list[Message]) -> str: ...


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    model_name: str
    backend: str = "auto"  # auto|ollama|vllm|openai|mock
    temperature: float = 0.0
    max_tokens: int = 1024
    max_seq_len: int = 4096
    frequency_penalty: float = 0.0
    seed: int = 0
    tensor_parallel_size: int = 1
    ollama_base_url: str = "http://localhost:11434"
    ollama_timeout: float = 120.0
    mock_response: str = '{"answers": []}'


def init_llm(cfg: LLMConfig) -> ChatBackend:
    backend = cfg.backend
    if backend == "auto":
        backend = "openai" if "gpt" in cfg.model_name else "vllm"

    if backend == "mock":
        def _mock(messages: list[Message]) -> str:
            return cfg.mock_response
        return _mock

    if backend == "ollama":
        model = cfg.model_name.split(":", 1)[-1] if cfg.model_name.startswith("ollama:") else cfg.model_name

        def _ollama(messages: list[Message]) -> str:
            payload = {
                "model": model,
                "messages": messages,
                "stream": False,
                "options": {
                    "temperature": cfg.temperature,
                    "num_predict": cfg.max_tokens,
                    "frequency_penalty": cfg.frequency_penalty,
                },
            }
            req = request.Request(
                url=f"{cfg.ollama_base_url}/api/chat",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            try:
                with request.urlopen(req, timeout=cfg.ollama_timeout) as resp:
                    data = json.loads(resp.read().decode())
            except error.HTTPError as exc:
                raise RuntimeError(f"ollama HTTP error: {exc.code} {exc.reason}") from exc
            except error.URLError as exc:
                raise RuntimeError(f"ollama connection failed: {exc.reason}") from exc
            content = (data.get("message") or {}).get("content")
            if content is None:
                raise ValueError("unexpected ollama response: missing message.content")
            return str(content)

        return _ollama

    if backend == "openai":
        try:
            from openai import OpenAI
        except ImportError as exc:
            raise RuntimeError("backend='openai' requires the openai package") from exc
        client = OpenAI()

        def _openai(messages: list[Message]) -> str:
            out = client.chat.completions.create(
                model=cfg.model_name,
                messages=messages,
                seed=cfg.seed,
                temperature=cfg.temperature,
                max_tokens=cfg.max_tokens,
            )
            return out.choices[0].message.content or ""

        return _openai

    if backend == "vllm":
        try:
            from vllm import LLM, SamplingParams
        except ImportError as exc:
            raise RuntimeError(
                "backend='vllm' requires the vllm package (GPU serving); "
                "use 'ollama'/'openai'/'mock' in this environment"
            ) from exc
        client = LLM(
            model=cfg.model_name,
            tensor_parallel_size=cfg.tensor_parallel_size,
            max_seq_len_to_capture=cfg.max_seq_len,
        )
        params = SamplingParams(
            temperature=cfg.temperature,
            max_tokens=cfg.max_tokens,
            frequency_penalty=cfg.frequency_penalty,
        )

        def _vllm(messages: list[Message]) -> str:
            out = client.chat(messages=messages, sampling_params=params, use_tqdm=False)
            return out[0].outputs[0].text

        return _vllm

    raise ValueError(f"unknown backend {cfg.backend!r}")


def run_chat(
    llm: ChatBackend,
    messages: list[Message],
    *,
    max_retries: int = 3,
    retryable: tuple[type[Exception], ...] = (RuntimeError,),
) -> str:
    """Chat with exponential-backoff retry on transient errors."""
    for attempt in range(max_retries + 1):
        try:
            return llm(messages)
        except retryable:
            if attempt == max_retries:
                raise
            time.sleep(2 ** (attempt + 1))
    raise AssertionError("unreachable")
