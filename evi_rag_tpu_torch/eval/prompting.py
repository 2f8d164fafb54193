"""Prompt construction for the reasoner (JSON-answer contract).

Copy of ``evi_rag_tpu/eval/prompting.py``: evidence (triplets or path
chains) + question + an instruction demanding strict ``{"answers": [...]}``
JSON, the contract ``eval/llm_metrics.py`` parses.  ``count_tokens`` keeps
the JAX package's rule (tiktoken when it works, else ``len(text) // 4``)
but looks the encoding up once per process and model: offline, each lookup
tries to download the encoding file, and a record builds two counts per
evidence window.
"""

from __future__ import annotations

import functools
from typing import Mapping, Sequence

JSON_ANSWER_INSTRUCTION = (
    'Respond with JSON only, of the form {"answers": ["<entity>", ...]} '
    "listing every answer entity. If the evidence supports no answer, "
    'respond {"answers": []}. Copy entity strings verbatim from the evidence.'
)


def triplet_to_str(triplet: tuple[str, str, str]) -> str:
    h, r, t = triplet
    return f"({h}, {r}, {t})"


def build_triplet_prompt(
    question: str, triplets: Sequence[tuple[str, str, str]], limit: int
) -> str:
    lines = [triplet_to_str(t) for t in triplets[:limit]]
    evidence = "Triplets:\n" + "\n".join(lines) if lines else "Triplets:\n"
    return "\n\n".join([evidence, f"Question:\n{question}", JSON_ANSWER_INSTRUCTION])


def build_path_prompt(
    *,
    question: str,
    chains: Sequence[Mapping[str, object]],
    limit: int,
    include_meta: bool = False,
    instruction: str = JSON_ANSWER_INSTRUCTION,
) -> str:
    lines = []
    for i, chain in enumerate(chains[:limit], 1):
        meta = (
            f"[freq={chain.get('frequency', 0)},len={chain.get('length', 0)}] "
            if include_meta
            else ""
        )
        lines.append(f"{i}. {meta}{chain.get('chain_text', '')}")
    evidence = "Paths:\n" + "\n".join(lines)
    return "\n\n".join([evidence, f"Question:\n{question}", instruction])


@functools.lru_cache(maxsize=None)
def token_encoding(model: str):
    """The tiktoken encoding of ``model`` (``cl100k_base`` for a model
    tiktoken does not know), or None when tiktoken is absent or the lookup
    fails; either outcome is kept for the life of the process."""
    try:
        import tiktoken

        try:
            return tiktoken.encoding_for_model(model)
        except KeyError:
            return tiktoken.get_encoding("cl100k_base")
    except Exception:
        return None


def count_tokens(text: str, *, model: str = "gpt-4o-mini") -> int:
    """Token count for evidence-window budgeting: tiktoken's, or
    ``max(1, len(text) // 4)`` when tiktoken is unavailable (offline)."""
    enc = token_encoding(model)
    if enc is not None:
        try:
            return len(enc.encode(text))
        except Exception:
            pass
    return max(1, len(text) // 4)
