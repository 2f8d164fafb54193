"""End-to-end QA scoring + semantic-dissipation decomposition.

Copy of ``evi_rag_tpu/eval/llm_metrics.py`` (the reference evaluation
protocol, ``src/utils/llm_metrics.py:276-438``):

* predictions must be strict JSON objects ``{"answers": [...]}``; nested
  dicts/lists are coerced through the answer-ish keys;
* answers match after article/punctuation-stripping normalization, by
  equality or gold-substring-of-prediction;
* list P/R/F1 uses greedy one-to-one matching; set variants deduplicate by
  normalized form; ``set_exact`` compares normalized sets;
* semantic dissipation per split/window k:
    S_ret_set  = P(answer in retrieved set)
    S_ret_vis  = P(answer in *visible* evidence window)
    d_rate     = 1 - E[F1 | hit_vis]          (reasoning dissipation)
    d_mass     = S_ret_vis * d_rate
    l_leak     = (1 - S_ret_vis) * E[F1 | miss]   (answers w/o evidence)
    l_iface    = S_ret_set - S_ret_vis            (interface loss)
* token-budget bookkeeping: avg evidence/prompt tokens, truncation rate.

Every required field is validated fail-fast with the sample id in the error,
matching the reference's strictness (SURVEY §4).
"""

from __future__ import annotations

import json
import re
import string
from collections import defaultdict
from typing import Any, Iterable

_PUNCT = str.maketrans("", "", string.punctuation)
_ARTICLES = re.compile(r"\b(a|an|the)\b")


class PredictionParseError(ValueError):
    pass


def normalize_answer(text: str) -> str:
    text = text.lower().translate(_PUNCT)
    text = _ARTICLES.sub(" ", text)
    return " ".join(text.split())


def _coerce(item: Any) -> list[str]:
    if item is None:
        return []
    if isinstance(item, dict):
        for key in ("answers", "answer", "text", "name", "entity"):
            if key in item:
                return _coerce(item[key])
        return []
    if isinstance(item, (list, tuple)):
        return [s for sub in item for s in _coerce(sub)]
    if isinstance(item, set):
        return [s for sub in sorted(item) for s in _coerce(sub)]
    text = (item if isinstance(item, str) else str(item)).strip()
    return [text] if text else []


def parse_prediction(raw: Any) -> list[str]:
    """Strict ``{"answers": [...]}`` JSON parse -> flat answer strings."""
    if raw is None:
        raise PredictionParseError("prediction is None")
    text = str(raw).strip()
    if not text:
        raise PredictionParseError("prediction is empty")
    try:
        parsed = json.loads(text)
    except json.JSONDecodeError as exc:
        raise PredictionParseError("prediction must be JSON with 'answers'") from exc
    if not isinstance(parsed, dict) or "answers" not in parsed:
        raise PredictionParseError("JSON root must be an object with key 'answers'")
    answers = parsed["answers"]
    if not isinstance(answers, list):
        raise PredictionParseError(f"'answers' must be a list, got {type(answers).__name__}")
    return [s for item in answers for s in _coerce(item)]


def answers_match(pred: str, gold: str) -> bool:
    # Exact reference semantics (``llm_metrics.py:79-80``): equality OR
    # gold-substring-of-prediction, with NO empty-gold guard — a gold whose
    # normalization is empty (e.g. "the") matches every prediction.  Kept
    # verbatim so published numbers are comparable.
    p, g = normalize_answer(pred), normalize_answer(gold)
    return p == g or g in p


def _greedy_prf(preds: list[str], golds: list[str]) -> tuple[float, float, float]:
    if not golds:
        return 0.0, 0.0, 0.0
    pool = list(preds)
    matched = 0
    for g in golds:
        for i, p in enumerate(pool):
            if answers_match(p, g):
                matched += 1
                pool.pop(i)
                break
    prec = matched / max(len(preds), 1)
    rec = matched / len(golds)
    f1 = 0.0 if prec + rec == 0 else 2 * prec * rec / (prec + rec)
    return prec, rec, f1


def _dedupe(values: list[str]) -> list[str]:
    seen: set[str] = set()
    out = []
    for v in values:
        n = normalize_answer(v)
        if n and n not in seen:
            seen.add(n)
            out.append(v)
    return out


def score_answers(preds: list[str], golds: list[str]) -> dict[str, float]:
    if not golds:
        return {k: 0.0 for k in (
            "hit", "precision", "recall", "f1",
            "set_precision", "set_recall", "set_f1", "set_exact",
        )}
    hit = float(any(answers_match(p, g) for p in preds for g in golds)) if preds else 0.0
    prec, rec, f1 = _greedy_prf(preds, golds)
    sp, sr, sf1 = _greedy_prf(_dedupe(preds), _dedupe(golds))
    pn = {normalize_answer(p) for p in preds if normalize_answer(p)}
    gn = {normalize_answer(g) for g in golds if normalize_answer(g)}
    return {
        "hit": hit, "precision": prec, "recall": rec, "f1": f1,
        "set_precision": sp, "set_recall": sr, "set_f1": sf1,
        "set_exact": float(pn == gn),
    }


class SemanticAccumulator:
    """Streaming semantic-dissipation statistics."""

    def __init__(self) -> None:
        self.total = 0
        self.with_gt = 0
        self.set_hit = 0.0
        self.vis_hit = 0.0
        self.hit_score = 0.0
        self.hit_n = 0
        self.miss_score = 0.0
        self.miss_n = 0
        self.sums: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.truncated = 0

    def update(
        self,
        *,
        score_f1: float | None,
        hit_set: bool | None,
        hit_vis: bool | None,
        evidence_tokens: int | None,
        prompt_tokens: int | None,
        token_budget: int | None,
        k_visible: int | None,
        evidence_truncated: bool,
    ) -> None:
        self.total += 1
        for name, v in (
            ("evidence_tokens", evidence_tokens),
            ("prompt_tokens", prompt_tokens),
            ("token_budget", token_budget),
            ("k_visible", k_visible),
        ):
            if v is not None:
                self.sums[name] += int(v)
                self.counts[name] += 1
        if evidence_truncated:
            self.truncated += 1
        if hit_set is None or hit_vis is None or score_f1 is None:
            return
        self.with_gt += 1
        self.set_hit += float(hit_set)
        self.vis_hit += float(hit_vis)
        if hit_vis:
            self.hit_score += score_f1
            self.hit_n += 1
        else:
            self.miss_score += score_f1
            self.miss_n += 1

    def finalize(self, prefix: str) -> dict[str, float]:
        out = {f"{prefix}/total": float(self.total), f"{prefix}/with_gt": float(self.with_gt)}
        if self.with_gt:
            s_set = self.set_hit / self.with_gt
            s_vis = self.vis_hit / self.with_gt
            acc_hit = self.hit_score / (self.hit_n or 1)
            acc_miss = self.miss_score / (self.miss_n or 1)
        else:
            s_set = s_vis = acc_hit = acc_miss = 0.0
        out[f"{prefix}/s_ret_set"] = s_set
        out[f"{prefix}/s_ret_vis"] = s_vis
        out[f"{prefix}/acc_hit"] = acc_hit
        out[f"{prefix}/acc_miss"] = acc_miss
        out[f"{prefix}/d_rate"] = (1.0 - acc_hit) if self.with_gt else 0.0
        out[f"{prefix}/d_mass"] = s_vis * (1.0 - acc_hit) if self.with_gt else 0.0
        out[f"{prefix}/l_leak"] = (1.0 - s_vis) * acc_miss if self.with_gt else 0.0
        out[f"{prefix}/l_iface"] = s_set - s_vis if self.with_gt else 0.0
        if self.counts["prompt_tokens"]:
            out[f"{prefix}/avg_prompt_tokens"] = self.sums["prompt_tokens"] / self.counts["prompt_tokens"]
        if self.counts["evidence_tokens"]:
            out[f"{prefix}/avg_evidence_tokens"] = self.sums["evidence_tokens"] / self.counts["evidence_tokens"]
        if self.counts["token_budget"]:
            out[f"{prefix}/avg_token_budget"] = self.sums["token_budget"] / self.counts["token_budget"]
            out[f"{prefix}/truncation_rate"] = self.truncated / self.counts["token_budget"]
        if self.counts["k_visible"]:
            out[f"{prefix}/avg_k_visible"] = self.sums["k_visible"] / self.counts["k_visible"]
        return out


_REQUIRED_FIELDS = (
    "hit_set", "hit_vis", "visible_edge_ids", "evidence_token_count",
    "prompt_token_count", "token_budget", "evidence_truncated",
)
_ANSWER_KEYS = (
    "hit", "precision", "recall", "f1",
    "set_precision", "set_recall", "set_f1", "set_exact",
)
_ANSWER_METRIC_NAMES = {
    "hit": "hit", "precision": "macro_precision", "recall": "macro_recall",
    "f1": "macro_f1", "set_precision": "answer_set_precision",
    "set_recall": "answer_set_recall", "set_f1": "answer_set_f1",
    "set_exact": "answer_set_exact",
}


def _as_int_list(values: Any) -> list[int]:
    """Reference ``_as_int_list`` (``llm_metrics.py:152-158``): lists keep
    their non-None entries int-coerced (an un-coercible LIST entry raises,
    exactly as the reference comprehension does); an un-coercible SCALAR
    counts as empty."""
    if values is None:
        return []
    if isinstance(values, (list, tuple)):
        return [int(v) for v in values if v is not None]
    try:
        return [int(values)]
    except (TypeError, ValueError):
        return []


def _require_bool(value: Any, name: str, sample_id: str) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, int) and value in (0, 1):
        return bool(value)
    raise ValueError(f"{name} must be bool/0/1 for id={sample_id}, got {value!r}")


def evaluate_predictions(predictions: Iterable[dict[str, Any]]) -> dict[str, float]:
    """Answer metrics + semantic dissipation, global and per window_k."""
    answer_lists: dict[str, list[float]] = {k: [] for k in _ANSWER_KEYS}
    by_window: dict[int, dict[str, list[float]]] = {}
    sem_global = SemanticAccumulator()
    sem_by_window: dict[int, SemanticAccumulator] = {}
    total = 0

    for item in predictions:
        if "id" not in item:
            raise ValueError("missing id in prediction item")
        sid = str(item["id"])
        golds_raw = item.get("answers")
        if not isinstance(golds_raw, list) or not golds_raw:
            raise ValueError(f"gold answers must be a non-empty list for id={sid}")
        golds: list[str] = []
        for i, g in enumerate(golds_raw):
            if not isinstance(g, str) or not g.strip():
                raise ValueError(f"gold answers[{i}] invalid for id={sid}")
            golds.append(g.strip())
        try:
            preds = parse_prediction(item.get("prediction"))
        except PredictionParseError as exc:
            raise ValueError(f"prediction parse failed for id={sid}: {exc}") from exc

        score = score_answers(preds, golds)
        total += 1
        for key in _ANSWER_KEYS:
            answer_lists[key].append(score[key])

        for field in _REQUIRED_FIELDS:
            if field not in item:
                raise ValueError(f"missing {field} for id={sid}")
        hit_set = _require_bool(item["hit_set"], "hit_set", sid)
        hit_vis = _require_bool(item["hit_vis"], "hit_vis", sid)
        try:
            visible = _as_int_list(item["visible_edge_ids"])
        except (TypeError, ValueError) as exc:
            raise ValueError(f"visible_edge_ids invalid for id={sid}: {exc}") from exc
        kwargs = dict(
            score_f1=score["f1"],
            hit_set=hit_set,
            hit_vis=hit_vis,
            evidence_tokens=item["evidence_token_count"],
            prompt_tokens=item["prompt_token_count"],
            token_budget=item["token_budget"],
            k_visible=len(visible),
            evidence_truncated=bool(item["evidence_truncated"]),
        )
        sem_global.update(**kwargs)

        wk = item.get("window_k")
        if wk is not None:
            wk = int(wk)
            stats = by_window.setdefault(wk, {k: [] for k in _ANSWER_KEYS})
            for key in _ANSWER_KEYS:
                stats[key].append(score[key])
            sem_by_window.setdefault(wk, SemanticAccumulator()).update(**kwargs)

    def mean(xs: list[float]) -> float:
        return float(sum(xs) / len(xs)) if xs else 0.0

    metrics: dict[str, float] = {
        f"results/{_ANSWER_METRIC_NAMES[k]}": mean(answer_lists[k]) for k in _ANSWER_KEYS
    }
    metrics["results/total"] = float(total)
    metrics.update(sem_global.finalize("semantic"))
    for wk in sorted(by_window):
        for k in _ANSWER_KEYS:
            metrics[f"results/window_{wk}/{_ANSWER_METRIC_NAMES[k]}"] = mean(by_window[wk][k])
        metrics[f"results/window_{wk}/total"] = float(len(by_window[wk]["hit"]))
        metrics.update(sem_by_window[wk].finalize(f"semantic/window_{wk}"))
    return metrics
