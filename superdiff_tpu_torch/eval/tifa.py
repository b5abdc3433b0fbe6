"""TIFA faithfulness evaluation: VQA-based scoring of composed images
(the port's own copy of ``superdiff_tpu/eval/tifa.py``, host-side Python
with the same public names and outputs).

Rebuild of ``applications/images/tifa_eval.py`` plus the scoring/filtering
behavior it delegates to the ``tifascore`` package. The reference chain is:
GPT question generation -> UnifiedQA consistency filtering
(``tifa_eval.py:51,59``) -> per-image mPLUG VQA scoring via
``tifa_score_single`` (``tifa_eval.py:76-89``) -> min/max aggregation over
the two prompt phrasings -> per-method mean +/- std over 20 seeds
(``tifa_eval.py:104-106``).

All of that protocol is implemented natively here against three injectable
callables, so the entire chain executes end-to-end without the gated
models; only the weights stay external:

* ``vqa_fn(image, question, choices) -> str`` — free-form VQA answer
  (mPLUG in the reference).
* ``qa_fn(context, question, choices) -> str`` — text-only QA used for the
  UnifiedQA consistency filter.
* ``question_gen(caption) -> [qa dicts]`` — GPT-3.5 in the reference; the
  qa-dict schema is the tifascore one (caption/element/question/choices/
  answer/element_type, see ``tifa_eval.py:17-20``).

``make_tifascore_callables`` adapts the real tifascore models into these
seams when the package + weights are present.
"""

from __future__ import annotations

import difflib
import json
import os
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

# Methods the reference loops over per task (tifa_eval.py:71).
REFERENCE_METHODS = ("or", "sd_ab_or", "sd_ba_or", "sd_a", "sd_b")

_ARTICLE_RE = re.compile(r"\b(a|an|the)\b")
_PUNCT_RE = re.compile(r"[^\w\s]")


def _normalize(text: str) -> str:
    """Lowercase, strip punctuation/articles, collapse whitespace — the
    standard VQA answer normalization used before choice matching."""
    t = _PUNCT_RE.sub(" ", text.lower())
    t = _ARTICLE_RE.sub(" ", t)
    return " ".join(t.split())


def match_choice(free_form_answer: str, choices: Sequence[str]) -> str:
    """Map a free-form VQA answer onto the question's multiple choices.

    Ordered exactly like tifascore's answer matching: exact normalized
    match, then containment either way, then highest string similarity.
    Deterministic: ties keep the earliest choice.
    """
    ans = _normalize(free_form_answer)
    norm = [_normalize(c) for c in choices]
    for c, n in zip(choices, norm):
        if ans == n:
            return c
    # containment on word boundaries only: 'no' must not match inside
    # 'cannot tell', and an empty normalized answer matches nothing
    ans_words, ans_padded = set(ans.split()), f" {ans} "
    for c, n in zip(choices, norm):
        if not n or not ans:
            continue
        if (n in ans_words) or (f" {n} " in ans_padded) or (ans in n.split()):
            return c
    sims = [difflib.SequenceMatcher(None, ans, n).ratio() for n in norm]
    return choices[int(np.argmax(sims))]


def tifa_score_single(
    vqa_fn: Callable[[str, str, Sequence[str]], str],
    question_answer_pairs: List[dict],
    image: str,
) -> Dict:
    """Per-image TIFA score: fraction of questions the VQA model answers
    correctly after choice matching.

    Output schema mirrors tifascore's ``tifa_score_single`` (consumed at
    ``tifa_eval.py:76-89``): ``tifa_score`` plus per-question details.
    """
    details: Dict[str, Dict] = {}
    correct = []
    for qa in question_answer_pairs:
        q, choices, answer = qa["question"], qa["choices"], qa["answer"]
        free_form = vqa_fn(image, q, choices)
        chosen = match_choice(free_form, choices)
        ok = _normalize(chosen) == _normalize(answer)
        correct.append(ok)
        details[q] = {
            "element": qa.get("element"),
            "element_type": qa.get("element_type"),
            "free_form_vqa": free_form,
            "multiple_choice_vqa": chosen,
            "answer": answer,
            "scores": float(ok),
        }
    score = float(np.mean(correct)) if correct else 0.0
    return {"tifa_score": score, "question_details": details}


def filter_question_and_answers(
    qa_fn: Callable[[str, str, Sequence[str]], str],
    questions: List[dict],
) -> List[dict]:
    """UnifiedQA consistency filter (``tifa_eval.py:51``): keep a generated
    question only if the text-QA model, reading the *caption* it was
    generated from, reproduces the expected answer. Drops hallucinated or
    ambiguous generations before any image is scored."""
    kept = []
    for qa in questions:
        predicted = qa_fn(qa["caption"], qa["question"], qa["choices"])
        chosen = match_choice(predicted, qa["choices"])
        if _normalize(chosen) == _normalize(qa["answer"]):
            kept.append(qa)
    return kept


def tifa_for_pair(
    score_fn: Callable[[str, str], float],
    image_path: str,
    prompt_ab: str,
    prompt_ba: str,
) -> Dict[str, float]:
    """Score one image against both phrasings; min = faithful-to-both (AND),
    max = faithful-to-either (OR) — ``tifa_eval.py:80-88`` aggregation."""
    s_ab = score_fn(image_path, prompt_ab)
    s_ba = score_fn(image_path, prompt_ba)
    return {
        "tifa_ab": s_ab,
        "tifa_ba": s_ba,
        "tifa_min": min(s_ab, s_ba),
        "tifa_max": max(s_ab, s_ba),
    }


def run_tifa_task(
    vqa_fn: Callable[[str, str, Sequence[str]], str],
    questions_ab: List[dict],
    questions_ba: List[dict],
    images_by_method: Dict[str, Sequence[str]],
) -> Dict[str, Dict]:
    """The per-task image loop of ``tifa_eval.py:70-106``: for every method
    and seed image, score against both phrasings' filtered questions and
    collect min/max/all, then summarize min as mean +/- std per method.

    Returns ``{"scores": {method: {min, max, all}}, "summary": {method:
    {mean, std, n}}}`` with the min-side question details of the last image
    kept per method (the reference logs them per image)."""
    score_dict: Dict[str, Dict] = {}
    for method, images in images_by_method.items():
        rows = {"min": [], "max": [], "all": []}
        last_detail = None
        for img in images:
            result_ab = tifa_score_single(vqa_fn, questions_ab, img)
            result_ba = tifa_score_single(vqa_fn, questions_ba, img)
            s_ab = result_ab["tifa_score"]
            s_ba = result_ba["tifa_score"]
            rows["min"].append(min(s_ab, s_ba))
            rows["max"].append(max(s_ab, s_ba))
            rows["all"].append((s_ab, s_ba))
            # tifa_eval.py:84-87 keeps the min-side result for logging.
            last_detail = result_ab if s_ab <= s_ba else result_ba
        rows["min_detail"] = last_detail
        score_dict[method] = rows
    summary = {
        m: {
            "mean": float(np.mean(r["min"])) if r["min"] else 0.0,
            "std": float(np.std(r["min"])) if r["min"] else 0.0,
            "n": len(r["min"]),
        }
        for m, r in score_dict.items()
    }
    return {"scores": score_dict, "summary": summary}


def run_tifa_experiment(
    taskinfo: List[dict],
    question_gen: Callable[[str], List[dict]],
    qa_fn: Callable[[str, str, Sequence[str]], str],
    vqa_fn: Callable[[str, str, Sequence[str]], str],
    image_path_fn: Callable[[str, str, int], str],
    n_images: int = 20,
    methods: Sequence[str] = REFERENCE_METHODS,
    q_dir: Optional[str] = None,
    manual_questions: Optional[Dict[str, List[dict]]] = None,
) -> Dict[str, Dict]:
    """The full ``tifa_eval.py`` driver over a taskinfo table
    (``[{dir_, text_AB, text_BA}, ...]``, the ``taskinfo.json`` schema).

    Per task: generate + filter questions for both phrasings (with the
    reference's manual-question override seam for tasks whose generation
    failed, ``tifa_eval.py:43-46``), persist them under ``q_dir`` exactly
    like ``tifa_eval.py:62-66`` (reloaded on rerun — generation is the
    expensive gated step), then run the image loop. Returns
    ``{dir_: run_tifa_task output}``.

    ``image_path_fn(method, dir_, img_num)`` resolves image files, replacing
    the hard-coded ``saved_sd_results`` root at ``tifa_eval.py:73``.
    """
    manual_questions = manual_questions or {}
    out: Dict[str, Dict] = {}
    for task in taskinfo:
        dir_ = task["dir_"]
        q_path = os.path.join(q_dir, f"{dir_}.json") if q_dir else None
        if q_path and os.path.exists(q_path):
            with open(q_path) as f:
                q_dict = json.load(f)
            f_ab = q_dict["filtered_questions_AB"]
            f_ba = q_dict["filtered_questions_BA"]
        else:
            if dir_ in manual_questions:
                questions_ab = manual_questions[dir_]
            else:
                questions_ab = question_gen(task["text_AB"])
            f_ab = filter_question_and_answers(qa_fn, questions_ab)
            f_ba = filter_question_and_answers(qa_fn, question_gen(task["text_BA"]))
            if q_path:
                os.makedirs(q_dir, exist_ok=True)
                with open(q_path, "w") as f:
                    json.dump(
                        {"filtered_questions_AB": f_ab, "filtered_questions_BA": f_ba},
                        f,
                    )
        images_by_method = {
            m: [image_path_fn(m, dir_, i) for i in range(n_images)] for m in methods
        }
        out[dir_] = run_tifa_task(vqa_fn, f_ab, f_ba, images_by_method)
    return out


def aggregate_tifa_runs(
    per_seed_scores: Dict[str, List[Dict[str, float]]],
) -> Dict[str, Dict[str, float]]:
    """Experiment-level table from {method: [per-seed score dicts]}.

    Per method: mean of per-seed min/max; adds ``joint`` (best ordering per
    seed between sd_ab and sd_ba) and ``coin_flip`` when both are present
    (``parse_img_metric_files.py:139-155`` semantics).
    """
    out: Dict[str, Dict[str, float]] = {}
    for method, rows in per_seed_scores.items():
        if not rows:
            continue
        out[method] = {
            "min_mean": float(np.mean([r["tifa_min"] for r in rows])),
            "max_mean": float(np.mean([r["tifa_max"] for r in rows])),
        }
    ab, ba = per_seed_scores.get("sd_ab"), per_seed_scores.get("sd_ba")
    if ab and ba:
        n = min(len(ab), len(ba))
        best = [max(ab[i]["tifa_min"], ba[i]["tifa_min"]) for i in range(n)]
        coin = [(ab[i]["tifa_min"] + ba[i]["tifa_min"]) / 2 for i in range(n)]
        out["joint"] = {"min_mean": float(np.mean(best))}
        out["coin_flip"] = {"min_mean": float(np.mean(coin))}
    return out


def make_tifascore_callables() -> Optional[Dict[str, Callable]]:
    """Adapt the real gated models (tifascore package + weights) into the
    injectable seams above; None when unavailable (no egress here).

    Maps UnifiedQA -> ``qa_fn``, mPLUG -> ``vqa_fn``, and GPT question
    generation -> ``question_gen`` (``tifa_eval.py:37-48``)."""
    try:
        from tifascore import (  # noqa: F401
            UnifiedQAModel,
            VQAModel,
            get_question_and_answers,
        )

        # constructing the models IS the gated weight load — a present
        # package with absent weights must hit the None path, not raise
        unifiedqa = UnifiedQAModel("allenai/unifiedqa-v2-t5-large-1363200")
        vqa = VQAModel("mplug-large")
    except Exception:
        return None

    def qa_fn(context: str, question: str, choices: Sequence[str]) -> str:
        return unifiedqa.mcqa(question, context, list(choices))

    def vqa_fn(image: str, question: str, choices: Sequence[str]) -> str:
        return vqa.vqa(image, question)

    return {
        "qa_fn": qa_fn,
        "vqa_fn": vqa_fn,
        "question_gen": get_question_and_answers,
    }


def get_tifa_runner() -> Optional[Callable]:
    """Back-compat gated constructor: run(image, questions) -> accuracy via
    the native scorer over the tifascore mPLUG model, or None."""
    models = make_tifascore_callables()
    if models is None:
        return None

    def run(image_path: str, question_answer_pairs: list) -> float:
        result = tifa_score_single(models["vqa_fn"], question_answer_pairs, image_path)
        return float(result["tifa_score"])

    return run
