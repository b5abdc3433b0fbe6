"""Prompt-faithfulness metrics: CLIP similarity + ImageReward harnesses
(a copy of ``superdiff_tpu/eval/clip_metrics.py``, which is PyTorch +
transformers there too).

Parity targets: ``applications/images/clip_eval.py:108-158`` (per-image
similarity to BOTH prompts, min/avg aggregation — the paper's AND metric is
the batch mean of the per-image min). Model loading is gated: both metrics
need pretrained weights (``openai/clip-vit-base-patch32``,
``ImageReward-v1.0``) that require network or a local cache; when
unavailable the scorers return None and callers skip the metric (this
environment has no egress).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


def aggregate_two_prompt_scores(
    raw: Sequence[Tuple[float, float]],
) -> dict:
    """min/avg aggregation over (score_vs_A, score_vs_B) pairs
    (``clip_eval.py:137-139,454-457``)."""
    mins = [min(a, b) for a, b in raw]
    avgs = [(a + b) / 2.0 for a, b in raw]
    n = max(len(raw), 1)
    return {
        "min_mean": float(np.sum(mins) / n),
        "avg_mean": float(np.sum(avgs) / n),
        "min": mins,
        "avg": avgs,
        "raw": [tuple(map(float, r)) for r in raw],
    }


def make_clip_scorer(model, processor) -> Callable:
    """Scorer over an explicit (CLIPModel, CLIPProcessor) pair — the full
    ``clip_eval.py:108-139`` protocol (per-image logits vs BOTH prompts,
    min/avg aggregation). Split out from ``get_clip_scorer`` so the chain
    is executable end-to-end with tiny random weights (tests) as well as
    the gated pretrained checkpoint."""
    import torch

    def scorer(images: np.ndarray, prompt_a: str, prompt_b: str) -> dict:
        raw: List[Tuple[float, float]] = []
        with torch.no_grad():
            for img in images:
                pair = []
                for prompt in (prompt_a, prompt_b):
                    inputs = processor(
                        text=[prompt], images=img[None], return_tensors="pt", padding=True
                    )
                    pair.append(float(model(**inputs).logits_per_image.item()))
                raw.append((pair[0], pair[1]))
        return aggregate_two_prompt_scores(raw)

    return scorer


def get_clip_scorer(
    model_name: str = "openai/clip-vit-base-patch32",
) -> Optional[Callable]:
    """Returns scorer(images_uint8, prompt_a, prompt_b) -> aggregation dict,
    or None when weights are unavailable."""
    try:
        from transformers import CLIPModel, CLIPProcessor

        try:  # local cache first: avoids minutes of HTTP retries offline
            model = CLIPModel.from_pretrained(model_name, local_files_only=True)
            processor = CLIPProcessor.from_pretrained(model_name, local_files_only=True)
        except Exception:
            from ..utils.hub import allow_hub_download

            if not allow_hub_download():
                return None  # offline: fail fast to the gated-skip path
            model = CLIPModel.from_pretrained(model_name)
            processor = CLIPProcessor.from_pretrained(model_name)
    except Exception:
        return None
    return make_clip_scorer(model, processor)


def make_image_reward_scorer(model) -> Callable:
    """Scorer over an explicit reward model exposing ``score(prompt, pil)``
    (the ``ImageReward`` API) — split out for mock-executable tests."""
    from PIL import Image

    def scorer(images: np.ndarray, prompt_a: str, prompt_b: str) -> dict:
        raw = []
        for img in images:
            pil = Image.fromarray(img)
            raw.append((model.score(prompt_a, pil), model.score(prompt_b, pil)))
        return aggregate_two_prompt_scores(raw)

    return scorer


def get_image_reward_scorer() -> Optional[Callable]:
    """ImageReward RM scorer (``clip_eval.py:144-158``); None when the
    ``ImageReward`` package/weights are absent."""
    try:
        import ImageReward as RM

        model = RM.load("ImageReward-v1.0")
    except Exception:
        return None
    return make_image_reward_scorer(model)
