"""The port's host-side evaluation copies (``eval/{tifa,ordering,aggregate}``)
against the JAX package's, on the inputs of ``tests/test_eval.py`` and
``tests/test_ordering.py``: equal outputs (floats exactly equal: the same
numpy arithmetic in the same order). The port's ``aggregate`` reads the
CSVs without pandas (the card's machine has none), checked in a process
where importing pandas fails; its tables are lists of row dicts where the
JAX module returns DataFrames."""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from superdiff_tpu.eval import aggregate as jagg
from superdiff_tpu.eval import ordering as jord
from superdiff_tpu.eval import tifa as jtifa
from superdiff_tpu_torch.eval import aggregate, ordering, tifa

REPO = Path(__file__).resolve().parents[1]

QAS = [
    {"caption": "a cactus", "element": "cactus", "question": "is this a cactus?",
     "choices": ["yes", "no"], "answer": "yes", "element_type": "object"},
    {"caption": "a cactus", "element": "cactus", "question": "what plant is in the picture?",
     "choices": ["cactus", "rose", "sunflower", "fern"], "answer": "cactus",
     "element_type": "object"},
]


@pytest.mark.parametrize("answer,choices", [
    ("Yes, it is.", ["yes", "no"]), ("a cactis", ["cactus", "rose", "fern"]),
    ("cannot tell", ["no", "cannot tell"]), ("", ["yes", "no"]),
    ("The Rose!", ["cactus", "rose"]), ("blue-ish green", ["red", "blue", "green"]),
])
def test_match_choice_matches_jax(answer, choices):
    assert tifa.match_choice(answer, choices) == jtifa.match_choice(answer, choices)


@pytest.mark.parametrize("wrong", [False, True])
def test_tifa_score_single_matches_jax(wrong):
    answers = {"is this a cactus?": "Yes, it is.",
               "what plant is in the picture?": "a rose" if wrong else "a cactis"}
    got = tifa.tifa_score_single(lambda img, q, ch: answers[q], QAS, "img.png")
    assert got == jtifa.tifa_score_single(lambda img, q, ch: answers[q], QAS, "img.png")
    assert got["tifa_score"] == (0.5 if wrong else 1.0)


def test_tifa_filter_and_aggregation_match_jax():
    qas = [{"caption": "a red cube", "question": "what color is the cube?",
            "choices": ["red", "blue"], "answer": "red"},
           {"caption": "a red cube", "question": "what color is the sphere?",
            "choices": ["red", "blue"], "answer": "blue"}]
    kept = tifa.filter_question_and_answers(lambda c, q, ch: "red", qas)
    assert kept == jtifa.filter_question_and_answers(lambda c, q, ch: "red", qas)
    assert [q["question"] for q in kept] == ["what color is the cube?"]
    scores = {
        "sd_ab": [{"tifa_min": 0.5, "tifa_max": 0.8}, {"tifa_min": 0.7, "tifa_max": 0.9}],
        "sd_ba": [{"tifa_min": 0.6, "tifa_max": 0.7}, {"tifa_min": 0.4, "tifa_max": 0.6}],
        "and": [{"tifa_min": 0.8, "tifa_max": 0.9}],
    }
    assert tifa.aggregate_tifa_runs(scores) == jtifa.aggregate_tifa_runs(scores)
    pair = tifa.tifa_for_pair(lambda img, p: len(p) / 10, "x.png", "a cat", "a big dog")
    assert pair == jtifa.tifa_for_pair(lambda img, p: len(p) / 10, "x.png", "a cat", "a big dog")
    assert tifa.REFERENCE_METHODS == jtifa.REFERENCE_METHODS
    assert tifa.get_tifa_runner() is None and jtifa.get_tifa_runner() is None


def test_tifa_experiment_matches_jax(tmp_path):
    """JAX's end-to-end mock chain (generation, filter, persistence, the
    per-method image loop), run by both packages into their own question
    directories: the same outputs and the same question files, reloaded on
    the rerun without generating again."""
    taskinfo = [{"dir_": "cactus_dandelion", "text_AB": "a cactus and a dandelion",
                 "text_BA": "a dandelion and a cactus"}]

    def question_gen(caption):
        first = caption.split()[1]
        return [{"caption": caption, "element": first, "question": f"is there a {first}?",
                 "choices": ["yes", "no"], "answer": "yes", "element_type": "object"},
                {"caption": caption, "element": first, "question": f"is the {first} absent?",
                 "choices": ["yes", "no"], "answer": "yes", "element_type": "object"}]

    def qa_fn(context, question, choices):
        if "absent" in question:
            return "no"
        return "yes" if question.split()[-1].rstrip("?") in context else "no"

    def vqa_fn(image, question, choices):
        return "yes" if "/or/" in image or "cactus" in question else "no"

    outs, calls = [], []
    for mod, name in ((tifa, "port"), (jtifa, "jax")):
        n = {"gen": 0}

        def counting_gen(caption, n=n):
            n["gen"] += 1
            return question_gen(caption)

        kw = dict(taskinfo=taskinfo, qa_fn=qa_fn, vqa_fn=vqa_fn,
                  image_path_fn=lambda m, d, i: f"/results/{m}/{d}/{i}.png", n_images=3,
                  methods=("or", "sd_a"), q_dir=str(tmp_path / name))
        first = mod.run_tifa_experiment(question_gen=counting_gen, **kw)
        again = mod.run_tifa_experiment(question_gen=counting_gen, **kw)
        assert again == first
        outs.append(first)
        calls.append(n["gen"])
    assert outs[0] == outs[1] and calls == [2, 2]
    files = [json.loads((tmp_path / n / "cactus_dandelion.json").read_text())
             for n in ("port", "jax")]
    assert files[0] == files[1]
    assert outs[0]["cactus_dandelion"]["summary"]["or"]["mean"] == 1.0


def _row(fid, lo, hi, is_mean=None, is_std=None):
    r = {"fid_train": fid, "fid_train_ci95": [lo, hi]}
    if is_mean is not None:
        r["is_mean"], r["is_std"] = is_mean, is_std
    return r


def _base_rows():
    return {
        "model_A_sde": _row(50.0, 48, 52, 5.0, 0.2), "model_B_sde": _row(40.0, 38, 42, 5.2, 0.2),
        "joint_or_sde": _row(8.0, 7, 9, 6.0, 0.2), "joint_avg_sde": _row(30.0, 28, 32, 5.5, 0.2),
        "pool_mixed_baseline": _row(25.0, 23, 27), "model_A_ode": _row(60.0, 57, 63, 4.8, 0.2),
        "model_B_ode": _row(70.0, 67, 73, 4.6, 0.2), "joint_or_ode": _row(55.0, 52, 54, 5.0, 0.2),
        "sanity_train_subset": _row(1.0, 0.8, 1.2, 9.0, 0.3),
        "sanity_noise": _row(300.0, 295, 305, 1.5, 0.1),
        "untrained_model_sde": _row(900.0, 890, 910),
    }


def _regimes():
    healthy = _base_rows()
    collapse = _base_rows()
    collapse.update(model_A_ode=_row(800.0, 790, 810, 1.0, 0.001),
                    model_B_ode=_row(840.0, 830, 850, 1.0, 0.001),
                    joint_or_ode=_row(805.0, 798, 809, 1.0, 0.001))
    degenerate = _base_rows()
    for i, n in enumerate(sorted(degenerate)):
        if "is_mean" in degenerate[n]:
            degenerate[n].update(is_mean=1.0 + 0.0001 * (i % 3), is_std=0.002)
    no_ode = {k: v for k, v in _base_rows().items()
              if k not in ("model_A_ode", "model_B_ode", "joint_or_ode")}
    tie = _base_rows()
    tie["joint_or_sde"] = _row(50.0, 48, 52)
    return {"healthy": healthy, "ode_collapse": collapse, "degenerate_is": degenerate,
            "no_ode": no_ode, "tie": tie}


@pytest.mark.parametrize("regime", sorted(_regimes()))
def test_orderings_match_jax(regime):
    rows = _regimes()[regime]
    assert ordering.build_orderings(rows) == jord.build_orderings(rows)
    got = ordering.between_checks(rows, "joint_or_sde", ["model_A_sde", "model_B_sde"], "sde")
    assert got == jord.between_checks(rows, "joint_or_sde", ["model_A_sde", "model_B_sde"],
                                      "sde")
    assert ordering.SDE_ROWS == jord.SDE_ROWS and ordering.ODE_ROWS == jord.ODE_ROWS


def _write_csv_tree(root):
    tables = {
        "and": {"pair1": [(1.0, 3.0, 1.0), (2.0, 1.0, 1.0)], "pair2": [(0.5, 0.25, 0.25)]},
        "sd_ab": {"pair1": [(0.3, 0.2, 0.2), (0.1, 0.4, 0.1), (0.9, 0.7, 0.7)]},
        "sd_ba": {"pair1": [(0.2, 0.6, 0.2), (0.5, 0.5, 0.5)]},
    }
    for method, pairs in tables.items():
        d = Path(root) / f"metrics_{method}"
        d.mkdir(parents=True)
        for pair, rows in pairs.items():
            with open(d / f"metrics_{method}_{pair}.csv", "w", newline="") as fh:
                w = csv.writer(fh)
                w.writerow(["clip_raw_score_1", "clip_raw_score_2", "min_clip", "prompt"])
                for i, r in enumerate(rows):
                    w.writerow([*r, f"prompt {i}"])


def test_aggregate_matches_jax(tmp_path):
    _write_csv_tree(tmp_path)
    methods = ("and", "sd_ab", "sd_ba", "missing")
    for m in methods:
        got, ref = aggregate.load_metric_csvs(str(tmp_path), m), jagg.load_metric_csvs(
            str(tmp_path), m)
        assert got == ref.to_dict("records")
        if got:
            assert aggregate.and_scores(got) == jagg.and_scores(ref)
            assert aggregate.or_scores(got) == jagg.or_scores(ref)
    ab, ba = (aggregate.load_metric_csvs(str(tmp_path), m) for m in ("sd_ab", "sd_ba"))
    jab, jba = (jagg.load_metric_csvs(str(tmp_path), m) for m in ("sd_ab", "sd_ba"))
    assert aggregate.joint_baseline(ab, ba) == jagg.joint_baseline(jab, jba)
    got = aggregate.summarize_methods(str(tmp_path), methods)
    ref = jagg.summarize_methods(str(tmp_path), methods)
    assert got["methods"] == ref.to_dict("records")
    assert got["joint_baseline"] == ref.attrs["joint_baseline"]
    only_and = aggregate.summarize_methods(str(tmp_path), ["and"])
    assert only_and["joint_baseline"] is None
    np.testing.assert_allclose(aggregate.and_scores(aggregate.load_metric_csvs(
        str(tmp_path), "and"))["min_mean"], (1.0 + 1.0 + 0.25) / 3)


def test_aggregate_needs_no_pandas(tmp_path):
    _write_csv_tree(tmp_path)
    code = ("import sys, json\n"
            "sys.modules['pandas'] = None  # any import of pandas fails\n"
            "from superdiff_tpu_torch.eval import aggregate\n"
            f"out = aggregate.summarize_methods({str(tmp_path)!r}, ['and', 'sd_ab', 'sd_ba'])\n"
            "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env={**os.environ})
    assert proc.returncode == 0, proc.stderr[-1500:]
    out = json.loads(proc.stdout)
    ref = jagg.summarize_methods(str(tmp_path), ["and", "sd_ab", "sd_ba"])
    assert out["methods"] == ref.to_dict("records")
    assert out["joint_baseline"] == ref.attrs["joint_baseline"]
