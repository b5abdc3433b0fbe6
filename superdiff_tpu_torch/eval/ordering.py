"""Quality-table ordering checks (the evals.ipynb signal, as a library;
the port's own copy of ``superdiff_tpu/eval/ordering.py``).

The reference's persisted quality tables (``notebooks/evals.ipynb`` cells
5/8/10/15) carry *orderings*, not absolute values: train-subset FID at the
bottom, noise/untrained at the top, joint composition between/below the
single models (cell 8: joint-SDE 4.01 in [2.83, 4.86]; cell 10 joint-ODE
4.41 vs singles 5.30/4.69), and IS bounds (cell 15: train 10.851 >> noise
3.375). ``scripts/quality_report.py`` asserts these with CI margins; this
module is that logic factored out so it is unit-testable and so a finished
QUALITY.json can have its orderings re-derived without re-sampling
(``--rows_from``).

Semantics notes (r5):

* The noise/untrained FID *bounds* quantify over the SDE-sampled rows
  (+ the pool-mixed baseline) — the reference's own tables bound SDE
  samples; its ODE signal is the *matrix-internal* comparison (joint-ODE
  vs singles-ODE), asserted separately here. ODE rows of weakly-trained
  stand-in models can legitimately exceed the noise FID (probability flow
  integrates score error with no stochastic contraction —
  ``scripts/diag_ode_mixing.py`` pins that the mixing math itself is
  correct); when that happens an informational entry records it instead
  of failing a bound the reference never claims.
* IS orderings are computed always but annotated: with the documented
  random-init logits head, p(y|x) is near-uniform and IS degenerates to
  ~1.0 for every pool, so separation carries no signal until real
  Inception weights are supplied.
"""

from __future__ import annotations

from typing import Dict, List


def _ci(rows: Dict, name: str, key: str = "fid_train"):
    row = rows[name]
    if f"{key}_ci95" in row:
        return row[f"{key}_ci95"]
    v = row.get(key)
    return [v, v] if v is not None else None


def check(claim: str, lhs_hi: float, rhs_lo: float) -> Dict:
    m = round(rhs_lo - lhs_hi, 3)
    return {"claim": claim, "separated": bool(m > 0), "margin": m}


def between_checks(rows: Dict, joint: str, singles: List[str], tag: str) -> List[Dict]:
    """The reference's two-sided signal: joint strictly better than the
    worst single (CI-separated), with placement reported vs the best."""
    cis = {n: _ci(rows, n) for n in singles}
    vals = {n: rows[n]["fid_train"] for n in singles}
    worst = max(singles, key=lambda n: vals[n])
    best = min(singles, key=lambda n: vals[n])
    out = [check(
        f"{tag}: joint < worst single ({worst}), CI-separated",
        _ci(rows, joint)[1], cis[worst][0],
    )]
    below_best = _ci(rows, joint)[1] < cis[best][0]
    out.append({
        "claim": f"{tag}: joint between/below singles "
                 f"[{vals[best]}, {vals[worst]}]",
        "separated": bool(out[0]["separated"]),
        "placement": "below both singles" if below_best else
                     "between the singles",
        "joint": rows[joint]["fid_train"],
    })
    return out


SDE_ROWS = ["model_A_sde", "model_B_sde", "joint_or_sde", "joint_avg_sde",
            "pool_mixed_baseline"]
ODE_ROWS = ["model_A_ode", "model_B_ode", "joint_or_ode"]


def build_orderings(rows: Dict) -> List[Dict]:
    sde = [n for n in SDE_ROWS if n in rows]
    ode = [n for n in ODE_ROWS if n in rows]
    generated = sde + ode

    orderings = [
        check(
            "sanity_train_subset << every generated row",
            _ci(rows, "sanity_train_subset")[1],
            min(_ci(rows, n)[0] for n in generated),
        ),
        check(
            "every SDE-sampled row << sanity_noise",
            max(_ci(rows, n)[1] for n in sde),
            _ci(rows, "sanity_noise")[0],
        ),
        check(
            "every SDE-sampled row << untrained model",
            max(_ci(rows, n)[1] for n in sde),
            _ci(rows, "untrained_model_sde")[0],
        ),
        *between_checks(rows, "joint_or_sde",
                        ["model_A_sde", "model_B_sde"], "sde"),
    ]
    if "joint_or_ode" in rows and "model_A_ode" in rows:
        orderings += between_checks(
            rows, "joint_or_ode", ["model_A_ode", "model_B_ode"], "ode")
        # informational: where the ODE matrix sits vs the noise bound.
        # The reference bounds only its SDE tables; with weakly-trained
        # stand-in scores the probability flow can exceed noise FID —
        # that is an integrator-amplification property, not a mixing bug
        # (scripts/diag_ode_mixing.py), so it is recorded, not asserted.
        worst_ode = max(rows[n]["fid_train"] for n in ode)
        noise = rows["sanity_noise"]["fid_train"]
        orderings.append({
            "claim": "informational: ODE matrix vs noise FID",
            "ode_worst": worst_ode,
            "noise": noise,
            "note": (
                "ODE rows below noise" if worst_ode < noise else
                "ODE sampling of the weakly-trained stand-in scores "
                "exceeds the noise FID: probability flow integrates score "
                "error without the SDE's stochastic contraction; the "
                "asserted ODE signal is the matrix-internal "
                "joint-between/below-singles ordering above (mixing math "
                "verified against analytic full-covariance Gaussians at "
                "D=512, scripts/diag_ode_mixing.py)"
            ),
        })

    is_rows = [n for n in generated if "is_mean" in rows.get(n, {})]
    if is_rows and "is_mean" in rows.get("sanity_noise", {}):
        def is_lo(n):
            return rows[n]["is_mean"] - 2 * rows[n]["is_std"]

        def is_hi(n):
            return rows[n]["is_mean"] + 2 * rows[n]["is_std"]

        c1 = check(
            "is: every generated row > sanity_noise",
            is_hi("sanity_noise"), min(is_lo(n) for n in is_rows),
        )
        c2 = check(
            "is: sanity_train_subset >= best generated row",
            max(is_hi(n) for n in is_rows), is_lo("sanity_train_subset"),
        )
        # with the seeded random logits head, p(y|x) ~ uniform and IS ~ 1.0
        # for every pool — the checks exist but carry no signal offline
        all_is = [rows[n]["is_mean"] for n in is_rows + ["sanity_noise",
                                                         "sanity_train_subset"]
                  if "is_mean" in rows.get(n, {})]
        degenerate = max(all_is) - min(all_is) < 0.5
        for c in (c1, c2):
            if degenerate:
                c["stand_in_note"] = (
                    "random-init logits head: IS ~ 1.0 for every pool "
                    "(max spread {:.3f}); the ordering activates with real "
                    "Inception weights (reference bounds: 10.851 train / "
                    "3.375 noise, evals.ipynb cell 15)".format(
                        max(all_is) - min(all_is))
                )
            orderings.append(c)
    return orderings
