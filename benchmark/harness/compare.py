"""The comparison that decides ``correct``: a ranked answer against the
reference's scores of the same query.

For each compared query, with ``scale`` the reference's best score (1
where nothing matches):

* ``score_gap``: the largest |score returned - reference score of the
  doc returned| / scale over the ranks;
* ``rank_gap``: the largest (reference's j-th best score - reference
  score of the doc returned at rank j) / scale, 0 where rank j holds a
  doc as good as the reference's: a worse doc ranked in;
* ``order_faults``: ranks that break the order itself: an index outside
  the corpus or returned twice, scores that rise, equal scores whose
  indices fall, and a doc returned while a doc of exactly the same
  reference score and a smaller index is left out (ties go to the
  smaller index).

The largest of each over every compared query is the run's number.  A
number is held to its limit from the workload's file.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

NAMES = ("score_gap", "rank_gap", "order_faults")


def judge_one(scores: np.ndarray, idx: np.ndarray, ref, k: int
              ) -> Tuple[float, float, int]:
    """(score_gap, rank_gap, order_faults) of one ranked answer against
    its reference (``reference.search.Scores``)."""
    scores = np.asarray(scores, dtype=np.float64)
    idx = np.asarray(idx, dtype=np.int64)
    best_vals, _ = ref.top(k)
    if len(idx) != len(best_vals):
        return float("inf"), float("inf"), abs(len(best_vals) - len(idx))
    scale = best_vals[0] if len(best_vals) and best_vals[0] > 0 else 1.0
    at = ref.at(idx)
    faults = int(np.count_nonzero(np.isnan(at)))
    faults += len(idx) - len(np.unique(idx))
    if faults:
        return float("inf"), float("inf"), faults
    score_gap = float(np.max(np.abs(scores - at)) / scale) if len(idx) else 0.0
    rank_gap = float(max(0.0, np.max(best_vals - at) / scale)) if len(idx) else 0.0
    faults += int(np.count_nonzero(scores[1:] > scores[:-1]))
    faults += int(np.count_nonzero((scores[1:] == scores[:-1])
                                   & (idx[1:] < idx[:-1])))
    for j in range(len(idx)):
        same = (at == at[j]) & (idx < idx[j])
        if ref.equal_before(at[j], int(idx[j])) > int(np.count_nonzero(same)):
            faults += 1
    return score_gap, rank_gap, faults


def judge(answers: Iterable[Tuple[np.ndarray, np.ndarray, object]],
          k: int) -> Dict[str, float]:
    """The run's numbers over (scores, indices, reference) triples."""
    out = {"score_gap": 0.0, "rank_gap": 0.0, "order_faults": 0}
    n = 0
    seen: Dict[tuple, Tuple[float, float, int]] = {}
    for scores, idx, ref in answers:
        # a query sent again with the same answer is judged once
        key = (id(ref), np.asarray(scores).tobytes(), np.asarray(idx).tobytes())
        if key not in seen:
            seen[key] = judge_one(scores, idx, ref, k)
        sg, rg, of = seen[key]
        out["score_gap"] = max(out["score_gap"], sg)
        out["rank_gap"] = max(out["rank_gap"], rg)
        out["order_faults"] += of
        n += 1
    out["compared"] = n
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[name] <= limits[name] for name in NAMES)
