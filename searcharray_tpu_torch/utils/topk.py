"""Top-N result gathering across queries into one ranked dataframe.

Functional analog of the reference's SetOfResults (`utils/sort.py:9-45`):
collect per-query top-N rows over a searchable dataframe, excluding the
searchable (index) columns from the output, and emit a rank column per
query.  Implementation differs: results are selected and ranked at insert
time (argpartition + descending argsort), and the final frame is a single
concat.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import pandas as pd


class SetOfResults:
    """Gather top-N rows per query into a ranked dataframe."""

    def __init__(self, df: pd.DataFrame, searchable: bool = False):
        from searcharray_tpu_torch.pandas_ext.array import SearchArray

        self.df = df
        if searchable:
            self._plain_cols = list(df.columns)
        else:
            self._plain_cols = [
                c for c in df.columns
                if not isinstance(df[c].array, SearchArray)
            ]
        self._frames: List[pd.DataFrame] = []

    def ins_top_n(self, scores, N: int = 10, query: str = "",
                  metadata: Optional[Dict[str, Any]] = None) -> None:
        """Select, rank and stash the top N rows for one query."""
        scores = np.asarray(scores)
        N = min(N, len(scores))
        cand = np.argpartition(scores, -N)[-N:]
        ranked = cand[np.argsort(scores[cand])[::-1]]

        frame = self.df.iloc[ranked][self._plain_cols].copy()
        frame["score"] = scores[ranked]
        frame["query"] = query
        frame["rank"] = np.arange(1, N + 1)
        if metadata:
            for key, values in metadata.items():
                if isinstance(values, list):
                    if len(values) != N:
                        raise ValueError(
                            "Metadata must have same length as scores."
                        )
                    frame[key] = values
                else:
                    frame[key] = values
        self._frames.append(frame)

    def get_all(self) -> pd.DataFrame:
        """All gathered results, sorted by (query, rank)."""
        if not self._frames:
            return pd.DataFrame(
                columns=self._plain_cols + ["score", "query", "rank"]
            )
        out = pd.concat(self._frames, ignore_index=True)
        return out.sort_values(["query", "rank"]).reset_index(drop=True)
