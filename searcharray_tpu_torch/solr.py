"""Solr edismax query composition over SearchArray dataframe columns.

Behavioural parity with the reference (`searcharray/solr.py`) and with the
JAX package (`searcharray_tpu/solr.py`): mm spec parsing (including
conditional ``n<m`` clauses and percentages), ``field^boost`` lists,
term-centric vs field-centric dispatch, tie breaking, and pf/pf2/pf3
phrase boosts added only at rows the main query matched.  Per-field score
stacks come from ``SearchArray.score_batch_device`` and stay on the
device; the dismax / tie / mm composition is K11 (``csrc/compose.cu``;
``ops/kernels.py:compose_plain`` on the CPU), rounded as the JAX
package's compiled composers round it; the phase folds are torch adds
and one float32 matrix product, as the JAX package's are one rounding
each; the ranking is K3 (``dense.pack_topk``).  The phrase phases add only at docs the
main query matched.  ``edismax`` on a large corpus whose main query
matched few docs scores its exact phases at those docs only (the
candidate-row pruning of the JAX package, ``score_batch_device(rows=)``,
K8b's minis under K5) and adds them there; elsewhere, and in
``edismax_batch``, the phases score the whole corpus and are masked by
the main query's matches, which the JAX package pins as numerically
identical.  Below the pruning's corpus size ``edismax`` scores each
field's query terms and its phrase grams in one batch.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import pandas as pd
import torch

from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda.score import host_to_device
from searcharray_tpu_torch.pandas_ext.array import SearchArray
from searcharray_tpu_torch.search.dense import pack_topk
from searcharray_tpu_torch.search.similarity import Similarity, default_bm25
from searcharray_tpu_torch.utils import profiling


def _mm_int(value: str) -> int:
    try:
        return int(value)
    except ValueError:
        raise ValueError("Invalid 'mm' spec. Expecting an integer.")


def parse_min_should_match(num_clauses: int, spec: str) -> int:
    """Parse Solr's minimum-should-match spec into a clause count.

    Supports plain integers ("3"), negatives ("-2" = all but two),
    percentages ("75%", "-25%"), and conditional chains ("2<2 5<3 7<40%":
    each "n<expr" applies when there are more than n clauses).
    Semantics follow Solr's SolrPluginUtils.calculateMinShouldMatch.
    """
    spec = spec.strip()

    # Conditional chain: evaluate left to right; the last clause whose
    # bound is exceeded wins. <= bound means "use everything so far".
    if "<" in spec:
        selected = num_clauses
        for cond in re.sub(r"\s*<\s*", "<", spec).split():
            bound_s, _, expr = cond.partition("<")
            if not expr:
                raise ValueError(
                    f"Invalid 'mm' spec: '{cond}'. "
                    "Expecting values before and after '<'"
                )
            if num_clauses <= _mm_int(bound_s):
                return selected
            selected = parse_min_should_match(num_clauses, expr)
        return selected

    if spec.endswith("%"):
        pct = _mm_int(spec[:-1])
        scaled = num_clauses * pct / 100
        required = num_clauses + int(scaled) if scaled < 0 else int(scaled)
    else:
        fixed = _mm_int(spec)
        required = num_clauses + fixed if fixed < 0 else fixed

    return min(num_clauses, max(required, 0))


def parse_field_boosts(field_lists: List[str]) -> dict:
    """Parse ``field^2.0`` style boost lists for qf/pf/pf2/pf3."""
    if not field_lists:
        return {}
    out = {}
    for field in field_lists:
        parts = re.split(r"\^", field)
        out[parts[0]] = None if len(parts) == 1 else float(parts[1])
    return out


def get_field(frame, field) -> SearchArray:
    if field not in frame.columns:
        raise ValueError(f"Field {field} not in dataframe")
    if not isinstance(frame[field].array, SearchArray):
        raise ValueError(f"Field {field} is not a searcharray field")
    return frame[field].array


def parse_query_terms(frame: pd.DataFrame, query: str, query_fields: List[str]):
    search_terms: Dict[str, List[str]] = {}
    num_search_terms = 0
    term_centric = True
    for field in query_fields:
        arr = get_field(frame, field)
        terms = list(arr.tokenizer(query))
        search_terms[field] = terms
        if num_search_terms == 0:
            num_search_terms = len(terms)
        elif len(terms) != num_search_terms:
            term_centric = False
    return num_search_terms, search_terms, term_centric


def _boost_val(boost) -> float:
    return 1.0 if boost is None else boost


def _boost_exp(boost) -> str:
    return f"{boost}" if boost is not None else "1"


def _compose_tc(stacks, boosts, tie: float, msm: int,
                chain: bool = True) -> torch.Tensor:
    """Term-centric dismax: per-field [T, N] stacks and their boosts ->
    [N].  Per term the best field plus ``tie`` times the others; a doc
    matches when at least ``msm`` terms score.  ``chain``: the field sum
    as fused multiply-adds, as the JAX package's ``edismax`` program
    rounds it (its ``edismax_batch`` adds them one rounding at a time)."""
    return K.compose_device(stacks, boosts, tie, msm, term_centric=True,
                            chain=chain)


def _compose_fc(stacks, boosts, tie: float, msms) -> torch.Tensor:
    """Field-centric dismax: per-field mm over its own term count
    (``msms[i]``), then dismax and tie across the fields."""
    return K.compose_device(stacks, boosts, tie, msms, term_centric=False)


def _tc_explain(query_fields, search_terms, num_search_terms, msm) -> str:
    explain = []
    for term_posn in range(num_search_terms):
        term_explain = [
            f"{field}:{search_terms[field][term_posn]}^{_boost_exp(boost)}"
            for field, boost in query_fields.items()
        ]
        explain.append("(" + " | ".join(term_explain) + ")")
    return "(" + " ".join(explain) + f")~{msm}"


def _fc_explain(query_fields, search_terms, mm) -> Tuple[str, list]:
    explain, msms = [], []
    for field, boost in query_fields.items():
        terms = search_terms[field]
        msm = min(parse_min_should_match(len(terms), spec=mm), len(terms))
        exp = " ".join([f"{field}:{term}" for term in terms])
        explain.append("((" + exp + f")~{msm})^{_boost_exp(boost)}")
        msms.append(msm)
    return " | ".join(explain), msms


def _edismax_term_centric(stacks, query_fields, num_search_terms,
                          search_terms, mm, tie) -> Tuple[torch.Tensor, str]:
    """Term-centric composition on the device of the per-field [T, N]
    stacks of the query terms: the dismax / tie / mm passes."""
    boosts = [_boost_val(boost) for boost in query_fields.values()]
    min_should_match = parse_min_should_match(num_search_terms, spec=mm)
    qf_scores = _compose_tc(stacks, boosts, float(tie), min_should_match)
    return qf_scores, _tc_explain(query_fields, search_terms,
                                  num_search_terms, min_should_match)


def _edismax_field_centric(stacks, query_fields, num_search_terms,
                           search_terms, mm, tie) -> Tuple[torch.Tensor, str]:
    """Field-centric composition on the device (see
    _edismax_term_centric)."""
    boosts = [_boost_val(boost) for boost in query_fields.values()]
    explain, msms = _fc_explain(query_fields, search_terms, mm)
    return _compose_fc(stacks, boosts, float(tie), msms), explain


def _grams_of(terms: List[str], ngram: int) -> List[List[str]]:
    """The whole phrase (``ngram`` 0) or every run of ``ngram`` terms."""
    if ngram == 0:
        return [terms]
    return [terms[i: i + ngram] for i in range(len(terms) - ngram + 1)]


def _gram_explain(field, gram, slop, boost) -> str:
    slop_exp = f"~{slop}" if slop else ""
    return f" ({field}:\"{' '.join(gram)}\"{slop_exp})^{_boost_exp(boost)}"


# Candidate-row phrase phases engage above this corpus size when the main
# query matched at most 1/PHASE_SUBSET_MAX_FRAC of the docs: the
# reference's cost contract (phrase phases proportional to matches,
# solr.py:328-338).  The match set comes back as ONE copy of (count, the
# first PHASE_ROWS_CAP matched ids); a count in (cap, N/8] pays one more
# copy sized to it.  The JAX package prunes from 2^17 docs.  On an H100
# reading the match set makes the host wait for the main query's kernels,
# which cost more than the whole-corpus phase passes it saves: timed in
# turns (scripts/cand_crossover.py, PERF.md section 6), edismax's p50 was
# higher with the pruning on at every size from 1M to the README's largest
# tier, 8,841,823 docs (5.25 -> 7.23 ms there).  So it starts past that
# tier; whether it pays above is not measured.
PHASE_SUBSET_MIN_DOCS = 1 << 24
PHASE_SUBSET_MAX_FRAC = 8
PHASE_ROWS_CAP = 1 << 16


def _matched_ids(qf_scores: torch.Tensor, cap: int) -> np.ndarray:
    """int32 [1 + cap] on the host: the number of docs with a positive
    score, then the first ``cap`` of them in doc order (``n`` past the
    matches).  One device-to-host copy."""
    n = qf_scores.shape[0]
    pos = qf_scores > 0
    rank = torch.cumsum(pos, 0)
    dest = torch.where(pos & (rank <= cap), rank - 1, cap)
    ids = torch.full((cap + 1,), n, dtype=torch.int64,
                     device=qf_scores.device)
    ids.scatter_(0, dest, torch.arange(n, device=qf_scores.device))
    ids[cap] = rank[-1]
    wire = ids.roll(1).to(torch.int32)
    with profiling.span("batch.wait"):
        return wire.cpu().numpy()


def _prunes_phases(n_docs: int) -> bool:
    """Whether the phrase phases of a corpus of ``n_docs`` docs may score
    at the main query's matched docs only (``_phase_candidate_rows``).
    Below this size they score the whole corpus and are masked after, so
    they need nothing of the main query."""
    return n_docs != 0 and n_docs >= PHASE_SUBSET_MIN_DOCS


def _phase_candidate_rows(qf_scores: torch.Tensor) -> Optional[np.ndarray]:
    """Doc ids matched by the main query, or None where scoring the
    phases at them would not pay (a small corpus, a broad match, no
    match)."""
    n = int(qf_scores.shape[0])
    if not _prunes_phases(n):
        return None
    cap = min(PHASE_ROWS_CAP, n)
    wire = _matched_ids(qf_scores, cap)
    count = int(wire[0])
    if count == 0 or count * PHASE_SUBSET_MAX_FRAC > n:
        return None
    if count <= cap:
        return wire[1: 1 + count].astype(np.int64)
    # the middle zone: one more copy, sized to the count
    wire = _matched_ids(qf_scores, min(K.bucket_of(count), n))
    return wire[1: 1 + count].astype(np.int64)


def _phase_rows(phases, similarity, rows) -> List[Optional[np.ndarray]]:
    """Per phase, the docs its grams score at: ``rows`` (the main query's
    matched docs) for an exact phase whose fields all have a fused
    similarity; else None, the whole corpus, masked by the caller."""
    out: List[Optional[np.ndarray]] = []
    for fields, _ngram, slop in phases:
        use = rows
        if use is not None and (slop != 0 or any(
                getattr(similarity.get(f, default_bm25), "_fused",
                        None) is None for f in fields)):
            use = None
        out.append(use)
    return out


def _phase_grams(search_terms, phases, rows_p) -> dict:
    """The pf / pf2 / pf3 grams per (field, scored at ``rows_p``'s rows):
    ``grams``, their ``slops`` and each phase's segment of them in
    ``segs`` (phase, boost, ngram, slop, first gram, gram count).

    ``phases`` is a list of (fields, ngram, slop): ngram 0 is the whole
    phrase, 2 / 3 the bigram / trigram phases; ``slop`` wires the Solr ps /
    ps2 / ps3 parameters.  A field in several phases scores all its grams
    in one device batch (per-query slop, search/batch.py)."""
    calls: dict = {}
    for pi, (fields, ngram, slop) in enumerate(phases):
        min_terms = ngram if ngram else 2
        for field, boost in fields.items():
            terms = search_terms[field]
            if len(terms) < min_terms:
                continue
            grams = _grams_of(terms, ngram)
            ent = calls.setdefault((field, rows_p[pi] is not None),
                                   {"grams": [], "slops": [], "segs": []})
            ent["segs"].append((pi, boost, ngram, slop, len(ent["grams"]),
                                len(grams)))
            ent["grams"] += grams
            ent["slops"] += [slop] * len(grams)
    return calls


def _field_batches(frame, query_fields, search_terms, calls,
                   similarity) -> list:
    """One ``score_batch_device`` call per query field: its query terms,
    then the grams of its whole-corpus entry in ``calls`` (per-query slop,
    0 for the terms).  Returns the [T, N] stacks of the terms, in
    ``query_fields`` order, and puts each entry's gram rows under
    ``calls[key]["scores"]``."""
    stacks = []
    for field in query_fields:
        terms = search_terms[field]
        ent = calls.get((field, False), {"grams": [], "slops": []})
        out = get_field(frame, field).score_batch_device(
            terms + ent["grams"], similarity=similarity[field],
            slop=[0] * len(terms) + ent["slops"])
        stacks.append(out[:len(terms)])
        ent["scores"] = out[len(terms):]
    profiling.count("field_batches", len(query_fields))
    return stacks


@profiling.spanned("composer.phases")
def _ngram_phases(n_ph: int, calls: dict) -> list:
    """Each phase's total over the docs its grams were scored at: per
    segment its gram rows summed (the final bigram twice), times its boost
    in float32, summed over the phase's fields.  Returns a list of (total
    tensor or None, explain) per phase."""
    totals: List[Optional[torch.Tensor]] = [None] * n_ph
    explains: List[str] = [""] * n_ph
    for (field, _at_rows), ent in calls.items():
        for pi, boost, ngram, slop, g0, gn in ent["segs"]:
            seg = ent["scores"][g0: g0 + gn]
            contrib = seg.sum(dim=0)
            if ngram == 2 and gn:
                # parity quirk: the reference double-appends the final
                # bigram (solr.py:221)
                contrib = contrib + seg[-1]
            contrib = contrib * float(np.float32(_boost_val(boost)))
            totals[pi] = (contrib if totals[pi] is None
                          else totals[pi] + contrib)
            for gram in ent["grams"][g0: g0 + gn]:
                explains[pi] += _gram_explain(field, gram, slop, boost)
    return list(zip(totals, explains))


def _unpack_topk(wire: np.ndarray, k: int):
    """int32 [..., 2k] (f32 score bits ‖ doc indices) on the host ->
    (scores f32[..., k], indices int64[..., k])."""
    return (np.ascontiguousarray(wire[..., :k]).view(np.float32),
            wire[..., k:].astype(np.int64))


def _settings(qf, mm, pf, pf2, pf3, q_op, similarity):
    """The parsed field lists, the mm spec and the per-field similarity
    of one edismax configuration."""
    def listify(x):
        return x if isinstance(x, list) else [x]

    query_fields = parse_field_boosts(listify(qf))
    phrase_fields = parse_field_boosts(listify(pf)) if pf else {}
    if mm is None:
        mm = "1"
    if isinstance(mm, int):
        mm = f"{mm}"
    if q_op == "AND":
        mm = "100%"
    if not isinstance(similarity, dict):
        similarity = {field: similarity for field in query_fields}
    for field in query_fields:
        if field not in similarity:
            similarity[field] = default_bm25
    bigram_fields = parse_field_boosts(pf2) if pf2 else {}
    trigram_fields = parse_field_boosts(pf3) if pf3 else {}
    return (query_fields, phrase_fields, bigram_fields, trigram_fields, mm,
            similarity)


@profiling.spanned("composer.edismax")
def edismax(frame: pd.DataFrame, q: str, qf: List[str],
            mm: Optional[Union[str, int]] = None,
            pf: Optional[List[str]] = None,
            pf2: Optional[List[str]] = None,
            pf3: Optional[List[str]] = None,
            ps2: int = 0, ps3: int = 0, ps: int = 0,
            tie: float = 0.0, q_op: str = "OR",
            similarity: Union[Similarity, Dict[str, Similarity]] = default_bm25,
            top_k: Optional[int] = None,
            ) -> Tuple[np.ndarray, str]:
    """Run an edismax query over a dataframe with SearchArray columns.

    Returns (scores, explain string).  With ``top_k`` set, returns
    ``((scores float32[k], row indices int64[k]), explain)`` instead: the
    k-selection runs on the device, so only 2k values cross back to the
    host (an extension over the reference's API, which always returns the
    dense vector).  Either way one copy to the host ends the query."""
    (query_fields, phrase_fields, bigram_fields, trigram_fields, mm,
     similarity) = _settings(qf, mm, pf, pf2, pf3, q_op, similarity)

    num_search_terms, search_terms, term_centric = parse_query_terms(
        frame, q, list(query_fields.keys())
    )
    phases = [(phrase_fields, 0, ps), (bigram_fields, 2, ps2),
              (trigram_fields, 3, ps3)]
    n_ph = len(phases)
    # Phrase phases contribute only at docs the main query matched.  At
    # scale (``_prunes_phases``) the matched docs are read once and the
    # exact phases score only those (the reference's candidate pruning,
    # solr.py:328-338), so their grams wait for the main query.  Otherwise
    # they score the whole corpus and are masked after, needing nothing of
    # the main query: each field scores its terms and its grams in one
    # batch.  The mask is taken once from the main scores: phase boosts
    # are non-negative and only ever add at already-positive rows.
    prune = (any(fields for fields, _, _ in phases)
             and _prunes_phases(len(frame)))
    rows, rows_p = None, [None] * n_ph
    calls = {} if prune else _phase_grams(search_terms, phases, rows_p)
    stacks = _field_batches(frame, query_fields, search_terms, calls,
                            similarity)
    compose = (_edismax_term_centric if term_centric
               else _edismax_field_centric)
    qf_scores, explain = compose(stacks, query_fields, num_search_terms,
                                 search_terms, mm, tie=tie)
    del stacks   # the main query's stacks go before any phase batch
    if prune:
        rows = _phase_candidate_rows(qf_scores)
        rows_p = _phase_rows(phases, similarity, rows)
        calls = _phase_grams(search_terms, phases, rows_p)
        for (field, at_rows), ent in calls.items():
            ent["scores"] = get_field(frame, field).score_batch_device(
                ent["grams"], similarity=similarity[field],
                slop=ent["slops"], rows=rows if at_rows else None)
        profiling.count("field_batches", len(calls))

    pos = qf_scores > 0
    rows_extras = []
    for pi, (extra, phase_explain) in enumerate(_ngram_phases(n_ph, calls)):
        explain += phase_explain
        if extra is None:
            continue
        if rows_p[pi] is None:
            qf_scores = qf_scores + torch.where(pos, extra, 0.0)
        else:
            rows_extras.append(extra)
    if rows_extras:
        # the main scores are positive exactly at these rows, so adding
        # there is the masked add
        rows_t = host_to_device(rows, qf_scores.device)
        for extra in rows_extras:
            qf_scores = qf_scores.index_add(0, rows_t, extra)

    if top_k is None:
        with profiling.span("batch.wait"):
            return qf_scores.cpu().numpy(), explain
    k = min(top_k, int(qf_scores.shape[0]))
    wire = pack_topk(qf_scores, k)
    with profiling.span("batch.wait"):
        wire = wire.cpu().numpy()
    return _unpack_topk(wire, k), explain


@profiling.spanned("composer.edismax")
def edismax_batch(frame: pd.DataFrame, queries: List[str], qf: List[str],
                  mm: Optional[Union[str, int]] = None,
                  pf: Optional[List[str]] = None,
                  pf2: Optional[List[str]] = None,
                  pf3: Optional[List[str]] = None,
                  ps2: int = 0, ps3: int = 0, ps: int = 0,
                  tie: float = 0.0, q_op: str = "OR",
                  similarity: Union[Similarity,
                                    Dict[str, Similarity]] = default_bm25,
                  top_k: Optional[int] = None,
                  ) -> Tuple[object, List[str]]:
    """Run one edismax configuration over a BATCH of query strings.

    Numerically identical to calling :func:`edismax` per query (to float32
    rounding: the batch folds the phase grams in one matrix product), but
    the whole batch runs as a handful of device calls with ONE copy to the
    host:

    - main query: per field, every query's terms score in one
      ``score_batch_device`` call (search/batch.py's groups);
    - dismax/tie/mm composition: per query, one K11 launch on rows of the
      shared stacks (the term-centric field sum rounded per add, as the
      JAX package's batch program rounds it);
    - pf/pf2/pf3 grams: per field, all queries' grams in one batched
      call, masked by each query's own matches;
    - finish: every gram is folded into its query by one float32 matrix
      product W[Q, G] @ grams[G, N] (per-gram boosts and the doubled final
      bigram folded into W), then the mask, then K3 ranks every row.

    Falls back to the scalar loop for custom (non-fused) similarities,
    sharded fields (``mesh=``) and sliced fields, as the JAX package
    does.

    Returns ``((scores f32[Q, k], indices i64[Q, k]), explains)`` with
    ``top_k``, else ``(scores f32[Q, N], explains)``.  Queries that
    tokenize to no terms score 0 everywhere.
    """
    call = dict(qf=qf, mm=mm, pf=pf, pf2=pf2, pf3=pf3, ps2=ps2, ps3=ps3,
                ps=ps, tie=tie, q_op=q_op, similarity=similarity,
                top_k=top_k)
    (query_fields, phrase_fields, bigram_fields, trigram_fields, mm,
     similarity) = _settings(qf, mm, pf, pf2, pf3, q_op, similarity)
    phases = [(phrase_fields, 0, ps), (bigram_fields, 2, ps2),
              (trigram_fields, 3, ps3)]

    all_fields = set(query_fields)
    for fields, _, _ in phases:
        all_fields |= set(fields)

    def _fallback():
        outs = [edismax(frame, q, **call) for q in queries]
        explains = [e for _, e in outs]
        if top_k is None:
            return np.stack([s for s, _ in outs]), explains
        return ((np.stack([s for (s, _i), _ in outs]),
                 np.stack([i for (_s, i), _ in outs])), explains)

    for field in all_fields:
        arr = get_field(frame, field)
        sim = similarity.get(field, default_bm25)
        if (getattr(sim, "_fused", None) is None or not arr._full_view
                or arr._state.sharded is not None):
            return _fallback()
    if not queries:
        if top_k is None:
            return np.zeros((0, len(frame)), np.float32), []
        return ((np.zeros((0, top_k), np.float32),
                 np.zeros((0, top_k), np.int64)), [])

    Q = len(queries)
    n = len(frame)
    field_order = list(query_fields)
    parsed = [parse_query_terms(frame, q, field_order) for q in queries]
    device = get_field(frame, field_order[0]).dev.device

    # ---- stage 1: every query's single terms, one batched device call
    # per field; a query's terms are contiguous rows of its field's stack
    terms_by_field: Dict[str, list] = {f: [] for f in field_order}
    starts = np.zeros((Q, len(field_order)), np.int64)
    for qi, (_n, st, _tc) in enumerate(parsed):
        for fi, field in enumerate(field_order):
            starts[qi, fi] = len(terms_by_field[field])
            terms_by_field[field] += [[t] for t in st[field]]
    stacks = [get_field(frame, field).score_batch_device(
        terms_by_field[field], similarity=similarity[field])
        for field in field_order]

    # ---- stage 2: compose each query's main score from its rows --------
    boosts = [_boost_val(query_fields[f]) for f in field_order]
    qf_rows, explains = [], []
    for qi, (num_terms, st, tc) in enumerate(parsed):
        own = [stacks[fi][starts[qi, fi]: starts[qi, fi] + len(st[f])]
               for fi, f in enumerate(field_order)]
        if tc:
            msm = parse_min_should_match(num_terms, spec=mm)
            explains.append(_tc_explain(query_fields, st, num_terms, msm))
            if num_terms == 0:
                qf_rows.append(torch.zeros(n, dtype=torch.float32,
                                           device=device))
            else:
                qf_rows.append(_compose_tc(own, boosts, float(tie), msm,
                                           chain=False))
        else:
            explain, msms = _fc_explain(query_fields, st, mm)
            explains.append(explain)
            qf_rows.append(_compose_fc(own, boosts, float(tie), msms))
    qf_scores = torch.stack(qf_rows)                     # [Q, N]
    del qf_rows

    # ---- stage 3: every query's phase grams, one batched device call
    # per field (per-row phrase scores are independent of the row set, so
    # masking by the query's own matches equals candidate-row pruning) ---
    gram_calls: Dict[str, dict] = {}
    for qi, (_num, st, _tc) in enumerate(parsed):
        for fields, ngram, slop in phases:
            min_terms = ngram if ngram else 2
            for field, boost in fields.items():
                terms = st[field]
                if len(terms) < min_terms:
                    continue
                grams = _grams_of(terms, ngram)
                ent = gram_calls.setdefault(
                    field, {"grams": [], "slops": [], "w": [], "qmap": []})
                for gi, gram in enumerate(grams):
                    w = _boost_val(boost)
                    if ngram == 2 and gi == len(grams) - 1:
                        w *= 2.0  # the reference double-appends the final
                        # bigram (solr.py:221)
                    ent["grams"].append(gram)
                    ent["slops"].append(slop)
                    ent["w"].append(w)
                    ent["qmap"].append(qi)
                    explains[qi] += _gram_explain(field, gram, slop, boost)

    gram_stacks, W_cols = [], []
    for field, ent in gram_calls.items():
        gram_stacks.append(get_field(frame, field).score_batch_device(
            ent["grams"], similarity=similarity.get(field, default_bm25),
            slop=ent["slops"]))
        W_cols.append((ent["qmap"], ent["w"]))

    # ---- stage 4: fold the grams, mask, rank; one copy to the host -----
    if gram_stacks:
        W = np.zeros((Q, sum(gs.shape[0] for gs in gram_stacks)), np.float32)
        g0 = 0
        for (qmap, ws), gs in zip(W_cols, gram_stacks):
            W[qmap, g0 + np.arange(len(qmap))] = ws
            g0 += int(gs.shape[0])
        # a float32 product: torch.backends.cuda.matmul.allow_tf32 is left
        # at its default, False (TF32 would keep three decimal digits)
        extras = host_to_device(W, device) @ torch.cat(gram_stacks)
        del gram_stacks
        qf_scores = qf_scores + torch.where(qf_scores > 0, extras, 0.0)
    if top_k is None:
        with profiling.span("batch.wait"):
            return qf_scores.cpu().numpy(), explains
    k = min(top_k, n)
    wire = pack_topk(qf_scores, k)
    with profiling.span("batch.wait"):
        wire = wire.cpu().numpy()
    return _unpack_topk(wire, k), explains
