"""The bytes a call's work needs, counted from the corpus and the query
alone: what any implementation has to read at least once, whatever its
groups, layouts or launches.

For each field the call reads: its doc lengths (4 bytes a doc), and for
each distinct word it reads there the word's postings in a canonical
form, a doc id and a frequency (4 + 4 bytes) per doc holding the word,
plus one position (4 bytes) per occurrence where a phrase or slop query
needs positions; then each result written, a score and a doc index
(4 + 4 bytes).  ``needs`` maps a field to {word: needs positions}; a
word the corpus never uses reads nothing.

  bytes = sum over fields f [ 4 N_f + sum_w (8 df_fw + 4 cf_fw [pos]) ]
          + 8 results
"""


def call_bytes(needs, indexes, n_results):
    total = 8 * n_results
    for field, words in needs.items():
        index = indexes[field]
        total += 4 * index.n_docs
        for word, positional in words.items():
            tid = index.term_id(word)
            if tid < 0:
                continue
            docs, tf, _ = index.stats(tid)
            total += 8 * len(docs)
            if positional:
                total += 4 * int(tf.sum())
    return total
