"""Span corruption undone: a batch row of (inputs, labels) back to the
document text it was made from.

T5's span corruption replaces each masked span of a document chunk with a
sentinel in the inputs and lists the masked spans in the labels, each
unmasked span there replaced by a sentinel in turn; the inputs start with
the denoiser's task prefix and end with EOS. So the k-th sentinel of the
inputs stands for the k-th run of non-sentinel tokens in the labels (EOS
is dropped from both, so a span that held only the chunk's final EOS has
no run), and
putting them back gives the chunk, which has to be a contiguous slice of
one document of the corpus. Labels cut at their length limit lose their
last runs, and inputs cut at theirs their end; such a row is undone as far
as it goes.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def undo(inputs: np.ndarray, labels: np.ndarray, first_sentinel: int,
         last_sentinel: int, eos: int = 1, pad: int = 0,
         prefixes=(2, 3, 4)) -> Optional[np.ndarray]:
    """The chunk one row was made from (without its task prefix), or None
    where the row does not have the form span corruption gives."""
    def sentinel(x):
        return (x <= first_sentinel) & (x >= last_sentinel)

    x = inputs[inputs != pad]
    y = labels[labels != -100]
    x_cut = len(x) >= inputs.shape[-1] and x[-1] != eos
    if len(x) < 2 or x[0] not in prefixes or (x[-1] != eos and not x_cut) \
            or len(y) == 0 or y[-1] != eos:
        return None
    x, y = x[1:len(x) - (not x_cut)], y[:-1]
    runs, run = [], []
    for t in y:
        if sentinel(t):
            if run:
                runs.append(run)
            run = []
        else:
            run.append(int(t))
    cut = len(y) + 1 >= labels.shape[-1]
    if run and not cut:
        runs.append(run)
    out, k = [], 0
    for i, t in enumerate(x):
        if sentinel(t):
            if k >= len(runs):
                # the chunk's own EOS, masked alone: its run is empty once
                # EOS is dropped, so it can only be the last sentinel
                if cut or i == len(x) - 1:
                    break
                return None
            out += runs[k]
            k += 1
        else:
            out.append(int(t))
    if k < len(runs) and not cut:
        return None
    return np.asarray(out, np.int64)


class Corpus:
    """The documents, indexed by each position's pair of tokens."""

    def __init__(self, docs: List[np.ndarray], vocab: int):
        self.flat = np.concatenate(docs).astype(np.int64)
        ends = np.cumsum([len(d) for d in docs])
        self.doc_end = np.repeat(ends, [len(d) for d in docs])
        self.vocab = vocab
        keys = self.flat[:-1] * vocab + self.flat[1:]
        self.order = np.argsort(keys, kind="stable")
        self.keys = keys[self.order]

    def holds(self, chunk: np.ndarray) -> bool:
        """Whether chunk is a contiguous slice of one document."""
        n = len(chunk)
        if n < 2:
            return n == 1 and bool(np.any(self.flat == chunk[0]))
        key = chunk[0] * self.vocab + chunk[1]
        lo = np.searchsorted(self.keys, key, "left")
        hi = np.searchsorted(self.keys, key, "right")
        for p in self.order[lo:hi]:
            if p + n <= self.doc_end[p] and np.array_equal(
                    self.flat[p:p + n], chunk):
                return True
        return False


def bad_rows(batches, docs, vocab: int, first_sentinel: int,
             last_sentinel: int) -> int:
    """Rows of `batches` that do not undo to a slice of a document."""
    corpus = Corpus([d["input_ids"] for d in docs], vocab)
    bad = 0
    for b in batches:
        for x, y in zip(np.asarray(b["input_ids"]), np.asarray(b["labels"])):
            chunk = undo(x, y, first_sentinel, last_sentinel)
            if chunk is None or not corpus.holds(chunk):
                bad += 1
    return bad
