"""UL2 mixture-of-denoisers collation with best-fit sequence packing.

A copy of `flasht5_tpu/data/ul2_collator.py` (this package imports nothing
of the JAX package), which re-implements the reference collator
(src/data/data_collator_ul2.py): per-example denoiser sampling by
proportion, truncation to the denoiser's optimal length with random chunk
start, Mesh-TF random-spans noise masks (with the S-denoiser
single-suffix-span special case), sentinel creation/merging, masked-token
filtering with `[R]/[S]/[X]` prefixes and EOS, best-fit bin packing bounded
by input length / label length / sentinel budget, contiguous descending
sentinel renumbering, right-padding (or causal-LM left-pad + concatenation),
`fixed_batch_size` wrap-around padding, attention mask from pad, and -100
label padding. The same seed gives the same arrays as the JAX package's.

Host-side numpy: outputs are dense int32 / bool arrays, which the trainer
moves to the card. Randomness flows through an explicit numpy Generator.

One difference from the JAX package: with `use_native=True` the native core
(`flasht5_tpu_torch/native`) is required, and a failed build or load
raises, where the JAX package falls back to numpy silently and so draws
another noise-mask stream (ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from flasht5_tpu_torch import native
from flasht5_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class Denoiser:
    """One UL2 denoiser: mean span length mu, corruption rate r, max span
    count, and the task prefix text (e.g. "[R]", "[S]", "[X]")."""
    mu: float
    r: float
    max_spans: int
    prefix: str


def compute_input_and_target_lengths(inputs_length: int, noise_density: float,
                                     mean_noise_span_length: float,
                                     *, max_length: Optional[int] = None,
                                     max_labels_length: Optional[int] = None):
    """Raw-token budget solver (reference spec: data_collator_ul2.py:171-220):
    find the raw length whose corrupted encoding exactly fills
    `inputs_length`, and the resulting target length. Mirrors the reference's
    causal-LM special case for noise_density == 0."""

    def lengths(tokens_length):
        num_noise = int(round(tokens_length * noise_density))
        num_nonnoise = tokens_length - num_noise
        num_spans = int(round(num_noise / mean_noise_span_length))
        return num_nonnoise + num_spans + 1, num_noise + num_spans + 1

    if noise_density == 0.0:
        assert max_length is not None and max_labels_length is not None
        return (max_labels_length - 2 + int(max_length // mean_noise_span_length) - 2,
                inputs_length)

    tokens_length = inputs_length
    while lengths(tokens_length + 1)[0] <= inputs_length:
        tokens_length += 1
    in_len, tgt_len = lengths(tokens_length)
    if noise_density == 0.5 and tgt_len > in_len:
        tokens_length -= 1
        tgt_len -= 1
    return tokens_length, tgt_len


def _random_segmentation(num_items: int, num_segments: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Random partition of num_items into num_segments positive parts."""
    first = np.arange(num_items - 1) < (num_segments - 1)
    rng.shuffle(first)
    first = np.pad(first, [[1, 0]])
    segment_id = np.cumsum(first)
    _, lengths = np.unique(segment_id, return_counts=True)
    return lengths


def random_spans_noise_mask(sequence_length: int, denoiser: Denoiser,
                            rng: np.random.Generator) -> np.ndarray:
    """Boolean noise mask with alternating nonnoise/noise spans
    (reference spec: data_collator_ul2.py:222-295; S-denoiser max_spans == 1
    forces a single suffix span)."""
    if denoiser.max_spans == 1:
        prefix_span = int(np.round(sequence_length / denoiser.mu))
        interleaved = np.array([prefix_span, sequence_length - prefix_span])
    else:
        num_noise = int(np.round(sequence_length * denoiser.r))
        num_noise = min(max(num_noise, 1), sequence_length - 1)
        num_spans = min(denoiser.max_spans,
                        int(np.round(num_noise / denoiser.mu)))
        num_spans = max(num_spans, 1)
        num_nonnoise = sequence_length - num_noise
        noise_lengths = _random_segmentation(num_noise, num_spans, rng)
        nonnoise_lengths = _random_segmentation(num_nonnoise, num_spans, rng)
        interleaved = np.stack([nonnoise_lengths, noise_lengths], axis=1).reshape(-1)

    starts = np.cumsum(interleaved)[:-1]
    indicator = np.zeros((sequence_length,), np.int8)
    indicator[starts] = 1
    return (np.cumsum(indicator) % 2 == 1)


class DataCollatorForUL2:
    """Collate tokenized examples into UL2 denoising batches.

    Parameters mirror the reference constructor (data_collator_ul2.py:11-44).
    `tokenizer` needs: encode(text) -> ids (with eos), eos_token_id,
    pad_token_id, and the contiguous extra-id sentinel range (provided either
    by HF-tokenizer introspection or the explicit `extra_ids` argument).
    """

    def __init__(self, tokenizer, max_length: int, max_labels_length: int,
                 batch_size: int, denoiser_list: Sequence, denoiser_proportions: Sequence[float],
                 causal: bool = False, random_chunk: bool = True,
                 fixed_batch_size: bool = False, min_size_inputs: int = 10,
                 extra_ids: Optional[Sequence[int]] = None,
                 seed: Optional[int] = None, use_native: bool = True):
        props = np.asarray(denoiser_proportions, np.float64)
        self.denoiser_proportions = (props / props.sum()).tolist()
        self.denoisers = [
            d if isinstance(d, Denoiser) else
            Denoiser(mu=d["mu"], r=d["r"], max_spans=d["max_spans"], prefix=d["prefix"])
            for d in denoiser_list
        ]
        self.tokenizer = tokenizer
        self.rng = np.random.default_rng(seed)

        # task-prefix token ids, without the trailing EOS
        self.prefixes = []
        for d in self.denoisers:
            ids = np.asarray(tokenizer.encode(d.prefix), np.int32).reshape(-1)
            if len(ids) and ids[-1] == tokenizer.eos_token_id:
                ids = ids[:-1]
            self.prefixes.append(ids)

        if extra_ids is None:
            extra_ids = sorted(
                (tid for tok, tid in zip(tokenizer.all_special_tokens,
                                         tokenizer.all_special_ids)
                 if "extra" in tok), reverse=True)
        self.extra_ids = list(extra_ids)  # descending, contiguous
        assert self.extra_ids, "no sentinel (extra-id) tokens available"

        self.max_length = max_length
        self.max_labels_length = max_labels_length
        self.batch_size = batch_size
        self.causal = causal
        self.random_chunk = random_chunk
        self.fixed_batch_size = fixed_batch_size
        self.min_size_inputs = min_size_inputs
        self.use_native = use_native

        max_prefix = max(len(p) for p in self.prefixes)
        self.denoiser_optimal_len = [
            compute_input_and_target_lengths(
                max_length - max_prefix, d.r, d.mu,
                max_length=max_length, max_labels_length=max_labels_length)
            for d in self.denoisers
        ]

    # -- span machinery ----------------------------------------------------

    def is_sentinel(self, ids: np.ndarray) -> np.ndarray:
        return (ids <= self.extra_ids[0]) & (ids >= self.extra_ids[-1])

    def create_sentinel_ids(self, mask: np.ndarray) -> np.ndarray:
        """Span starts -> provisional sentinel ids; continuation positions -> -1
        (to be deleted). (reference spec: data_collator_ul2.py:298-311)"""
        mask = mask.astype(np.int8)
        starts = mask - np.roll(mask, 1, axis=-1) * mask
        starts[0] = mask[0]
        sentinel = np.where(starts != 0, np.cumsum(starts, axis=-1), starts)
        sentinel = np.where(sentinel != 0, self.extra_ids[0] - sentinel, 0)
        sentinel -= mask - starts
        return sentinel

    def filter_input_ids(self, input_ids: np.ndarray, sentinel: np.ndarray,
                         prefix: Optional[np.ndarray] = None,
                         with_eos: bool = True) -> np.ndarray:
        """Apply sentinels, drop continuation tokens and EOS, prepend prefix,
        append EOS. Returns (1, L'). (reference spec: :313-337)"""
        ids = np.where(sentinel != 0, sentinel, input_ids.reshape(-1))
        ids = ids[ids != self.tokenizer.eos_token_id]
        ids = ids[ids >= 0].astype(np.int32)
        if prefix is not None:
            ids = np.concatenate([prefix.astype(np.int32), ids])
        if with_eos:
            ids = np.concatenate([ids, [np.int32(self.tokenizer.eos_token_id)]])
        return ids.reshape(1, -1)

    def _noise_mask(self, length: int, denoiser: Denoiser) -> np.ndarray:
        """Span noise mask: from the native C++ core with `use_native`
        (seeded from this collator's Generator, so streams stay
        reproducible), else numpy."""
        if self.use_native and length > 1:
            seed = int(self.rng.integers(0, 2 ** 63 - 1))
            return native.native_noise_mask(length, denoiser.mu, denoiser.r,
                                            denoiser.max_spans, seed)
        return random_spans_noise_mask(length, denoiser, self.rng)

    # -- packing -----------------------------------------------------------

    def _best_fit(self, inputs: List, labels: List):
        """Greedy first-fit packing into <= batch_size bins bounded by input
        length, label length and sentinel budget (reference spec: :49-87).

        With `use_native`, the native C++ core's loops (native/ul2_core.cpp,
        the same assignment); else the numpy rescans below."""
        n_sentinels = len(self.extra_ids)
        if self.use_native:
            assign = native.native_best_fit(
                np.asarray([x.shape[1] for x in inputs], np.int64),
                np.asarray([y.shape[1] for y in labels], np.int64),
                np.asarray([int(self.is_sentinel(x).sum()) for x in inputs],
                           np.int64),
                self.max_length, self.max_labels_length, n_sentinels,
                self.batch_size)
            out_inputs, out_labels = [], []
            for b in range(self.batch_size):
                idx = [i for i, a in enumerate(assign) if a == b]
                if idx:
                    out_inputs.append(
                        np.concatenate([inputs[i] for i in idx], axis=1))
                    out_labels.append(
                        np.concatenate([labels[i] for i in idx], axis=1))
            return out_inputs, out_labels

        out_inputs, out_labels = [], []
        for _ in range(self.batch_size):
            bin_in, bin_lb = [], []
            len_in = len_lb = n_special = 0
            for idx, (x, y) in enumerate(zip(inputs, labels)):
                if x is None:
                    continue
                sx, sy = x.shape[1], y.shape[1]
                ns = int(self.is_sentinel(x).sum())
                if (len_in + sx < self.max_length
                        and len_lb + sy < self.max_labels_length
                        and n_special + ns < n_sentinels):
                    bin_in.append(x)
                    bin_lb.append(y)
                    len_in += sx
                    len_lb += sy
                    n_special += ns
                    inputs[idx] = None
                    labels[idx] = None
            if bin_in:
                out_inputs.append(np.concatenate(bin_in, axis=1))
                out_labels.append(np.concatenate(bin_lb, axis=1))
        return out_inputs, out_labels

    # -- main --------------------------------------------------------------

    def __call__(self, examples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        """One batch, as a span `data.collate` (`rows`; `input_tokens`, the
        input tokens that are not padding)."""
        with span("data.collate") as sp:
            batch = self._collate(examples)
            if sp:
                sp.set(rows=int(batch["input_ids"].shape[0]),
                       input_tokens=int(batch["attention_mask"].sum()))
        return batch

    def _collate(self, examples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        examples = [self._normalize(x) for x in examples]
        examples = [x for x in examples if x["input_ids"].shape[1] > self.min_size_inputs]

        n = len(examples)
        choice = self.rng.choice(len(self.denoisers), n,
                                 p=self.denoiser_proportions)

        # truncate to the denoiser-optimal raw length, random chunk start
        truncated = []
        for i, x in enumerate(examples):
            max_len = self.denoiser_optimal_len[choice[i]][0]
            length = x["input_ids"].shape[1]
            if length > max_len:
                start = int(self.rng.integers(0, length - max_len)) if self.random_chunk else 0
                truncated.append(x["input_ids"][:, start:start + max_len])
            else:
                truncated.append(x["input_ids"])

        masks = [self._noise_mask(t.shape[1], self.denoisers[choice[i]])
                 for i, t in enumerate(truncated)]
        in_sentinels = [self.create_sentinel_ids(m) for m in masks]
        lb_sentinels = [self.create_sentinel_ids(~m) for m in masks]

        inputs = [self.filter_input_ids(t, in_sentinels[i], self.prefixes[choice[i]])
                  for i, t in enumerate(truncated)]
        labels = [self.filter_input_ids(t, lb_sentinels[i], with_eos=False)
                  for i, t in enumerate(truncated)]

        if len(inputs) != self.batch_size:
            inputs, labels = self._best_fit(inputs, labels)

        # renumber sentinels to contiguous descending extra ids (:134-135)
        def renumber(x):
            sent = self.is_sentinel(x)
            return np.where(sent, self.extra_ids[0] - np.cumsum(sent) + 1, x)

        labels = [renumber(y) for y in labels]
        inputs = [renumber(x) for x in inputs]

        eos = np.int32(self.tokenizer.eos_token_id)
        pad = np.int32(self.tokenizer.pad_token_id)
        labels = [np.concatenate([y, np.full((1, 1), eos, np.int32)], axis=-1)
                  for y in labels]

        # Defensive truncation: when the batch bypasses packing (exactly
        # batch_size inputs, reference data_collator_ul2.py:129-130) nothing
        # has enforced the length bounds, and a high-noise-rate denoiser can
        # emit labels longer than max_labels_length. Truncate, keeping the
        # terminal EOS on labels.
        def clamp(x, limit, keep_eos):
            if x.shape[1] <= limit:
                return x
            x = x[:, :limit].copy()
            if keep_eos:
                x[:, -1] = eos
            return x

        labels = [clamp(y, self.max_labels_length, True) for y in labels]
        inputs = [clamp(x, self.max_length, False) for x in inputs]

        if self.causal:
            labels = np.concatenate(
                [np.pad(y, ((0, 0), (0, self.max_labels_length - y.shape[1])),
                        constant_values=pad) for y in labels], axis=0)
            inputs = np.concatenate(
                [np.pad(x, ((0, 0), (self.max_length - x.shape[1], 0)),
                        constant_values=pad) for x in inputs], axis=0)
        else:
            labels = np.concatenate(
                [np.pad(y, ((0, 0), (0, self.max_labels_length - y.shape[1])),
                        constant_values=pad) for y in labels], axis=0)
            inputs = np.concatenate(
                [np.pad(x, ((0, 0), (0, self.max_length - x.shape[1])),
                        constant_values=pad) for x in inputs], axis=0)

        if self.fixed_batch_size and inputs.shape[0] < self.batch_size:
            inputs = np.pad(inputs, ((0, self.batch_size - inputs.shape[0]), (0, 0)),
                            mode="wrap")
            labels = np.pad(labels, ((0, self.batch_size - labels.shape[0]), (0, 0)),
                            mode="wrap")

        if self.causal:
            input_ids = np.concatenate([inputs, labels], axis=-1)
            out_labels = input_ids.copy()
        else:
            input_ids = inputs
            out_labels = labels.copy()
        attention_mask = input_ids != pad
        out_labels[out_labels == pad] = -100

        return {
            "input_ids": input_ids.astype(np.int32),
            "attention_mask": attention_mask,
            "labels": out_labels.astype(np.int32),
        }

    @staticmethod
    def _normalize(example):
        ids = np.asarray(example["input_ids"], np.int32)
        if ids.ndim == 1:
            ids = ids.reshape(1, -1)
        return {"input_ids": ids}
