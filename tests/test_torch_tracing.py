"""The port's spans (`utils/profiling.py`: `span`, `recording`) on the CPU:
off they do nothing; on they keep names, parents and attributes and close
on exceptions; under `torch.profiler` they are `ft5.` annotations of the
Chrome trace. Then the spans the program puts at its layer boundaries: the
paged engine's tree and counts (with its request stamps), the trainer's
step and its phases (with the log's rate read after the step's loss), and
the collator's batch. Tiny shapes; a few seconds in all."""

import dataclasses
import json
import time
import tracemalloc

import numpy as np
import pytest
import torch

from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.data.ul2_collator import DataCollatorForUL2
from flasht5_tpu_torch.inference import engine, paged_engine
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.quantize import quantize_params
from flasht5_tpu_torch.train import Trainer, TrainerConfig, cli
from flasht5_tpu_torch.utils import profiling
from flasht5_tpu_torch.utils.profiling import recording, span


def _children(rec, parent):
    return [s for s in sorted(rec.spans, key=lambda s: s.start)
            if s.parent == parent]


# ---------------------------------------------------------------------------
# the facility
# ---------------------------------------------------------------------------

def test_span_off_records_nothing_and_allocates_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    null = span("paged.window", steps=8)
    assert not null and span("train.step") is null

    def loop():
        for i in range(10_000):
            with span("paged.window", steps=i) as sp:
                if sp:
                    sp.set(tokens=i)

    loop()
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        loop()
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # one kept allocation a call would be 10,000 of them
    assert now - before < 1024 and peak - before < 1024
    assert entered == [] and profiling._recorder is None


def test_spans_on_keep_names_parents_attributes_and_close_on_errors():
    with recording() as rec:
        with span("outer", n=1) as outer:
            with span("inner") as inner:
                inner.set(tokens=7)
            with pytest.raises(ValueError):
                with span("failing", uid=3):
                    raise ValueError("raised inside a span")
            with span("after"):
                pass
        outer.set(done=True)
    assert profiling._recorder is None
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["inner", "failing", "after",
                                           "outer"]
    top = by["outer"]
    assert top.parent is None and top.attrs == {"n": 1, "done": True}
    assert [s.name for s in _children(rec, top.id)] == ["inner", "failing",
                                                        "after"]
    assert by["inner"].attrs == {"tokens": 7}
    assert by["failing"].attrs == {"uid": 3}
    for s in rec.spans:
        assert s.start <= s.end
        assert top.start <= s.start and s.end <= top.end
    assert len({s.id for s in rec.spans}) == 4 and rec.dropped == 0
    # the stack unwound: a new span after the block opens at the top
    with recording() as again:
        with span("next"):
            pass
    assert again.spans[0].parent is None


def test_recorder_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "_SPAN_LIMIT", 3)
    with recording() as rec:
        for _ in range(5):
            with span("x"):
                pass
    assert len(rec.spans) == 3 and rec.dropped == 2


def test_spans_are_annotations_of_the_profilers_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("train.step", step=1):
            with span("train.forward"):
                torch.ones((16, 16)).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"ft5.train.step", "ft5.train.forward"} <= names
    assert span("train.step") is profiling._NULL_SPAN


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=512, d_model=64, d_kv=16, num_heads=4, d_ff=128,
            num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
            dtype="float32", pad_token_id=0)


@pytest.fixture(scope="module")
def served():
    cfg = FlashT5Config(**TINY)
    params = quantize_params(t5.init_params(cfg, seed=0, device="cpu"),
                             "int8")
    return cfg, params


def _paged(served, **kw):
    cfg, params = served
    base = dict(max_slots=3, page_size=4, num_pages=12, max_pages_per_slot=3,
                max_encode_len=16, encode_buckets=(8, 16), kv_dtype="int8",
                steps_per_sync=3)
    return paged_engine.PagedInferenceEngine(
        cfg, params, paged_engine.PagedEngineConfig(**{**base, **kw}),
        device="cpu")


def _requests(n=7):
    rng = np.random.default_rng(3)
    return [engine.Request(uid=100 + i, input_ids=rng.integers(
        2, 512, size=int(rng.integers(4, 16))).astype(np.int32),
        max_new_tokens=int(rng.integers(2, 9))) for i in range(n)]


def test_paged_engine_spans_and_counts(served):
    # 5 pages of 4 under 3 slots of up to 9 tokens: admissions defer
    eng = _paged(served, num_pages=5)
    requests = _requests()
    with recording() as rec:
        done = eng.run(requests)
    assert all(r.result is not None for r in done)
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ["paged.run"]
    run = roots[0]
    assert run.attrs == {}
    top = _children(rec, run.id)
    assert {s.name for s in top} == {"paged.admit", "paged.window",
                                     "paged.schedule"}
    # each window is followed by its harvest and an admission
    names = [s.name for s in top]
    assert names[0] == "paged.admit"
    assert names[1:] == ["paged.window", "paged.schedule",
                         "paged.admit"] * ((len(names) - 1) // 3)
    for s in rec.spans:
        parent = {"paged.encode": "paged.admit",
                  "paged.insert": "paged.admit"}.get(s.name, "paged.run")
        if s is not run:
            assert next(p.name for p in rec.spans if p.id == s.parent) \
                == parent
    admits = [s for s in top if s.name == "paged.admit"]
    windows = [s for s in top if s.name == "paged.window"]
    inserts = [s for s in rec.spans if s.name == "paged.insert"]
    encodes = [s for s in rec.spans if s.name == "paged.encode"]
    # an admission's requests are its inserts, each request once, by uid
    assert eng.deferrals > 0
    assert all(s.attrs == {} for s in top if s.name != "paged.window")
    assert sorted(s.attrs["uid"] for s in inserts) == \
        sorted(r.uid for r in requests)
    assert sum(1 for a in admits for s in inserts if s.parent == a.id) == \
        len(requests)
    for a in admits:
        mine = sum(1 for s in inserts if s.parent == a.id)
        rows = sum(s.attrs["rows"] for s in encodes if s.parent == a.id)
        assert (mine == 0) == (rows == 0) and rows >= mine
    assert sum(s.attrs["tokens"] for s in windows) == \
        sum(len(r.result) for r in done)
    assert all(s.attrs.keys() == {"steps", "tokens"} and s.attrs["steps"] == 3
               for s in windows)
    assert {s.attrs["bucket"] for s in encodes} <= {8, 16}


def test_paged_engine_stamps_every_finished_request(served):
    ticks = iter(range(10_000))
    eng = _paged(served)
    done = eng.run(_requests(), now=lambda: float(next(ticks)))
    for r in done:
        assert r.result is not None
        assert 0 < r.admitted_at < r.first_token_at <= r.finished_at, r.uid
    # the stamps do not change what is served, nor need a recorder
    again = _paged(served).run(_requests())
    for a, b in zip(done, again):
        np.testing.assert_array_equal(a.result, b.result)
        assert 0 <= b.admitted_at <= b.first_token_at <= b.finished_at


# ---------------------------------------------------------------------------
# the trainer and the collator
# ---------------------------------------------------------------------------

TRAIN_TINY = dict(vocab_size=256, d_model=32, d_kv=8, num_heads=4, d_ff=64,
                  num_layers=1, num_decoder_layers=1, dropout_rate=0.0,
                  pad_token_id=0, dtype="float32")


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(2, 256, size=(2, 12)).astype(np.int32),
            "labels": rng.integers(2, 256, size=(2, 6)).astype(np.int32)}


class Counted:
    def __init__(self, n):
        self.batches = [_batch(i) for i in range(n)]
        self.fetched = 0

    def __iter__(self):
        return self

    def __next__(self):
        self.fetched += 1
        if self.fetched > len(self.batches):
            raise StopIteration
        return self.batches[self.fetched - 1]


@pytest.mark.parametrize("batches,max_steps,fetched", [(5, 3, 4), (2, 3, 3)])
def test_trainer_step_spans(batches, max_steps, fetched):
    cfg = FlashT5Config(**TRAIN_TINY)
    tr = Trainer(cfg, TrainerConfig(max_steps=max_steps, logging_steps=2),
                 device="cpu")
    feed = Counted(batches)
    with recording() as rec:
        res = tr.train(feed)
    steps = min(batches, max_steps)
    # the iterator called as before: at max_steps once more, or to its end
    assert feed.fetched == fetched and res["final_step"] == steps
    tops = [s for s in sorted(rec.spans, key=lambda s: s.start)
            if s.parent is None]
    # each fetch, then the step that takes its batch; the last fetch alone
    assert [s.name for s in tops] == \
        ["train.batch", "train.step"] * steps + ["train.batch"]
    phases = ["train.to_device", "train.forward", "train.backward",
              "train.optimizer"]
    for n, top in enumerate(tops[1::2], start=1):
        assert top.attrs == {"step": n, "tokens": 2 * 12 + 2 * 6}
        logged = n % 2 == 0 or n == max_steps
        assert [s.name for s in _children(rec, top.id)] == \
            phases + ["train.log"] * logged
    assert all(s.attrs == {} and not _children(rec, s.id)
               for s in tops[0::2])
    assert len(res["logs"]) == sum(n % 2 == 0 or n == max_steps
                                   for n in range(1, steps + 1))


class SlowLoss:
    """A loss whose read takes `seconds`, as a read that waits for the
    card does."""

    def __init__(self, seconds):
        self.seconds = seconds

    def __float__(self):
        time.sleep(self.seconds)
        return 1.0


def test_logged_rate_counts_the_wait_for_the_loss():
    cfg = FlashT5Config(**TRAIN_TINY)
    tr = Trainer(cfg, TrainerConfig(max_steps=1, logging_steps=1),
                 device="cpu")
    tr._step = lambda batch: {"loss": SlowLoss(0.2), "grad_norm": 0.0}
    entry = tr.train([_batch(0)])["logs"][0]
    assert entry["loss"] == 1.0
    assert entry["tokens_per_sec"] <= (2 * 12 + 2 * 6) / 0.2


class StubTokenizer:
    """100 sentinels at ids 900..999, eos 1, pad 0 (as
    tests/test_torch_pretrain.py's)."""
    eos_token_id = 1
    pad_token_id = 0
    all_special_tokens = [f"<extra_id_{i}>" for i in range(100)] + [
        "</s>", "<pad>"]
    all_special_ids = [999 - i for i in range(100)] + [1, 0]

    def encode(self, text):
        return {"[R]": [10, 1], "[S]": [11, 1], "[X]": [12, 1]}.get(
            text, [13, 1])


def test_collator_span_counts_its_batch():
    coll = DataCollatorForUL2(
        StubTokenizer(), max_length=64, max_labels_length=32, batch_size=4,
        denoiser_list=[dataclasses.asdict(d) for d in cli.UL2_DENOISERS],
        denoiser_proportions=cli.UL2_PROPORTIONS, min_size_inputs=5, seed=1,
        use_native=False)
    rng = np.random.default_rng(0)
    examples = [{"input_ids": rng.integers(20, 800, size=int(
        rng.integers(8, 120))).astype(np.int32)} for _ in range(9)]
    with recording() as rec:
        batch = coll(examples)
    (s,) = rec.spans
    assert s.name == "data.collate" and s.parent is None
    assert s.attrs == {"rows": batch["input_ids"].shape[0],
                       "input_tokens": int(batch["attention_mask"].sum())}
    assert 0 < s.attrs["input_tokens"] < s.attrs["rows"] * 64
