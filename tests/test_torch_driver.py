"""The pretraining driver's own machinery on the CPU: checkpoints with
resume (bit-exact against uninterrupted training), the save on
KeyboardInterrupt, and `flasht5_tpu_torch.train.cli` end to end on a tiny
`pallas` YAML, run twice. None of it has a JAX counterpart to hold it to
(the JAX package writes Orbax checkpoints); the parity of the path's parts
with the JAX package is in tests/test_torch_pretrain.py.
"""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import yaml

from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.train import JSONLCallback, Trainer, TrainerConfig
from flasht5_tpu_torch.train import cli

TINY = FlashT5Config(vocab_size=256, d_model=64, d_kv=16, num_heads=4,
                     d_ff=128, num_layers=2, num_decoder_layers=2,
                     dropout_rate=0.0, pad_token_id=0, z_loss=1e-4,
                     dtype="float32", use_fused_layernorm=True,
                     use_fused_crossentropy=True, attention_type="pallas")
TRAIN = dict(learning_rate=5e-3, max_steps=3, warmup_steps=1,
             lr_scheduler="cosine", gradient_clip_norm=1.0,
             weight_decay=0.01, logging_steps=1)


def _batch(seed, b=2, enc=24, dec=16, vocab=256):
    """Random ids with the second row padded from position 17 on and the
    last labels ignored."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, size=(b, enc)).astype(np.int32)
    mask = np.ones((b, enc), bool)
    mask[1, 17:] = False
    ids[~mask] = 0
    labels = rng.integers(2, vocab, size=(b, dec)).astype(np.int32)
    labels[:, -3:] = -100
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

class _Saves(JSONLCallback):
    def __init__(self, path):
        super().__init__(path)
        self.saved = []

    def on_save(self, trainer, path):
        super().on_save(trainer, path)
        self.saved.append(path)


def _state_tensors(trainer):
    return ([p for _, p in t5.tree_leaves_with_path(trainer.params)]
            + [t for st in trainer.optimizer.state_dict()["state"]
               for t in st.values()])


def test_checkpoint_resume_is_bit_exact(tmp_path):
    """Four steps, a save, a restore into a new trainer and four more steps
    give the losses and parameters of eight uninterrupted steps exactly, on
    the CPU with dropout 0; the restored state equals the saved one bit for
    bit, the optimizer's step count included."""
    cfg = TINY
    kw = dict(TRAIN, max_steps=8, warmup_steps=2)
    batches = [_batch(30 + i) for i in range(8)]
    whole = Trainer(cfg, TrainerConfig(**kw), device="cpu")
    whole_logs = whole.train(iter(batches))["logs"]

    out = str(tmp_path / "run")
    tcfg = TrainerConfig(**kw, save_steps=4, output_dir=out)
    saves = _Saves(os.path.join(out, "tracker_log.jsonl"))
    first = Trainer(cfg, tcfg, callbacks=[saves], device="cpu")
    first_logs = first.train(iter(batches[:4]))["logs"]
    path = Trainer.latest_checkpoint(out)
    assert path == os.path.join(out, "step_4")
    assert saves.saved == [os.path.abspath(path)]
    assert sorted(os.listdir(out)) == ["config.json", "step_4",
                                       "tracker_log.jsonl", "train_log.jsonl"]
    with open(os.path.join(out, "train_log.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3, 4]
    assert FlashT5Config.from_json(
        open(os.path.join(out, "config.json")).read()) == cfg

    second = Trainer(cfg, tcfg, device="cpu")
    assert second.restore_checkpoint(path) == 4 == second.step_num
    assert second.optimizer.step_count == first.optimizer.step_count == 4
    for a, b in zip(_state_tensors(second), _state_tensors(first)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    second_logs = second.train(iter(batches[4:]))["logs"]
    assert [e["step"] for e in second_logs] == [5, 6, 7, 8]
    for got, want in zip(first_logs + second_logs, whole_logs):
        assert (got["loss"], got["grad_norm"]) == (want["loss"],
                                                   want["grad_norm"])
    for a, b in zip(_state_tensors(second), _state_tensors(whole)):
        assert torch.equal(a, b)


def test_trainer_saves_on_keyboard_interrupt(tmp_path):
    cfg = TINY
    out = str(tmp_path / "run")
    tr = Trainer(cfg, TrainerConfig(**dict(TRAIN, max_steps=8), save_steps=5,
                                    output_dir=out), device="cpu")

    def interrupted():
        yield _batch(40)
        yield _batch(41)
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        tr.train(interrupted())
    assert Trainer.latest_checkpoint(out) == os.path.join(out, "step_2")


def test_resume_passes_over_a_save_cut_short(tmp_path):
    """A save killed while it wrote leaves `step_<n>/` holding only the
    temporary file: resume takes the previous finished checkpoint."""
    out = str(tmp_path / "run")
    tcfg = TrainerConfig(**dict(TRAIN, max_steps=2), save_steps=2,
                         output_dir=out)
    first = Trainer(TINY, tcfg, device="cpu")
    first.train(iter([_batch(50), _batch(51)]))
    os.makedirs(os.path.join(out, "step_3"))
    with open(os.path.join(out, "step_3", "checkpoint.pt.tmp"), "wb") as f:
        f.write(b"\0" * 64)
    path = Trainer.latest_checkpoint(out)
    assert path == os.path.join(out, "step_2")
    second = Trainer(TINY, tcfg, device="cpu")
    assert second.restore_checkpoint(path) == 2
    for a, b in zip(_state_tensors(second), _state_tensors(first)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the driver, end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A tokenizer, a pretokenized dataset and a run YAML on `pallas`, made
    as tests/test_train_cli.py makes them."""
    root = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(50)]
    texts = [" ".join(rng.choice(words, size=rng.integers(30, 80)))
             for _ in range(64)]

    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE(byte_fallback=True))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    specials = ["<pad>", "</s>", "<unk>", "[R]", "[S]", "[X]"] + \
        [f"<extra_id_{i}>" for i in range(64)]
    tok.train_from_iterator(texts, trainers.BpeTrainer(
        vocab_size=512, special_tokens=specials))
    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", pad_token="<pad>",
        eos_token="</s>",
        additional_special_tokens=[f"<extra_id_{i}>" for i in range(64)]
        + ["[R]", "[S]", "[X]"])
    tok_dir = str(root / "tokenizer")
    fast.save_pretrained(tok_dir)

    import datasets
    ds = datasets.Dataset.from_dict({"text": texts})

    def tokenize(examples):
        out = fast(examples["text"], add_special_tokens=True)
        out["length"] = [len(x) for x in out["input_ids"]]
        return out

    data_dir = str(root / "data")
    ds.map(tokenize, batched=True, remove_columns=["text"]).save_to_disk(
        data_dir)
    cfg = {
        "model_args": {
            "d_model": 32, "d_kv": 8, "d_ff": 64, "num_heads": 4,
            "num_layers": 1, "dropout_rate": 0.0, "attention_scale": 1.0,
            "position_encoding_type": "t5", "attention_type": "pallas",
            "use_glu_mlp": True, "z_loss": 1e-4, "dtype": "float32",
            "max_sequence_length": 64, "use_triton_layernorm": True,
            "use_triton_crossentropy": True,
        },
        "training_args": {
            "tokenizer_name": tok_dir, "train_dataset_path": data_dir,
            "learning_rate": 1e-3, "max_steps": 4, "logging_steps": 1,
            "save_steps": 2, "per_device_train_batch_size": 4,
            "output_dir": str(root / "ckpt"),
        },
        "collator_args": {"max_length": 64, "max_labels_length": 32,
                          "min_size_inputs": 5},
    }
    cfg_path = str(root / "run.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    return {"cfg_path": cfg_path, "root": root}


def test_cli_trains_saves_and_resumes(workspace):
    """`cli.main` on a `pallas` YAML, twice: the first run trains 4 steps,
    saving at 2 and 4; the second finds step 4, says so, and stops there.
    Without `device`, the driver asks for the card."""
    ckpt = str(workspace["root"] / "ckpt")
    runs = []
    for _ in range(2):
        buf = io.StringIO()
        with redirect_stdout(buf):
            trainer, result = cli.main(workspace["cfg_path"], device="cpu")
        runs.append((buf.getvalue(), trainer, result))
    assert runs[0][2]["final_step"] == 4 and len(runs[0][2]["logs"]) == 4
    assert all(np.isfinite(e["loss"]) for e in runs[0][2]["logs"])
    assert "resuming from" not in runs[0][0]
    assert f"resuming from {os.path.join(ckpt, 'step_4')}" in runs[1][0]
    assert runs[1][2]["final_step"] == 4 and not runs[1][2]["logs"]
    names = sorted(os.listdir(ckpt))
    assert {"step_2", "step_4", "train_log.jsonl", "config.json",
            "tracker_log.jsonl"} <= set(names)
    assert runs[0][1].config.attention_type == "pallas"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(workspace["cfg_path"])
