"""The plain reference against the port's CPU path at a tiny size: the
same weights give the same logits, loss and gradients in float32, and the
same logits through int8 weights."""

import torch

from portbench.tests import tiny  # noqa: F401
from portbench.bench import weights
from portbench.drivers.pretrain import keystr
from portbench.reference import t5_ref

M = dict(vocab_size=300, d_model=64, d_kv=16, num_heads=4, d_ff=96,
         num_layers=2, num_decoder_layers=2, attention_scale=1.0,
         z_loss=1e-4, pad_token_id=0)


def _port(pallas=True):
    from flasht5_tpu_torch.config import FlashT5Config
    return FlashT5Config(**M, dtype="float32", dropout_rate=0.0,
                         attention_type="pallas" if pallas else "ref",
                         use_fused_layernorm=True,
                         use_fused_crossentropy=True)


def _batch():
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(5, 200, (3, 24), generator=g)
    labels = torch.randint(5, 200, (3, 8), generator=g)
    labels[:, -2:] = -100
    return ids, labels


def test_loss_and_gradients_match_the_port():
    from flasht5_tpu_torch.models import t5
    ids, labels = _batch()
    tree = weights.make(M, 3, "cpu")
    for _, t in weights.leaves(tree):
        t.requires_grad_(True)
    port = t5.forward(_port(), tree, input_ids=ids, labels=labels)["loss"]
    gp = torch.autograd.grad(port, [t for _, t in weights.leaves(tree)])
    ref = t5_ref.loss_sum(tree, ids, labels, M) / labels.numel()
    gr = torch.autograd.grad(ref, [t for _, t in weights.leaves(tree)])
    assert abs(float(port) - float(ref)) < 1e-5 * float(ref)
    for (path, _), a, b in zip(weights.leaves(tree), gp, gr):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6), keystr(path)


def test_int8_logits_match_the_port():
    # the port's int8 product rounds x to bf16 before it multiplies (its
    # kernel's arithmetic, `quant_matmul_plain`), ~2e-2 here; the
    # int8 rounding of the weights, which the reference follows, is larger
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.quantize import quantize_params
    ids, labels = _batch()
    dec = t5_ref.shift_right(labels, 0, 0)
    tree = weights.make(M, 4, "cpu")
    port = t5.forward(_port(), quantize_params(tree, "int8"), input_ids=ids,
                      decoder_input_ids=dec)["logits"]
    p = t5_ref.Precision(weights="int8")
    ref = t5_ref.logits(t5_ref.prepare(tree, p), ids, dec, M, p)
    unquantized = t5_ref.logits(tree, ids, dec, M)
    assert (port - ref).abs().max() < 3e-2
    assert (port - ref).abs().max() < 0.5 * (port - unquantized).abs().max()


def test_lower_precisions_move_the_logits():
    ids, labels = _batch()
    dec = t5_ref.shift_right(labels, 0, 0)
    tree = weights.make(M, 4, "cpu")
    base = t5_ref.logits(tree, ids, dec, M)
    for p in (t5_ref.Precision(weights="int4", kv="int4"),
              t5_ref.Precision(act="fp8")):
        low = t5_ref.logits(t5_ref.prepare(tree, p), ids, dec, M, p)
        assert (low - base).abs().max() > 1e-2


def test_span_corruption_undone():
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.train import cli
    from portbench.bench import traffic
    from portbench.bench.tokenizer import StubTokenizer
    from portbench.reference import span_ref
    v = 32768
    docs = traffic.documents({"count": 256, "length": {
        "lognormal": {"median": 600, "sigma": 1.0}, "min": 64,
        "max": 4000}}, v, 11)
    run_cfg = {"model_args": {}, "training_args": {
        "per_device_train_batch_size": 16, "seed": 3},
        "collator_args": {"max_length": 1024, "max_labels_length": 256,
                          "fixed_batch_size": True, "min_size_inputs": 5}}
    collator = cli.make_collator(run_cfg, StubTokenizer(v), FlashT5Config(
        vocab_size=v, pad_token_id=0))
    batches = [next(cli.batch_iterator(docs, collator, 16, seed=3))]
    assert span_ref.bad_rows(batches, docs, v, v - 1, v - 100) == 0
    b = {k: x.copy() for k, x in batches[0].items()}
    b["input_ids"][5, 10] += 1                 # a token of the text moved
    b["labels"][7, 3] = 9                      # a masked token replaced
    assert span_ref.bad_rows([b], docs, v, v - 1, v - 100) == 2
