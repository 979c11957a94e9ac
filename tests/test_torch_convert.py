"""The port's checkpoint interchange (`flasht5_tpu_torch/convert/`) against
the safetensors package and the JAX package's `convert/hf_import.py`.

- the port's safetensors writer read by the package, and the package's
  files read by the port, every supported type, bit for bit;
- `hf_key_to_fat5` and `state_dict_to_params` leaf for leaf against the
  JAX package's, on every golden state_dict (`tests/golden/ref_*.npz`) and
  on HF T5 key names: exact (both transpose and cast the same f32 values);
- the export (`params_to_fat5_state_dict`) against the JAX package's, and
  its round trip through a file: exact;
- the T5 goldens' loss through the port's own import, with no JAX on that
  path: 2e-5, the tolerance of tests/test_golden_reference.py on `ref`;
- `convert.cli`: the HF rename and the export of a trainer checkpoint.
"""

import glob
import json
import os
import re

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import load_file as st_load
from safetensors.torch import save_file as st_save

from flasht5_tpu.convert import hf_import as jax_hf
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import (cli, hf_key_to_fat5,
                                       load_fat5_safetensors,
                                       load_hf_t5_safetensors,
                                       params_to_fat5_state_dict,
                                       safetensors_file,
                                       state_dict_to_params, validate_params)
from flasht5_tpu_torch.models import t5

GOLDENS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden",
                                        "ref_*.npz")))
GOLDEN_IDS = [os.path.basename(p)[4:-4] for p in GOLDENS]
T5_GOLDENS = [p for p in GOLDENS if "ref_t5_" in p]


def _golden(path):
    """(config dict, state_dict, arrays), as tests/test_golden_reference.py
    reads them."""
    z = np.load(path)
    cfg = json.loads(bytes(z["config_json"]).decode())
    sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")
          and not k.endswith("embed_tokens.weight")}
    return cfg, sd, z


def _leaves(tree):
    return [(path, t.detach().numpy())
            for path, t in t5.tree_leaves_with_path(tree)]


def _all_types():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 9, generator=g).to(torch.bfloat16),
        "i8": torch.randint(-128, 127, (11,), generator=g, dtype=torch.int8),
        "i32": torch.randint(-9, 9, (4, 1), generator=g, dtype=torch.int32),
        "i64": torch.arange(5),
        "f8": torch.randn(6, generator=g).to(torch.float8_e4m3fn),
        "empty": torch.zeros(0, 3),
    }


def _bits(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@pytest.mark.parametrize("writer", ["port", "package"])
def test_safetensors_interchange(tmp_path, writer):
    tensors = _all_types()
    path = str(tmp_path / "t.safetensors")
    if writer == "port":
        safetensors_file.save_file(tensors, path, {"format": "pt"})
        got = st_load(path)
        assert safetensors_file.read_header(path)["__metadata__"] == {
            "format": "pt"}
    else:
        st_save(tensors, path)
        got = safetensors_file.load_file(path)
    assert sorted(got) == sorted(tensors)
    for name, t in tensors.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape
        assert torch.equal(_bits(got[name]), _bits(t)), name
    # numpy: bf16 and fp8 widened to f32, the rest in their own types
    arrays = safetensors_file.load_file(path, framework="np")
    for name, t in tensors.items():
        np.testing.assert_array_equal(arrays[name], t.float().numpy()
                                      if t.dtype in (torch.bfloat16,
                                                     torch.float8_e4m3fn)
                                      else t.numpy())


def test_safetensors_refuses_a_bad_range(tmp_path):
    path = str(tmp_path / "t.safetensors")
    safetensors_file.save_file({"a": torch.ones(4)}, path)
    raw = bytearray(open(path, "rb").read())
    open(path, "wb").write(raw[:-4])          # the last value cut off
    with pytest.raises(ValueError, match="byte range"):
        safetensors_file.load_file(path)


HF_KEYS = [
    "encoder.block.0.layer.0.SelfAttention.q.weight",
    "encoder.block.3.layer.0.SelfAttention.o.weight",
    "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
    "decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
    "decoder.block.2.layer.1.EncDecAttention.k.weight",
    "decoder.block.2.layer.1.EncDecAttention.o.weight",
    "encoder.block.1.layer.1.DenseReluDense.wi_0.weight",
    "encoder.block.1.layer.1.DenseReluDense.wi.weight",
    "decoder.block.5.layer.2.DenseReluDense.wo.weight",
    "encoder.block.1.layer.0.layer_norm.weight",
    "decoder.block.1.layer.1.layer_norm.weight",
    "decoder.block.1.layer.2.layer_norm.weight",
    "encoder.block.1.layer.1.layer_norm.weight",
    "encoder.final_layer_norm.weight", "shared.weight", "lm_head.weight",
]


@pytest.mark.parametrize("path", GOLDENS, ids=GOLDEN_IDS)
def test_import_matches_jax(path):
    _, sd, _ = _golden(path)
    for key in list(sd) + HF_KEYS:
        assert hf_key_to_fat5(key) == jax_hf.hf_key_to_fat5(key), key
    got = _leaves(state_dict_to_params(sd, device="cpu"))
    want = jax.tree_util.tree_leaves_with_path(
        jax_hf.state_dict_to_params(sd))
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=p)


@pytest.mark.parametrize("path", GOLDENS, ids=GOLDEN_IDS)
def test_export_matches_jax_and_round_trips(tmp_path, path):
    _, sd, _ = _golden(path)
    params = state_dict_to_params(sd, device="cpu")
    state = params_to_fat5_state_dict(params)
    want = jax_hf.params_to_fat5_state_dict(jax_hf.state_dict_to_params(sd))
    assert sorted(state) == sorted(want) == sorted(sd)
    for key, t in state.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[key]),
                                      err_msg=key)
    file = str(tmp_path / "ckpt.safetensors")
    safetensors_file.save_file(state, file)
    back = load_fat5_safetensors(file, device="cpu")
    for (p, a), (q, b) in zip(_leaves(params), _leaves(back)):
        assert p == q
        np.testing.assert_array_equal(a, b, err_msg=p)


@pytest.mark.parametrize("path", T5_GOLDENS,
                         ids=[os.path.basename(p)[4:-4] for p in T5_GOLDENS])
def test_golden_loss_through_the_port_import(tmp_path, path):
    cfg_json, sd, z = _golden(path)
    file = str(tmp_path / "golden.safetensors")
    safetensors_file.save_file(sd, file)
    cfg = FlashT5Config.from_dict(dict(cfg_json, dtype="float32",
                                       param_dtype="float32"))
    params = load_fat5_safetensors(file, device="cpu")
    validate_params(params, cfg)
    with torch.no_grad():
        out = t5.forward(cfg, params,
                         input_ids=torch.from_numpy(z["input_ids"]),
                         attention_mask=torch.from_numpy(z["attention_mask"]),
                         labels=torch.from_numpy(z["labels"]))
    assert abs(float(out["loss"]) - float(z["loss"])) < 2e-5


def test_validate_params_refuses_a_wrong_config():
    _, sd, _ = _golden(T5_GOLDENS[0])
    params = state_dict_to_params(sd, device="cpu")
    n = len(params["encoder"]["block"])
    d = params["shared"]["embedding"].shape[1]
    with pytest.raises(ValueError, match="blocks"):
        validate_params(params, FlashT5Config(
            vocab_size=params["shared"]["embedding"].shape[0], d_model=d,
            num_layers=n + 1))


# FAT5 -> HF names (the direction of the reference's rename table), to
# make an HF-named file from a golden
_TO_HF = [
    (r"\.self_attention_layer\.self_attention\.pe_encoding\.",
     ".layer.0.SelfAttention."),
    (r"\.self_attention_layer\.self_attention\.W([qkv])\.",
     r".layer.0.SelfAttention.\1."),
    (r"\.self_attention_layer\.self_attention\.o\.", ".layer.0.SelfAttention.o."),
    (r"\.cross_attention_layer\.cross_attention\.W([qkv])\.",
     r".layer.1.EncDecAttention.\1."),
    (r"\.cross_attention_layer\.cross_attention\.o\.",
     ".layer.1.EncDecAttention.o."),
    (r"\.self_attention_layer\.layer_norm\.", ".layer.0.layer_norm."),
    (r"\.cross_attention_layer\.layer_norm\.", ".layer.1.layer_norm."),
    (r"\.ff_layer\.act\.", ".FF.DenseReluDense."),
    (r"\.ff_layer\.wo\.", ".FF.DenseReluDense.wo."),
    (r"\.ff_layer\.layer_norm\.", ".FF.layer_norm."),
]


def _to_hf(key):
    for pat, rep in _TO_HF:
        key = re.sub(pat, rep, key)
    return key.replace(".FF.", ".layer.2." if key.startswith("decoder")
                       else ".layer.1.")


def test_cli_hf_rename_and_checkpoint_export(tmp_path):
    from flasht5_tpu_torch.train import Trainer, TrainerConfig

    _, sd, _ = _golden(T5_GOLDENS[0])
    hf = {_to_hf(k): torch.from_numpy(np.ascontiguousarray(v))
          for k, v in sd.items()}
    assert "encoder.block.0.layer.1.DenseReluDense.wo.weight" in hf
    hf["encoder.embed_tokens.weight"] = hf["shared.weight"]
    src, dst = str(tmp_path / "hf.safetensors"), str(tmp_path / "out.st")
    st_save({k: v.clone() for k, v in hf.items()}, src)
    assert cli.main([src, dst]) == 0
    got = st_load(dst)
    assert sorted(got) == sorted(sd)
    for key, value in got.items():
        np.testing.assert_array_equal(value.numpy(), sd[key], err_msg=key)
    mine = _leaves(load_hf_t5_safetensors(src, device="cpu"))
    want = jax.tree_util.tree_leaves_with_path(
        jax_hf.load_hf_t5_safetensors(src))
    assert [p for p, _ in mine] == [jax.tree_util.keystr(p) for p, _ in want]
    for (p, a), (_, b) in zip(mine, want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=p)

    cfg = FlashT5Config(vocab_size=64, d_model=32, d_kv=8, num_heads=4,
                        d_ff=64, num_layers=1, dropout_rate=0.0,
                        pad_token_id=0)
    trainer = Trainer(cfg, TrainerConfig(output_dir=str(tmp_path / "run")),
                      device="cpu")
    step_dir = trainer.save_checkpoint(3)
    assert cli.main(["--from-checkpoint", step_dir, dst]) == 0
    back = load_fat5_safetensors(dst, device="cpu")
    for (p, a), (q, b) in zip(_leaves(trainer.params), _leaves(back)):
        assert p == q
        np.testing.assert_array_equal(a, b, err_msg=p)
