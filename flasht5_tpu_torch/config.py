"""Model configuration for the PyTorch port.

The same configuration surface as `flasht5_tpu.config.FlashT5Config` (field
names, defaults, reference-name aliases, YAML layout), kept as a copy so that
this package never imports the JAX package. Fields that only the JAX side
acts on (`scan_blocks`, `tp_axis`, ...) are kept so that one YAML
file configures both packages; the port raises where it meets one it does
not implement yet.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import yaml

# Canonical attention backends; the reference's names are accepted as aliases.
#   "ref"               -> plain PyTorch attention (ops/attn_ref.py)
#   "triton"/"fa2_bias" -> "pallas"      (the bias materialized and read by
#                                         the Hopper bias kernels)
#   "fa2_rpe"           -> "pallas_rpe"  (bias from the bucket table inside
#                                         the Hopper kernel, linear memory)
_ATTENTION_ALIASES = {
    "ref": "ref",
    "triton": "pallas",
    "fa2_bias": "pallas",
    "fa2_rpe": "pallas_rpe",
    "pallas": "pallas",
    "pallas_rpe": "pallas_rpe",
}

POSITION_ENCODING_TYPES = ("t5", "ALiBi", "RoPE", "FIRE")


@dataclasses.dataclass(frozen=True)
class FlashT5Config:
    """Static model configuration (field semantics as in the JAX package)."""

    # --- T5 architecture ---
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 8
    num_decoder_layers: Optional[int] = None
    num_heads: int = 6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    initializer_factor: float = 1.0
    feed_forward_proj: str = "gated-gelu"  # informational; use_glu_mlp governs
    tie_word_embeddings: bool = False
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    pad_token_id: int = -100

    # --- flashT5 extensions ---
    use_glu_mlp: bool = True
    position_encoding_type: str = "t5"
    use_randomized_position_encoding: bool = False
    label_smoothing: float = 0.0
    z_loss: Optional[float] = None
    attention_type: str = "ref"
    max_sequence_length: int = 1024
    attention_dropout_rate: float = 0.0
    alibi_mode: str = "symetric"
    use_fused_layernorm: bool = False
    use_fused_crossentropy: bool = False
    use_fused_lm_head_ce: bool = False
    crossentropy_inplace_backward: bool = False
    use_gelu_act: bool = True
    use_full_bias_size: bool = False
    rotary_emb_fraction: float = 1.0
    rotary_base: float = 10000.0
    rotary_interleaved: bool = False
    rotary_scale_base: Optional[float] = None
    fire_mlp_width: int = 32
    use_masking: bool = False
    attention_scale: Optional[float] = None
    rope_rotate_v: bool = True

    # --- execution ---
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"     # parameter storage dtype
    remat: bool = False
    decode_block_size: int = 128
    scan_blocks: bool = True
    tp_axis: Optional[str] = None
    use_collective_matmul: bool = False

    def __post_init__(self):
        object.__setattr__(
            self, "attention_type",
            _ATTENTION_ALIASES.get(self.attention_type, self.attention_type),
        )
        if self.attention_type not in ("ref", "pallas", "pallas_rpe"):
            raise ValueError(f"unknown attention_type {self.attention_type!r}")
        if self.position_encoding_type not in POSITION_ENCODING_TYPES:
            raise ValueError(
                f"unknown position_encoding_type {self.position_encoding_type!r}")
        if self.attention_type == "pallas_rpe" and self.position_encoding_type != "t5":
            raise ValueError("pallas_rpe requires T5 relative position encoding")
        if self.use_masking and not self.use_full_bias_size:
            raise ValueError("use_masking requires use_full_bias_size")
        if self.num_decoder_layers is None:
            object.__setattr__(self, "num_decoder_layers", self.num_layers)

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    @property
    def softmax_scale(self) -> float:
        # Reference quirk (modeling_flash_t5.py:183): the default scale is
        # 1/sqrt(n_heads), NOT 1/sqrt(d_kv); configs usually set
        # attention_scale=1.0 for T5's unscaled dot product.
        if self.attention_scale is not None:
            return float(self.attention_scale)
        return 1.0 / (self.num_heads ** 0.5)

    @classmethod
    def from_dict(cls, d: dict) -> "FlashT5Config":
        d = dict(d)
        renames = {
            "use_triton_layernorm": "use_fused_layernorm",
            "use_triton_crossentropy": "use_fused_crossentropy",
        }
        for old, new in renames.items():
            if old in d:
                d[new] = d.pop(old)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, text: str) -> "FlashT5Config":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_yaml(cls, path: str) -> "FlashT5Config":
        with open(path) as f:
            cfg = yaml.safe_load(f)
        return cls.from_dict(cfg.get("model_args", cfg))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def replace(self, **kw) -> "FlashT5Config":
        return dataclasses.replace(self, **kw)


def flagship_config() -> FlashT5Config:
    """FAT5-small (reference configs/fr/fat5-fr-small.yaml:10-33) with the
    kernel path on: 12+12 layers, d_model 512, d_ff 2048, 8 heads of 64,
    GLU-GELU, T5 relative bias, vocab 32768, untied lm_head, z_loss 1e-4."""
    return FlashT5Config(
        vocab_size=32768, d_model=512, d_kv=64, num_heads=8, d_ff=2048,
        num_layers=12, num_decoder_layers=12, dropout_rate=0.0,
        use_glu_mlp=True, use_gelu_act=True, attention_scale=1.0,
        position_encoding_type="t5", attention_type="pallas_rpe",
        use_fused_layernorm=True, use_fused_crossentropy=True,
        use_fused_lm_head_ce=False, z_loss=1e-4, label_smoothing=0.0,
        pad_token_id=0)


def load_run_config(path: str) -> dict:
    """A run's YAML in the reference's three-section layout: {"model_args",
    "training_args", "collator_args"}, a missing section as {} (the JAX
    package's `load_run_config`; reference train_flash_t5.py:32-65)."""
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    return {key: cfg.get(key, {}) for key in
            ("model_args", "training_args", "collator_args")}
