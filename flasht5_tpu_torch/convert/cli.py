"""Checkpoint conversion CLI (the counterpart of `convert_checkpoint.py`).

    python -m flasht5_tpu_torch.convert.cli hf_model.safetensors out.safetensors

renames HF T5 keys to the FAT5 canonical naming (the reference's
convert_huggingface_t5.py).

    python -m flasht5_tpu_torch.convert.cli --from-checkpoint \\
        output_dir/step_<n> out.safetensors

exports a checkpoint of the port's trainer (`step_<n>/checkpoint.pt`,
where the JAX package's `--from-orbax` reads an Orbax directory) to FAT5
safetensors.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from flasht5_tpu_torch.convert import hf_import, safetensors_file
from flasht5_tpu_torch.train.trainer import CHECKPOINT_FILE


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--from-checkpoint", action="store_true",
                    help=f"src is a trainer checkpoint directory "
                         f"(step_<n>/{CHECKPOINT_FILE})")
    args = ap.parse_args(argv)
    if args.from_checkpoint:
        ckpt = torch.load(os.path.join(args.src, CHECKPOINT_FILE),
                          map_location="cpu", weights_only=True)
        state = hf_import.params_to_fat5_state_dict(ckpt["params"])
    else:
        state = hf_import.hf_state_to_fat5(
            safetensors_file.load_file(args.src))
    safetensors_file.save_file(state, args.dst)
    print(f"wrote {len(state)} tensors to {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
