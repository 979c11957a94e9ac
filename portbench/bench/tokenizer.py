"""A tokenizer with the surface the UL2 collator reads, for seeded ids.

The shape of FAT5's French tokenizer (not in the repository): `vocab` ids,
pad 0, eos 1, the task prefixes [R], [S] and [X] as ids 2-4, and 100
sentinels at the top ids (<extra_id_0> = vocab - 1, descending)."""

from __future__ import annotations


class StubTokenizer:
    pad_token_id, eos_token_id = 0, 1
    _prefix = {"[R]": 2, "[S]": 3, "[X]": 4}

    def __init__(self, vocab: int):
        self.vocab = vocab
        self.all_special_tokens = ([f"<extra_id_{i}>" for i in range(100)]
                                   + ["<pad>", "</s>"])
        self.all_special_ids = [vocab - 1 - i for i in range(100)] + [0, 1]

    def __len__(self):
        return self.vocab

    def encode(self, text):
        return [self._prefix[text], self.eos_token_id]
