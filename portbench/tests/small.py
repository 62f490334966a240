"""A cell of the benchmark at a size the CPU runs in seconds: the cell's
files as they are, the configuration cut to SMOKE widths."""
from __future__ import annotations

import copy

from portbench import harness

SMALL = {"hidden_size": 32, "intermediate_size": 32,
         "num_attention_heads": 4, "num_key_value_heads": 4,
         "num_hidden_layers": 2, "vocab_size": 128, "frontend_tokens": 4}
SMALL_PROGRAM = {"q_chunk": None, "seq_chunk": 8}
SMALL_TRAFFIC = {"finetune.b1.ids128": {"ids": 8},
                 "closed1.ids64-128-256.new8": {"prompt_ids": [4, 8, 12]}}


def small_cell(workload: str) -> dict:
    c = copy.deepcopy(harness.cell(workload))
    c["config"].update(SMALL)
    c["config"]["program"].update(SMALL_PROGRAM)
    c["traffic"].update(SMALL_TRAFFIC[c["workload"]["traffic"]])
    return c
