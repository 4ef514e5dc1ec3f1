"""Tiny versions of the cells for the CPU tests: the configurations'
shapes cut to a CPU's size and the mixes' lengths shortened, with the
cells' own limits."""

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from chipbench.harness import manifest  # noqa: E402


def tiny_config(c: dict) -> dict:
    c = copy.deepcopy(c)
    c.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, intermediate_size=128, vocab_size=512)
    if c.get("num_local_experts"):
        c.update(num_local_experts=8, num_experts_per_tok=2, intermediate_size=32)
    return c


def tiny_cell(name: str) -> manifest.Cell:
    cell = manifest.cell(manifest.load(ROOT), name, ROOT)
    cell.config = tiny_config(cell.config)
    if cell.traffic["kind"] == "train":
        cell.traffic.update(batch=4, seq=32, setup_steps=4, profiled_steps=1)
    else:
        # at least 12 window requests, however loaded the CPU: at the spans
        # test's seed the 10th is the first whose hit differs from the others'
        cell.traffic.update(pool_blocks=256, prompt_tokens=64, suffix_tokens=16, n_prompts=8,
                            filled_requests=24, warmup_requests=1, sampled_requests=8,
                            profiled_requests=1, profiled_decode_steps=2, min_window_requests=12)
    return cell
