"""The yardstick's arithmetic: peaks, and the operations and bytes of a step.

Peaks are the published ones of one NVIDIA H100 SXM (dense bf16 on the
tensor cores, HBM3), against which every share is stated.  Counts come
from shapes alone:

- ``StepRecord``: one executed schedule as the harness saw it: its
  mode, the context length of each decode row (keys it attends over,
  its own included), each prefill chunk's ``(start, length,
  prompt_len)``, and the rows the runner padded it to.
- ``forward_flops``: the forward operations of a step's real tokens:
  every real token through the layers outside attention, attention over
  each token's live context (both as the configuration's family counts
  them, ``servebench/families/``, the attention from the step's decode
  rows and chunks), and the head of each row that emits a token.
- ``paged_attention_cost`` and ``paged_prefill_cost``: operations and
  bytes of one launch of each kernel (one layer), counting each input
  byte read once and each output byte written once: live keys and
  values, the active rows' queries and outputs, the live block-table
  entries and the lengths.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from servebench.families import family

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
PEAK_BYTES_PER_S = 3.35e12   # HBM3


@dataclass
class StepRecord:
    mode: str                         # mixed | decode | prefill | idle
    dec_lens: List[int] = field(default_factory=list)
    chunks: List[Tuple[int, int, int]] = field(default_factory=list)
    padded_rows: int = 0
    t0: float = 0.0        # engine clock around the step
    t1: float = 0.0
    wall0: float = 0.0     # wall clock, the device trace's
    wall1: float = 0.0

    @property
    def real_tokens(self) -> int:
        return len(self.dec_lens) + sum(c for _, c, _ in self.chunks)

    @property
    def emitting_rows(self) -> int:
        """Decode rows, and chunks that finish their prompt."""
        return len(self.dec_lens) + sum(
            1 for s, c, p in self.chunks if c > 0 and s + c == p)


def chunk_pairs(start: int, length: int) -> int:
    """Live (query, key) pairs of a chunk of ``length`` rows after
    ``start`` cached tokens, causal."""
    return length * start + length * (length + 1) // 2


def forward_flops(cfg: dict, step: StepRecord) -> int:
    """Forward operations of the real tokens of one step."""
    fam = family(cfg)
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    return (step.real_tokens * fam.token_flops(cfg)
            + fam.attention_flops(cfg, step) + step.emitting_rows * head)


def _table_bytes(tokens: int, page: int) -> int:
    return 4 * (-(-tokens // page))


def paged_attention_cost(cfg: dict, dec_lens: List[int], page: int,
                         esize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one ``paged_attention`` launch over decode
    rows of these context lengths."""
    h, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    live = sum(dec_lens)
    ops = 4 * live * h * hd
    nbytes = (2 * live * hkv * hd * esize            # K and V
              + 2 * len(dec_lens) * h * hd * esize   # q in, out
              + sum(_table_bytes(n, page) for n in dec_lens)
              + 4 * len(dec_lens))                   # lengths
    return ops, nbytes


def paged_prefill_cost(cfg: dict, chunks: List[Tuple[int, int, int]],
                       page: int, esize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one ``paged_prefill`` launch over chunks
    ``(start, length, prompt_len)``."""
    h, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    live = [(s, c) for s, c, _ in chunks if c > 0]
    ops = 4 * h * hd * sum(chunk_pairs(s, c) for s, c in live)
    nbytes = (sum(2 * (s + c) * hkv * hd * esize      # K and V
                  + 2 * c * h * hd * esize            # q in, out
                  + _table_bytes(s + c, page) + 8     # table, lengths
                  for s, c in live))
    return ops, nbytes


def bound_s(ops: int, nbytes: int) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the bandwidth."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)
