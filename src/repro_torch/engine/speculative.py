"""Prompt-lookup (n-gram) speculative drafting for the fused step.

Decode is bandwidth-bound on the roofline: every step streams the full
weights + per-sequence KV to emit ONE token per row.  Speculative
decoding does more work per HBM pass — a *drafter* proposes up to
``spec_tokens`` continuation tokens per decode row, the model verifies
all of them in one forward pass (the drafts ride the existing
``paged_prefill`` dynamic-context-offset path as a short multi-query
chunk of the decode row), and the longest draft prefix matching the
model's own sampled tokens is accepted.  Each verified step emits
``accepted + 1`` tokens (the bonus token is the model's sample at the
first divergence), so acceptance rate directly multiplies decode
throughput while staying *byte-identical* to the non-speculative run:
every emitted token is the model's own sample at its position.

The drafter here is prompt-lookup decoding (no draft model): match the
row's trailing n-gram against its own prompt + generated history and
propose the continuation of the most recent earlier occurrence.  Free
to compute, and very effective on repetitive workloads
(summarization, code edits, multi-turn chat with quoting).

:class:`DraftController` adds the adaptive backoff the scheduler
consults: a per-request acceptance EWMA shrinks the allowed draft
length (full -> 1 -> 0) when drafts keep missing, with a periodic
1-token probe so a request whose output turns repetitive later can
re-enable drafting.  Low-acceptance workloads therefore degrade to
plain decode steps (plus a rare probe) instead of paying verification
compute for nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.engine.request import Request


def ngram_propose(history: Sequence[int], max_draft: int,
                  ngram_max: int = 3, ngram_min: int = 1) -> List[int]:
    """Prompt-lookup draft: find the most recent earlier occurrence of
    the history's trailing n-gram (longest n first) and propose its
    continuation, up to ``max_draft`` tokens.

    Returns ``[]`` when no earlier occurrence with a continuation
    exists — the scheduler then runs a plain decode row.
    """
    n_hist = len(history)
    if max_draft <= 0 or n_hist < ngram_min + 1:
        return []
    for n in range(min(ngram_max, n_hist - 1), ngram_min - 1, -1):
        tail = list(history[-n:])
        # most recent earlier occurrence first (locality: recent
        # repetition predicts the continuation better than distant)
        for i in range(n_hist - n - 1, -1, -1):
            if list(history[i:i + n]) == tail:
                cont = list(history[i + n:i + n + max_draft])
                if cont:
                    return cont
    return []


@dataclass
class DraftController:
    """Adaptive per-request draft-length policy.

    Tracks an acceptance EWMA per request (stored on the request so it
    travels with migrations/handoffs) and maps it to an allowed draft
    length: ``max_draft`` while acceptance stays high, 1 in the
    marginal band, 0 when drafting keeps missing — with a 1-token probe
    every ``probe_interval`` scheduler passes so drafting can recover
    when the output turns repetitive again.  New requests start
    optimistic (EWMA 1.0): the first misses pay one short burst of
    wasted verify lanes, then the controller backs off.
    """
    max_draft: int
    ngram_max: int = 3
    ngram_min: int = 1
    ewma_alpha: float = 0.4         # update weight of the newest step
    full_threshold: float = 0.35    # EWMA >= this -> full-length drafts
    min_threshold: float = 0.15     # EWMA >= this -> 1-token drafts
    probe_interval: int = 50        # passes between probes when disabled

    def allowed(self, req: Request) -> int:
        ewma = getattr(req, "_spec_ewma", 1.0)
        if ewma >= self.full_threshold:
            return self.max_draft
        if ewma >= self.min_threshold:
            return 1
        cool = getattr(req, "_spec_cool", 0)
        if cool <= 0:
            req._spec_cool = self.probe_interval  # type: ignore
            return 1                # periodic probe re-tests acceptance
        req._spec_cool = cool - 1                 # type: ignore
        return 0

    def propose(self, req: Request, budget: int) -> List[int]:
        """The scheduler entry point: draft for one decode row, bounded
        by the adaptive allowance, the leftover token ``budget`` (drafts
        spend budget LAST, after decode rows and prefill chunks) and
        the tokens the request can still emit (a draft must never push
        KV writes past the pages ``max_new_tokens`` reserved)."""
        room = req.sampling.max_new_tokens - len(req.output_tokens) - 1
        d = min(self.allowed(req), budget, room)
        if d <= 0:
            return []
        history = list(req.prompt_tokens) + list(req.output_tokens)
        return ngram_propose(history, d, self.ngram_max, self.ngram_min)

    def observe(self, req: Request, drafted: int, accepted: int) -> None:
        if drafted <= 0:
            return
        ewma = getattr(req, "_spec_ewma", 1.0)
        a = self.ewma_alpha
        req._spec_ewma = (1 - a) * ewma + a * (accepted / drafted)  # type: ignore


@dataclass
class FixedLengthDrafter(DraftController):
    """Content-free drafter for the simulator: proposes the full
    allowed draft length regardless of history.  Sim token streams are
    synthetic zeros, which the n-gram matcher degenerates on (trailing
    overlap caps proposals at one token), so the sim swaps this in —
    the budget-last spending, EWMA backoff and accounting paths stay
    exactly the real engine's while ``spec_accept_rate`` shapes the
    synthetic acceptance."""

    def propose(self, req: Request, budget: int) -> List[int]:
        room = req.sampling.max_new_tokens - len(req.output_tokens) - 1
        d = min(self.allowed(req), budget, room)
        return [0] * d if d > 0 else []


def accept_length(drafts: Sequence[int], sampled: Sequence[int]) -> int:
    """Longest draft prefix the model's own samples confirm.  Row j of
    ``sampled`` is the model's token after consuming draft tokens
    ``drafts[:j]`` — a draft survives while it equals the sample at its
    position.  The emitted tokens are ``sampled[:m + 1]``: the ``m``
    confirmed drafts plus the bonus/correction sample at the first
    divergence (or past the last draft)."""
    m = 0
    while m < len(drafts) and m < len(sampled) - 1 \
            and int(sampled[m]) == int(drafts[m]):
        m += 1
    return m
