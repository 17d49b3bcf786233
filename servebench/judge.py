"""How ``correct`` is decided for a served model.

Once the window has closed, a sample of the requests the engine
finished, drawn from the seed with the longest of them always in it, is
run through the plain reference once each (prompt plus served tokens).
At every served position the reference's logit of the token the program
served is compared with the reference's best logit there; the widest
gap over the sample is the number compared (``logit_gap_max``).  A
greedy program that served the reference's argmax reads 0; rounding
moves the choice only between near ties, so a sound run reads little,
and a wrong token (a broken kernel, a page read from the wrong place, a
step that drops rows) reads as far below the best as a random token
lies.  The limit is in ``servebench/checks/<workload>.json``; PERF.md
gives the readings it was set from.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch


@dataclass
class Finished:
    """A request the program finished: its prompt and served tokens."""
    prompt: List[int]
    served: List[int]

    @property
    def length(self) -> int:
        return len(self.prompt) + len(self.served)


def pick(finished: Sequence[Finished], seed: int,
         tokens: int) -> List[int]:
    """Indices of the sample: the longest finished request, then others
    in an order drawn from ``seed`` until ``tokens`` served tokens are
    in it."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: finished[i].length)
    rng = np.random.default_rng((seed + 1) % (1 << 63))
    out, n = [longest], len(finished[longest].served)
    for i in rng.permutation(len(finished)).tolist():
        if n >= tokens:
            break
        if i != longest:
            out.append(i)
            n += len(finished[i].served)
    return out


def gaps(ref_logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """Per position: the reference's best logit minus its logit of the
    token chosen there."""
    idx = torch.as_tensor(list(tokens), device=ref_logits.device)
    chosen = ref_logits.gather(1, idx[:, None])[:, 0]
    return ref_logits.max(dim=1).values - chosen


def served_gaps(reference, req: Finished) -> torch.Tensor:
    """The gaps of one request's served tokens under ``reference``."""
    seq = req.prompt + req.served[:-1]
    logits = reference.logits(seq, len(req.prompt) - 1)
    return gaps(logits, req.served)


def control_gaps(reference, control, req: Finished) -> torch.Tensor:
    """The gaps, under ``reference``, of the tokens ``control`` puts
    first at the same positions of the same sequence."""
    seq = req.prompt + req.served[:-1]
    first = len(req.prompt) - 1
    ref = reference.logits(seq, first)
    return gaps(ref, control.logits(seq, first).argmax(dim=1).tolist())
