"""The system under test as the harness drives it: the port's paged engine.

This is the one module of the benchmark that imports the program
(``repro_torch``).  It maps a configuration file onto the port's
``ModelConfig`` and ``EngineConfig``, builds an ``InferenceEngine`` on
the benchmark's weights, makes requests, warms up the cell's step
shapes, and tells finished and failed requests apart.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.engine import (EngineConfig, InferenceEngine, Request,
                                RequestState, SamplingParams)
from repro_torch.models.config import (MLAConfig, ModelConfig, MoEConfig,
                                       SSMConfig, XLSTMConfig)

from servebench.families import family

# the port's sub-configurations, by the ``ModelConfig`` field that holds each
SUB_CONFIGS = {"moe": MoEConfig, "mla": MLAConfig, "ssm": SSMConfig,
               "xlstm": XLSTMConfig}


def _dataclass(kind, kw: dict, where: str):
    """``kind(**kw)``, with a ``ValueError`` naming any key ``kind``
    lacks."""
    fields = {f.name for f in dataclasses.fields(kind)}
    unknown = sorted(set(kw) - fields)
    if unknown:
        raise ValueError(f"{where}: the port's {kind.__name__} has no "
                         f"{', '.join(map(repr, unknown))}")
    return kind(**kw)


def model_config(cfg: dict) -> ModelConfig:
    """The port's configuration of a configuration file's model, as its
    family maps it.  The family hands plain data: a nested dict under
    ``moe``, ``mla``, ``ssm`` or ``xlstm`` becomes that sub-configuration
    and a ``layer_pattern`` list a tuple; any other nested dict, or a key
    that the port's dataclass lacks, raises a ``ValueError`` naming it."""
    kw = dict(family(cfg).port_config(cfg))
    where = f"{cfg['name']} ({cfg['family']})"
    for key, value in kw.items():
        if not isinstance(value, dict):
            continue
        if key not in SUB_CONFIGS:
            raise ValueError(f"{where}: {key!r} is not a sub-configuration "
                             f"of the port ({', '.join(SUB_CONFIGS)})")
        nested = sorted(k for k, v in value.items() if isinstance(v, dict))
        if nested:
            raise ValueError(f"{where}: {key}.{nested[0]} is a nested dict")
        kw[key] = _dataclass(SUB_CONFIGS[key], value, f"{where} {key}")
    if isinstance(kw.get("layer_pattern"), list):
        kw["layer_pattern"] = tuple(kw["layer_pattern"])
    return _dataclass(ModelConfig, kw, where)


def engine_config(cfg: dict) -> EngineConfig:
    """The engine settings the configuration file states."""
    e = cfg["engine"]
    return EngineConfig(
        dtype=e["dtype"], impl="kernel", page_size=e["page_size"],
        num_pages=e["num_pages"], max_batch=e["max_batch"],
        max_pages_per_seq=e["max_pages_per_seq"],
        chunk_size=e["chunk_size"], max_prefills=e["max_prefills"],
        prefix_caching=e["prefix_caching"],
        chunked_prefill=e["chunked_prefill"],
        mixed_batching=e["mixed_batching"])


def build(cfg: dict, params, device) -> InferenceEngine:
    return InferenceEngine(model_config(cfg), engine_config(cfg),
                           params=params, device=device)


def request(tokens: List[int], max_new_tokens: int) -> Request:
    """A greedy request served exactly ``max_new_tokens`` tokens (no stop
    token)."""
    return Request(prompt_tokens=tokens, sampling=SamplingParams(
        temperature=0.0, max_new_tokens=max_new_tokens))


def warm_up(engine: InferenceEngine, cfg: dict) -> None:
    """Run the cell's step shapes once: a full mixed step (every prefill
    slot on a whole chunk, then decode rows beside chunks), decode
    steps, and a lone prefill, all at the engine's padded widths."""
    e = cfg["engine"]
    vocab = cfg["vocab_size"]
    n = e["max_prefills"]
    length = 2 * e["chunk_size"]
    for i in range(n):
        engine.submit(request([(7 * i + j) % vocab for j in range(length)],
                              3))
    engine.run_until_idle()
    engine.submit(request([j % vocab for j in range(e["chunk_size"])], 2))
    engine.run_until_idle()


def is_finished(req: Request) -> bool:
    return req.state is RequestState.FINISHED


def is_failed(req: Request) -> bool:
    return req.state is RequestState.FAILED
