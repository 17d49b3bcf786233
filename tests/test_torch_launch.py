"""The port's serving launcher against the JAX package's.

``repro_torch.launch.serve.main`` (with ``--torch-device cpu``) and
``repro.launch.serve.main`` run on the same arguments and the same
weights: the port's engines are built with the JAX engines' params for
their seed (the launcher module's ``InferenceEngine`` is swapped for a
factory that passes them in through ``bridge.params_from_numpy``), and
with ``--adapters`` they register the JAX runner's adapter weights for
each name.  Each request must be routed to the same engine and emit the
same tokens, for colocated pods (prefix-cache-aware routing), a 2P2D
group over the raw wire, four adapters under the LoRA controller
(lora-affinity routing), and speculation with the async loop.  The JAX
engines run their Pallas kernels in interpret mode.
"""
import re
import sys
import zlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.launch.serve as JL  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.engine import paged_model as JPM  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.engine import InferenceEngine  # noqa: E402
from repro_torch.launch import serve as L  # noqa: E402

torch.set_num_threads(1)

COMMON = ["--requests", "6", "--max-new", "6", "--prompt-len", "32"]
RUNS = {
    "mixed": ["--roles", "mixed"],
    "2P2D": ["--roles", "2P2D", "--wire-dtype", "fp"],
    "adapters": ["--adapters", "4"],
    "spec_async": ["--spec-tokens", "4", "--async-loop"],
}


class _Weights:
    """The JAX engines' params (and adapters) for a seed, as the port's."""

    def __init__(self):
        self.jcfg = jax_reduced("qwen3-0.6b")
        self.cfg = get_reduced_config("qwen3-0.6b")
        self._params = {}

    def params(self, seed):
        if seed not in self._params:
            tree = JM.init(self.jcfg, jax.random.PRNGKey(seed))
            self._params[seed] = bridge.params_from_numpy(
                jax.tree.map(np.asarray, tree), self.cfg, device="cpu")
        return self._params[seed]

    def adapter(self, seed, name, rank):
        # the JAX runner's artifact store: repro/engine/runner.py
        # (_adapter_key), keyed by the engine seed and the name
        key = jax.random.fold_in(jax.random.PRNGKey(seed + 2),
                                 zlib.crc32(name.encode()) & 0x7FFFFFFF)
        w = JPM.make_adapter(self.jcfg, rank, key)
        return bridge.adapter_from_numpy(
            {k: np.asarray(v) for k, v in w.items()}, self.cfg, rank,
            device="cpu")


@pytest.fixture(scope="module")
def weights():
    return _Weights()


def _port_engine_factory(w):
    class Engine(InferenceEngine):
        def register_adapter(self, name, weights=None):
            if weights is None:
                weights = w.adapter(self.runner._seed, name,
                                    self.ecfg.lora_rank)
            return super().register_adapter(name, weights)

    def make(cfg, ecfg, **kw):
        return Engine(cfg, ecfg, params=w.params(kw.get("seed", 0)), **kw)
    return make


def _run_port(monkeypatch, w, argv):
    monkeypatch.setattr(L, "InferenceEngine", _port_engine_factory(w))
    out = L.main(argv + ["--torch-device", "cpu"])
    return [(eid, list(r.output_tokens)) for eid, r in out.reqs], out


def _run_jax(monkeypatch, argv):
    made, routed = [], []
    request_cls = JL.Request

    def request(*a, **kw):
        r = request_cls(*a, **kw)
        made.append(r)
        return r

    class Gateway(JL.Gateway):
        def route(self, *a, **kw):
            eid = super().route(*a, **kw)
            routed.append(eid)
            return eid

    monkeypatch.setattr(JL, "Request", request)
    monkeypatch.setattr(JL, "Gateway", Gateway)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    JL.main()
    return [(eid, list(r.output_tokens)) for eid, r in zip(routed, made)]


@pytest.mark.parametrize("run", list(RUNS))
def test_launcher_matches_jax_launcher(monkeypatch, weights, run, capsys):
    argv = COMMON + RUNS[run]
    jax_out = _run_jax(monkeypatch, argv)
    jax_print = capsys.readouterr().out
    out, served = _run_port(monkeypatch, weights, argv)
    port_print = capsys.readouterr().out
    assert len(out) == 6 and all(len(t) == 6 for _, t in out)
    assert out == jax_out
    # both launchers print the same routing line and the same roles
    assert ([ln for ln in port_print.splitlines() if ln.startswith(
        "routing")] == [ln for ln in jax_print.splitlines()
                        if ln.startswith("routing")])
    for eng in served.engines.values():
        assert eng.alloc.num_free == eng.alloc.num_pages     # no leak
    if run == "mixed":
        assert len({eid for eid, _ in out}) == 2 or any(
            eng.metrics().prefix_hit_tokens for eng in
            served.engines.values())
    if run == "2P2D":
        assert served.pool is not None and served.pool.stats.puts > 0
        assert "pools:" in port_print
    if run == "adapters":
        assert "lora: affinity_hits=" in port_print
    if run == "spec_async":
        assert "overlap: device_wait=" in port_print
        assert any(e.metrics().spec_drafted_tokens
                   for e in served.engines.values())


def test_torch_quickstart_runs_on_cpu(capsys):
    """examples/torch_quickstart.py, the twin of examples/quickstart.py,
    on the CPU: ten requests through two port engines behind the gateway,
    the shared system prompt served from the prefix cache."""
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "torch_quickstart.py")
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    requests = mod.main(["--torch-device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("quickstart OK")
    assert len(requests) == 10
    assert all(len(r.output_tokens) == 12 for _, r in requests)
    assert re.search(r"engine-\d: finished=\d+ prefix_hit_tokens=[1-9]", out)
