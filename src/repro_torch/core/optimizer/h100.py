"""The planner's entry for the card the port runs on: an NVIDIA H100.

A port-only module, with no counterpart in the JAX package.  The copied
catalogue (``profiles.DEVICES``) holds the paper's A10, L20 and V100,
an A100 and a TPU v5e, and ``SimEngine`` and ``ProfileTable`` find a
device only by its name in that dict.  ``register`` puts an ``h100``
``DeviceSpec`` there when it is called, never at import, so the
catalogue itself stays a copy of the reference's.

The peaks are the datasheet's, as ``launch/analytic.py`` holds them.
The achievable fractions are not the catalogue's defaults
(``mfu_prefill=0.55``, ``mbu_decode=0.70``): ``chip_smoke.py``'s ``sim``
phase fits them from the port's own full-width serves, by inverting
``PerfModel.prefill_time`` and ``decode_step_time``, so that
``PerfModel(cfg, h100_spec())`` reproduces the fitted point.  The port's
serving path is bound by the host (its steps launch thousands of small
kernels), so these fractions are far below what the card could reach.
"""
from __future__ import annotations

from repro_torch.core.optimizer.profiles import DEVICES, DeviceSpec
from repro_torch.launch import analytic

NAME = "h100"
HBM_BYTES = 80e9
# $/h of one card: Google Cloud's on-demand list price of an
# a3-highgpu-8g (8 x H100 80GB SXM) in us-central1, $88.25/h as listed
# in 2024, over 8.  The catalogue's A100 (3.70) is the same provider's
# a2-highgpu-1g.
COST_PER_HOUR = 88.25 / 8
# fitted by chip_smoke.py's sim phase (qwen3-0.6b, bf16, the serve
# phase's engine sizes with 160 pages a sequence, so that one 2048-token
# prompt fits), on an NVIDIA H100 80GB HBM3 at 700.00 W: a 4 x 512-token
# prefill batch took 1127.10 ms (MFU 0.00187), the median step of 8
# decoding rows at context 160 49.99 ms (MBU 0.00650).  The same phase
# on other hosts of the same card read 430.99 and 21.93 ms (0.00488,
# 0.01483) and 668.99 and 38.70 ms (0.00314, 0.00840): the port's steps
# are bound by the host, which moves the fit 2.6x, so only the first
# digit carries, and the defaults keep two.  The fit reads neither
# default: it inverts PerfModel with the model's own byte and
# parameter counts.
MFU_PREFILL = 0.0019
MBU_DECODE = 0.0065


def h100_spec(mfu_prefill: float = MFU_PREFILL,
              mbu_decode: float = MBU_DECODE) -> DeviceSpec:
    """An H100 ``DeviceSpec`` at the given achievable fractions."""
    return DeviceSpec(NAME, analytic.PEAK_FLOPS, analytic.HBM_BW,
                      HBM_BYTES, COST_PER_HOUR, mfu_prefill=mfu_prefill,
                      mbu_decode=mbu_decode)


def register(spec: DeviceSpec = None) -> DeviceSpec:
    """Put ``spec`` (default ``h100_spec()``) into ``profiles.DEVICES``
    under its name, replacing an earlier entry; returns it."""
    spec = h100_spec() if spec is None else spec
    DEVICES[spec.name] = spec
    return spec
