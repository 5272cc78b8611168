"""The port's source waveforms (models/sources.py) against the JAX
package's per-lane evaluation (``eval_sources_lanes``) on random time
arrays and random source parameters made with numpy, rtol 1e-12 (both f64;
libm's sin and torch's may differ in the last bit)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyspice_tpu.compiler import SRC_DC, SRC_PULSE, SRC_PWL, SRC_SIN
from toyspice_tpu.models.sources import eval_sources_lanes

from toyspice_tpu_torch.models import sources

B = 512
KEYS = ("dc", "amplitude", "freq", "phase", "v1", "v2", "delay", "rise",
        "fall", "width", "period")


def _params(rng, stype, batched, P=5):
    ns = len(stype)
    shape = (B, ns) if batched else (ns,)
    p = {
        "dc": rng.normal(0, 2, shape),
        "amplitude": rng.uniform(0.5, 5, shape),
        "freq": rng.uniform(100, 5e3, shape),
        "phase": rng.uniform(-180, 180, shape),
        "v1": rng.normal(0, 1, shape),
        "v2": rng.normal(3, 1, shape),
        "delay": rng.uniform(0, 2e-4, shape),
        "rise": rng.uniform(1e-6, 5e-5, shape),
        "fall": rng.uniform(1e-6, 5e-5, shape),
        "width": rng.uniform(1e-5, 2e-4, shape),
        "period": rng.uniform(3e-4, 6e-4, shape),
    }
    # knots: increasing times, the last one padded far in the future
    kshape = (B, ns, P) if batched else (ns, P)
    kt = np.cumsum(rng.uniform(1e-5, 3e-4, kshape), axis=-1)
    kt[..., -1] = kt[..., -2] + 1e30
    kv = rng.normal(0, 2, kshape)
    kv[..., -1] = kv[..., -2]
    p["pwl_t"], p["pwl_v"] = kt, kv
    return p


def _compare(stype, p, t):
    ref = np.asarray(eval_sources_lanes(
        np.asarray(stype, np.int32), {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(t), B))  # (nS, B)
    got = sources.eval_sources(
        np.asarray(stype, np.int32),
        {k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(t))
    assert got.shape == (B, len(stype)) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref.T, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
@pytest.mark.parametrize("stype", [
    [SRC_DC], [SRC_SIN], [SRC_PULSE], [SRC_PWL],
    [SRC_SIN, SRC_DC, SRC_PULSE, SRC_PWL, SRC_SIN]],
    ids=["dc", "sin", "pulse", "pwl", "mixed"])
def test_sources_match_jax(stype, batched):
    rng = np.random.default_rng(7)
    p = _params(rng, stype, batched)
    t = rng.uniform(0.0, 2e-3, B)
    t[:8] = 0.0  # the first attempt's time
    _compare(stype, p, t)


def test_pulse_edges_match_jax():
    """Zero rise/fall, no period (no wrap), times on the edges, and times
    before the delay."""
    rng = np.random.default_rng(3)
    stype = [SRC_PULSE] * 4
    p = _params(rng, stype, batched=False)
    p["rise"][0] = 0.0
    p["fall"][1] = 0.0
    p["period"][2] = 0.0
    p["period"][3] = -1e-4
    t = rng.uniform(-1e-4, 2e-3, B)
    t[:4] = p["delay"][0]
    t[4:8] = p["delay"][0] + p["rise"][0] + p["width"][0]
    _compare(stype, p, t)


def test_floor_mod_matches_python():
    rng = np.random.default_rng(5)
    a = rng.uniform(-1e-3, 1e-3, 1000)
    b = rng.uniform(1e-5, 1e-4, 1000)
    got = sources.floor_mod(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.mod(a, b)))
