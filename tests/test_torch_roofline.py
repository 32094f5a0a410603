"""The port's `roofline/analysis.py` closed forms against the reference's
`src/repro/roofline/analysis.py`: equal exactly (ints and floats), at
every one of the ten configs, FULL and SMOKE, and over a grid of
capacities and mesh axes for the sharded step's collective costs and
slack. The hardware constants differ by design (the port's are the H100
SXM's), so only the closed forms and the bands are compared."""
import itertools

import pytest

import repro.configs as jconfigs
from repro.roofline import analysis as janalysis
from repro_torch import configs
from repro_torch.configs import ARCHS
from repro_torch.roofline import analysis

CASES = [(a, s) for a in ARCHS for s in (False, True)]
MESH_AXES = [{"data": 1, "model": 1}, {"data": 8, "model": 1},
             {"data": 2, "model": 4}, {"data": 4, "model": 2},
             {"pod": 2, "data": 2, "model": 2},
             {"pod": 2, "data": 1, "model": 4}, {"data": 1, "model": 16}]
CAPACITIES = [1, 6, 8, 16, 64]


def _pair(arch, smoke):
    return (configs.get(arch, smoke=smoke),
            jconfigs.get(arch, smoke=smoke))


def _same(a, b):
    assert type(a) is type(b) and a == b, (a, b)


@pytest.mark.parametrize("arch, smoke", CASES)
def test_param_and_flop_counts_equal_the_reference(arch, smoke):
    cfg, jcfg = _pair(arch, smoke)
    _same(analysis.active_param_count(cfg),
          janalysis.active_param_count(jcfg))
    for tokens, training in itertools.product((1, 4096), (False, True)):
        _same(analysis.model_flops(cfg, tokens=tokens, training=training),
              janalysis.model_flops(jcfg, tokens=tokens, training=training))


@pytest.mark.parametrize("arch, smoke", CASES)
def test_serving_costs_equal_the_reference(arch, smoke):
    """`top_matmul_params` and `serving_step_costs` for the dense configs
    (the reference documents them dense-only); the decode and encode
    costs at the config's width for every config."""
    cfg, jcfg = _pair(arch, smoke)
    d = cfg.d_model
    for rows, nb in itertools.product((1, 4, 1024), (2, 4)):
        _same(analysis.serving_decode_costs(rows, d, dtype_bytes=nb),
              janalysis.serving_decode_costs(rows, d, dtype_bytes=nb))
        _same(analysis.serving_encode_costs(rows, d, dtype_bytes=nb),
              janalysis.serving_encode_costs(rows, d, dtype_bytes=nb))
    if cfg.family != "dense":
        return
    for cut in {1, cfg.n_layers // 2, cfg.n_layers - 1}:
        _same(analysis.top_matmul_params(cfg, cut),
              janalysis.top_matmul_params(jcfg, cut))
        for cap, max_len in ((4, 12), (64, 2048)):
            _same(analysis.serving_step_costs(cfg, cut, cap, max_len, 12345),
                  janalysis.serving_step_costs(jcfg, cut, cap, max_len,
                                               12345))


@pytest.mark.parametrize("arch, smoke", CASES)
def test_collective_costs_and_slack_equal_the_reference(arch, smoke):
    cfg, jcfg = _pair(arch, smoke)
    for axes, cap, nb in itertools.product(MESH_AXES, CAPACITIES, (2, 4)):
        n = 1
        for s in axes.values():
            n *= s
        cap = -(-cap // n) * n                     # the arena's padding
        _same(analysis.serving_collective_costs(cfg, cap, axes,
                                                dtype_bytes=nb),
              janalysis.serving_collective_costs(jcfg, cap, axes,
                                                 dtype_bytes=nb))
        _same(analysis.serving_collective_slack(cfg, cap, axes,
                                                dtype_bytes=nb),
              janalysis.serving_collective_slack(jcfg, cap, axes,
                                                 dtype_bytes=nb))


def test_bands_and_ring_factors_equal_the_reference():
    for name in ("DECODE_BYTES_BAND", "FUSED_BYTES_BAND",
                 "FUSED_FLOPS_RTOL", "ENCODE_BYTES_BAND"):
        _same(getattr(analysis, name), getattr(janalysis, name))
    from repro.roofline import hlo
    assert analysis.RING_FACTOR == hlo.RING_FACTOR


def test_roofline_terms_use_the_h100_constants():
    r = analysis.Roofline(arch="yi-6b", shape="decode", mesh="1", chips=1,
                          hlo_flops=989e12, hlo_bytes=3.35e12 * 2,
                          coll_bytes=0.0, coll_detail={})
    assert r.t_compute == 1.0 and r.t_memory == 2.0
    assert r.bottleneck == "memory" and r.row()["t_collective_s"] == 0.0
