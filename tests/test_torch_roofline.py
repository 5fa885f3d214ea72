"""The port's roofline model (``repro_torch.launch.roofline``) against the
reference's on the CPU.

Every function gives the reference's value for every architecture the port
registers, full and reduced, at every shape cell that applies to it
(``repro.configs.applicable_shapes``) and at the port's own training and
serving shapes, on one device and on three meshes. The closed-form sums are
the reference's, so they agree to the last bit; only the four device
constants differ (an H100's in place of a TPU's), so the times agree once
each is scaled back by its constant.
"""
import dataclasses

import pytest

from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import applicable_shapes
from repro.configs import get_arch as jax_get_arch
from repro.launch import roofline as jrl
from repro_torch.configs import ParallelConfig, ShapeConfig, get_arch, list_archs
from repro_torch.launch import roofline as trl
from repro_torch.models import build_model
from repro_torch.models.registry import count_params

PORT_SHAPES = [("train", 1024, 4, "train"), ("train", 4096, 2, "train"),
               ("prefill", 512, 4, "prefill"), ("prefill", 4096, 4, "prefill"),
               ("decode", 528, 4, "decode")]
MESHES = [{"data": 1, "model": 1}, {"data": 8, "model": 1},
          {"data": 4, "model": 2}, {"pod": 2, "data": 2, "model": 2}]
PARALLEL = [dict(), dict(model=2), dict(model=2, fsdp=True)]
ARCHS = ["granite-34b", "llama3-8b", "qwen2.5-14b", "qwen2.5-3b",
         "recurrentgemma-2b"]


def test_constants_are_the_h100s():
    assert (trl.PEAK_FLOPS, trl.HBM_BW, trl.NVLINK_BW, trl.NET_BW) == (
        989e12, 3.35e12, 450e9, 50e9)
    assert (trl.BF16, trl.FP32) == (jrl.BF16, jrl.FP32)


def test_every_registered_arch_is_covered():
    assert list_archs() == sorted(ARCHS)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_matches_reference(arch, reduced):
    jcfg = jax_get_arch(arch, reduced=reduced)
    tcfg = get_arch(arch, reduced=reduced)
    n = count_params(build_model(tcfg).param_spec())
    shapes = [dataclasses.astuple(s) for s in applicable_shapes(jcfg)] + PORT_SHAPES
    assert len(shapes) >= len(PORT_SHAPES) + 3
    for fields in shapes:
        js, ts = JShapeConfig(*fields), ShapeConfig(*fields)
        for ctx in (None, fields[1] // 2):
            assert trl.analytic_fwd_flops(tcfg, 2, fields[1], ctx) == \
                jrl.analytic_fwd_flops(jcfg, 2, fields[1], ctx)
        assert trl.analytic_flops(tcfg, ts) == jrl.analytic_flops(jcfg, js)
        assert trl.active_params(tcfg, n) == jrl.active_params(jcfg, n)
        for act in (None, n // 3):
            assert trl.model_flops_6nd(tcfg, ts, n, act) == \
                jrl.model_flops_6nd(jcfg, js, n, act)
        assert trl.kv_cache_bytes(tcfg, ts) == jrl.kv_cache_bytes(jcfg, js)
        for kw in PARALLEL:
            tp, jp = ParallelConfig(**kw), JParallelConfig(**kw)
            for mesh in MESHES:
                chips = 1
                for v in mesh.values():
                    chips *= v
                assert trl.analytic_hbm_bytes(tcfg, ts, n, tp, chips) == \
                    jrl.analytic_hbm_bytes(jcfg, js, n, jp, chips)
                assert trl.analytic_collective_bytes(tcfg, ts, n, tp, mesh) == \
                    jrl.analytic_collective_bytes(jcfg, js, n, jp, mesh)
                t = trl.compute_roofline(tcfg, ts, n, tp, mesh, hlo_flops=7.0)
                j = jrl.compute_roofline(jcfg, js, n, jp, mesh, hlo_flops=7.0)
                for f in ("model_flops", "analytic_flops", "hlo_flops",
                          "useful_ratio"):
                    assert getattr(t, f) == getattr(j, f), f
                assert t.compute_s * trl.PEAK_FLOPS == \
                    pytest.approx(j.compute_s * jrl.PEAK_FLOPS, rel=1e-12)
                assert t.memory_s * trl.HBM_BW == \
                    pytest.approx(j.memory_s * jrl.HBM_BW, rel=1e-12)
                assert t.per_axis_s.keys() == j.per_axis_s.keys()
                for a in t.per_axis_s:
                    tb, jb = ((trl.NET_BW, jrl.DCN_BW) if a == "pod"
                              else (trl.NVLINK_BW, jrl.ICI_BW))
                    assert t.per_axis_s[a] * tb == \
                        pytest.approx(j.per_axis_s[a] * jb, rel=1e-12)
                assert t.collective_s == max(t.per_axis_s.values(), default=0.0)
                assert t.step_time_s == max(t.compute_s, t.memory_s,
                                            t.collective_s)
                assert t.roofline_fraction == pytest.approx(
                    t.compute_s / t.step_time_s * t.useful_ratio, rel=1e-12)
