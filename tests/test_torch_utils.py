"""Port parity of ``gmpi_tpu_torch.utils`` against ``gmpi_tpu.utils``:
the toy-MPI builders bitwise, the roofline model exactly, and the registry,
colour, range and inspection helpers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmpi_tpu.utils import img as jax_img
from gmpi_tpu.utils import inspect as jax_inspect
from gmpi_tpu.utils import roofline as jax_roofline
from gmpi_tpu.utils import toy_mpi as jax_toy
from gmpi_tpu_torch.utils import img, inspect, roofline, toy_mpi
from gmpi_tpu_torch.utils.registry import Registry, register_model, registry


def _content(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (7, 9, 4), dtype=np.uint8)


BUILDERS = {
    "blank_mpi": lambda m: m.blank_mpi(4, 16, background_rgb=(0.2, 0.4, 0.6)),
    "add_rect": lambda m: m.add_rect(m.blank_mpi(3, 20), 1, (1, 0.5, 0), center=(0.4, 0.6),
                                     size=(0.3, 0.2), alpha=0.7),
    "add_disk": lambda m: m.add_disk(m.blank_mpi(3, 20), 0, (0, 1, 0), center=(0.5, 0.45),
                                     radius=0.2),
    "checkerboard_mpi": lambda m: m.checkerboard_mpi(5, 24, cells=4),
    "layered_scene": lambda m: m.layered_scene(6, 32, seed=3),
    "mpi_from_plane_images": lambda m: m.mpi_from_plane_images(
        [_content(i) for i in range(3)], dmin=1.0, dmax=4.0),
    "mpi_from_content_images": lambda m: m.mpi_from_content_images(
        16, [_content(0), None, _content(1)], [(5, 6), None, None], [(2, 3), None, None],
        dmin=1.0, dmax=4.0, seed=2),
}


@pytest.mark.parametrize("builder", list(BUILDERS))
def test_toy_mpi_builders_are_bitwise_the_jax_packages(builder):
    def flat(x):
        return x if isinstance(x, tuple) else (x,)

    mine, theirs = flat(BUILDERS[builder](toy_mpi)), flat(BUILDERS[builder](jax_toy))
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        if isinstance(a, dict):
            assert a == b
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(backward=True), dict(patch_overread=1.0),
                                dict(backward=True, bytes_per_el=2, patch_overread=1.7)])
def test_render_cost_equals_the_jax_packages(kw):
    args = (4, 96, 256, 256, 256, 256)
    assert roofline.render_cost(*args, **kw) == jax_roofline.render_cost(*args, **kw)


def test_attained_by_hand():
    chip = roofline.ChipSpec(name="test", hbm_gbps=1000.0, fp32_tflops=10.0, bf16_tflops=40.0)
    cost = {"bytes": 2e9, "flops": 4e10, "samples": 1}
    rep = roofline.attained(0.01, cost, chip)
    # memory 2e9 / 1e12 = 2 ms, arithmetic 4e10 / 1e13 = 4 ms: bound by arithmetic
    assert rep["bound"] == "compute"
    assert rep["speed_of_light_s"] == pytest.approx(4e-3)
    assert rep["sol_fraction"] == pytest.approx(0.4)
    assert rep["attained_gbps"] == pytest.approx(200.0)
    assert rep["attained_tflops"] == pytest.approx(4.0)
    bf16 = roofline.attained(0.01, cost, chip, dtype="bf16")
    assert bf16["bound"] == "memory" and bf16["speed_of_light_s"] == pytest.approx(2e-3)
    assert roofline.attained(0.0, cost, chip)["sol_fraction"] == 0.0
    with pytest.raises(TypeError):  # no default card
        roofline.attained(0.01, cost)


def test_chip_for_names_the_h100_part():
    assert roofline.chip_for("NVIDIA H100 80GB HBM3") is roofline.H100_SXM
    assert roofline.chip_for("NVIDIA H100 PCIe") is roofline.H100_PCIE
    assert roofline.H100_SXM.hbm_gbps == 3350.0 and roofline.H100_SXM.fp32_tflops == 67.0
    assert not any("tpu" in name.lower() for name in dir(roofline))


def test_registry():
    reg = Registry()

    @reg.register("model")
    class Foo:
        pass

    reg.register("model", "bar")(len)
    assert reg.get("model", "Foo") is Foo and reg.get("model", "bar") is len
    assert reg.list("model") == ["Foo", "bar"] and reg.list("nothing") == []
    with pytest.raises(KeyError, match="known"):
        reg.get("model", "baz")
    register_model("port_test_model")(Foo)
    assert registry.get("model", "port_test_model") is Foo


def test_colour_and_range_helpers_match_jax():
    for a, b in ((img.color_ramp((0, 0.2, 1), (1, 0.5, 0), 7),
                  jax_img.color_ramp((0, 0.2, 1), (1, 0.5, 0), 7)),
                 (img.hex_to_rgb("#ff0080"), jax_img.hex_to_rgb("#ff0080")),
                 (img.hex_to_rgb("1a2B3c"), jax_img.hex_to_rgb("1a2B3c"))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    x = np.linspace(-1, 1, 9, dtype=np.float32)
    for fn in ("to_unit_range", "to_sym_range"):
        out = getattr(img, fn)(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(out, np.asarray(getattr(jax_img, fn)(jnp.asarray(x))))


def test_assert_shape_and_print_param_summary(capsys):
    inspect.assert_shape(torch.zeros(2, 5), (2, None))
    with pytest.raises(AssertionError, match="dim 0"):
        inspect.assert_shape(torch.zeros(2, 5), (3, None))
    with pytest.raises(AssertionError, match="rank"):
        inspect.assert_shape(torch.zeros(2, 5), (2,))
    tree = {"a": np.zeros((2, 3), np.float32), "b": {"c": np.zeros((4,), np.float32)}}
    total = inspect.print_param_summary(tree, max_rows=1)
    mine = capsys.readouterr().out
    total_j = jax_inspect.print_param_summary({"a": jnp.zeros((2, 3)),
                                               "b": {"c": jnp.zeros((4,))}}, max_rows=1)
    assert total == total_j == 10 and mine == capsys.readouterr().out
    assert "1 more entries" in mine


def test_profile_scope_and_trace():
    """A span in a ``torch.profiler`` trace while a profiler runs; without
    one, a shared context that does nothing."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with inspect.profile_scope("port.test_span"):
            torch.ones(8).sum()
    assert any(e.name == "port.test_span" for e in prof.events())
    assert inspect.profile_scope("port.test_span") is inspect.profile_scope("other")
