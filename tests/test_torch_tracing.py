"""The port's spans: one helper (``utils.inspect.profile_scope``) that opens a
``record_function`` only while a profiler runs, and the span families the
benchmark's per-layer metrics read, each counted under a CPU
``torch.profiler`` run of tiny configurations.

    loader.wait                     a batch the consumer waits for
    host_draw.{z,pose,noise}        a random draw on the host with its copy
    render.{fused,banded,gather}    a render's warp and composite
    render.composite                the over-composite after a banded or
                                    gather warp, inside its render span
    render.backward                 the renderer's backward kernels
    sampler.mpi                     one request's z draw and generator
"""

import collections
import pathlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gmpi_tpu_torch import config as tcfg
from gmpi_tpu_torch.core import camera as cam
from gmpi_tpu_torch.core import poses as poses_mod
from gmpi_tpu_torch.core.bands import bands_for_config
from gmpi_tpu_torch.core.poses import SphereCameraConfig
from gmpi_tpu_torch.core.renderer import render_mpi, render_mpi_chunked
from gmpi_tpu_torch.data import ShardedLoader
from gmpi_tpu_torch.eval.harness import FakeImageGenerator
from gmpi_tpu_torch.models.generator import Generator
from gmpi_tpu_torch.models.layers import SynthesisLayer
from gmpi_tpu_torch.train import init_train_state, make_train_step
from gmpi_tpu_torch.utils import inspect

BS = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny ops: with several test workers on one machine, PyTorch's
    per-process thread pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(resolution=16, n_planes=4, **train):
    return tcfg.ExperimentConfig(
        name="tiny", resolution=resolution, fov_deg=12.6,
        camera=SphereCameraConfig(sphere_center_z=1.0, sphere_r=1.0, yaw_mean=0.0,
                                  yaw_std=0.289, pitch_mean=0.0, pitch_std=0.127),
        planes=tcfg.PlaneConfig(n_planes=n_planes, min_d=0.95, max_d=1.12),
        hparams=tcfg.StepHparams(batch_size=BS, img_size=resolution, tex_size=resolution,
                                 batch_split=1, gen_lr=0.002, disc_lr=0.002),
        train=tcfg.TrainHparams(**{**dict(z_dim=32, w_dim=32, n_view_per_z=2,
                                          aug_with_lighting=False, total_iters=10), **train}),
        model=tcfg.ModelPreset(channel_base=32 * resolution, channel_max=32, num_bf16_res=0,
                               conv_clamp=None, gen_alpha_largest_res=resolution,
                               mbstd_group_size=2),
        eval_n_planes=n_planes)


def span_counts(fn):
    """``fn()`` under a CPU ``torch.profiler`` run: how often each event name
    occurred."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name for e in prof.events())


def families(counts):
    """The port's span families of ``span_counts``' result."""
    prefixes = ("loader.", "host_draw.", "render.", "sampler.")
    return {k: v for k, v in counts.items() if k.startswith(prefixes)}


def noise_layers(G):
    return sum(1 for m in G.modules() if isinstance(m, SynthesisLayer) and m.use_noise)


# -- the helper ----------------------------------------------------------------------


def test_profile_scope_opens_no_record_function_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(inspect, "record_function", lambda name: opened.append(name))
    for name in ("train_step.d_fakes", "render.fused", "loader.wait"):
        with inspect.profile_scope(name):
            pass
    assert opened == []
    assert inspect.profile_scope("a") is inspect.profile_scope("b")  # one shared no-op
    # the port's own sites go through the helper too
    poses_mod.sample_yaw_pitch(torch.Generator().manual_seed(0), 2, tiny_config().camera,
                               device="cpu")
    assert opened == []
    monkeypatch.undo()
    assert families(span_counts(lambda: poses_mod.sample_yaw_pitch(
        torch.Generator().manual_seed(0), 2, tiny_config().camera, device="cpu"))) == {
        "host_draw.pose": 1}


# -- the sampler and the renderer ------------------------------------------------------


@pytest.mark.parametrize("route,resolution,spans", [
    ("fused", 32, ("render.fused",)),
    ("banded", 128, ("render.banded", "render.composite")),
    ("gather", 32, ("render.gather", "render.composite")),
])
def test_sampler_and_render_spans_once_a_request(route, resolution, spans):
    """A request of the FID loop (``sample_mpi``, ``sample_views``,
    ``render``): one ``sampler.mpi``, one pose draw and one render span of the
    route each, and on the banded and gather routes one ``render.composite``;
    no noise draw (the sampler's noise is constant)."""
    cfg = tiny_config(resolution)
    G = Generator(cfg.generator_cfg(), generator=torch.Generator().manual_seed(0))
    gen = FakeImageGenerator(cfg, G, use_fused=route == "fused", device="cpu")
    assert (gen.tiled_bands is not None) == (route == "banded")

    def requests(n=2):
        for seed in range(n):
            mpi = gen.sample_mpi(seed)
            yaws, pitches = gen.sample_views(seed, 1)
            gen.render(mpi, yaws, pitches)

    assert families(span_counts(requests)) == {"sampler.mpi": 2, "host_draw.pose": 2,
                                               **dict.fromkeys(spans, 2)}


def test_tiled_adjoint_opens_render_backward():
    """The banded render's backward (the tiled adjoint behind 4-field bands)
    runs under ``render.backward``, outside the forward's span."""
    cfg = tiny_config(128, n_planes=2)
    bands = bands_for_config(cfg, device="cpu")
    assert len(bands) == 4
    geom = cfg.plane_geometry(device="cpu")
    yaws, pitches = poses_mod.sample_yaw_pitch(torch.Generator().manual_seed(1), 1,
                                               cfg.camera, device="cpu")
    c2w, _, _ = poses_mod.sample_sphere_poses(None, 1, cfg.camera, given_yaws=yaws,
                                              given_pitches=pitches, device="cpu")
    rays = cam.generate_rays(cam.intrinsics_from_fov(cfg.fov_deg, 128, 128), c2w)
    rgba = torch.rand((1, 2, 4, 128, 128), generator=torch.Generator().manual_seed(2),
                      requires_grad=True)

    def render_and_backward():
        render_mpi(rgba, geom.dhw, *rays, tiled_bands=bands).color.sum().backward()

    assert families(span_counts(render_and_backward)) == {"render.banded": 1,
                                                          "render.composite": 1,
                                                          "render.backward": 1}
    assert rgba.grad is not None and float(rgba.grad.abs().sum()) > 0


def _banded_scene(n_planes, resolution=128, seed=1):
    """A tiny config's tile bands, plane geometry, one view's rays and a
    seeded MPI of ``n_planes`` planes."""
    cfg = tiny_config(resolution, n_planes=n_planes)
    geom = cfg.plane_geometry(device="cpu")
    yaws, pitches = poses_mod.sample_yaw_pitch(torch.Generator().manual_seed(seed), 1,
                                               cfg.camera, device="cpu")
    c2w, _, _ = poses_mod.sample_sphere_poses(None, 1, cfg.camera, given_yaws=yaws,
                                              given_pitches=pitches, device="cpu")
    rays = cam.generate_rays(cam.intrinsics_from_fov(cfg.fov_deg, resolution, resolution), c2w)
    rgba = torch.rand((1, n_planes, 4, resolution, resolution),
                      generator=torch.Generator().manual_seed(seed + 1))
    return bands_for_config(cfg, device="cpu"), geom, rays, rgba


@pytest.mark.parametrize("calls", [1, 3])
def test_composite_span_once_a_render_mpi_call(calls):
    """``render.composite`` opens once a ``render_mpi`` call, on the banded
    and the gather route alike, inside the call's render span."""
    bands, geom, rays, rgba = _banded_scene(4)

    def renders():
        for _ in range(calls):
            render_mpi(rgba, geom.dhw, *rays, tiled_bands=bands)
            render_mpi(rgba, geom.dhw, *rays)

    assert families(span_counts(renders)) == {"render.banded": calls, "render.gather": calls,
                                              "render.composite": 2 * calls}


@pytest.mark.parametrize("plane_chunk,remat", [(1, False), (2, False), (4, False), (2, True)])
def test_composite_span_once_a_slab_of_render_mpi_chunked(plane_chunk, remat):
    """``render_mpi_chunked``: one ``render.composite`` a slab (its partials
    and their combine with the slabs in front), and the same picture as the
    whole render."""
    bands, geom, rays, rgba = _banded_scene(4)
    out = {}

    def chunked():
        out["c"] = render_mpi_chunked(rgba, geom.dhw, *rays, plane_chunk=plane_chunk,
                                      remat=remat, tiled_bands=bands)

    assert families(span_counts(chunked)) == {"render.banded": 1,
                                              "render.composite": 4 // plane_chunk}
    whole = render_mpi(rgba, geom.dhw, *rays, tiled_bands=bands)
    assert (out["c"].color - whole.color).abs().max() <= 1e-5
    assert (out["c"].depth - whole.depth).abs().max() <= 1e-5


# -- the train step --------------------------------------------------------------------


@pytest.mark.parametrize("mode,per_call", [("random", 1), ("const", 0)])
def test_noise_draw_spans_once_per_layer_and_synth_call(mode, per_call):
    cfg = tiny_config()
    G = Generator(cfg.generator_cfg(), generator=torch.Generator().manual_seed(0))
    n_layers = noise_layers(G)
    assert n_layers > 0
    geom = cfg.plane_geometry(device="cpu")
    z = torch.randn((BS, 32), generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)

    def synth(calls=3):
        with torch.no_grad():
            for _ in range(calls):
                G(z, None, cfg.multi_res_xyz(geom), cfg.planes.n_planes, noise_mode=mode,
                  generator=g)

    assert families(span_counts(synth)).get("host_draw.noise", 0) == 3 * n_layers * per_call


def test_train_step_spans():
    """One fused train step on the CPU (the kernels' plain versions): the
    ``train_step.*`` names the benchmark reads, a z draw a phase, a pose draw
    for the D phase's views and the worst-view candidates, noise in each of
    the three synth calls (D's fakes, the candidates, G's forward), a fused
    render in each, and the renderer's backward once (``batch_split`` 1)."""
    cfg = tiny_config(use_fused_renderer=True)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg, device="cpu")
    rng = np.random.default_rng(0)
    real = torch.from_numpy(rng.uniform(-1, 1, (BS, 3, 16, 16)).astype(np.float32))
    pose = torch.from_numpy(rng.standard_normal((BS, 16)).astype(np.float32))
    g = torch.Generator().manual_seed(5)
    counts = span_counts(lambda: step(state, real, pose, g))
    for name in ("train_step.d_fakes", "train_step.worst_views", "train_step.g_forward",
                 "train_step.d_backward", "train_step.g_backward", "train_step.g_update"):
        assert counts[name] == 1, name
    assert families(counts) == {"host_draw.z": 2, "host_draw.pose": 2,
                                "host_draw.noise": 3 * noise_layers(state.G),
                                "render.fused": 3, "render.backward": 1}


# -- the loader ------------------------------------------------------------------------


class _Stub:
    """A dataset of ``n`` rows of one field; each row takes ``delay_s``."""

    def __init__(self, n=8, delay_s=0.0):
        self.n, self.delay_s = n, delay_s

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.delay_s)
        return (np.full((2,), i, np.float32),)


def test_loader_wait_only_when_the_consumer_starves():
    slow = iter(ShardedLoader(_Stub(delay_s=0.2), batch_size=2, num_workers=1, prefetch=1))
    assert families(span_counts(lambda: next(slow))) == {"loader.wait": 1}

    ready = iter(ShardedLoader(_Stub(), batch_size=2, num_workers=2, prefetch=2))
    next(ready)  # starts the pool; the next batch is in flight
    time.sleep(0.5)  # ... and done
    batch = []
    assert families(span_counts(lambda: batch.append(next(ready)))) == {}
    assert batch[0][0].shape == (2, 2)


def test_every_port_site_imports_the_one_helper():
    """No module of the port opens a ``record_function`` of its own."""
    import gmpi_tpu_torch

    root = pathlib.Path(gmpi_tpu_torch.__file__).parent
    raw = [p.relative_to(root).as_posix() for p in root.rglob("*.py")
           if "record_function" in p.read_text() and p.name != "inspect.py"]
    assert raw == []
    assert not hasattr(inspect, "trace")
