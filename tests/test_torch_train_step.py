"""Port parity and behaviour: the GAN train step of ``gmpi_tpu_torch``.

The tiny config of ``tests/test_train.py`` (resolution 16, 4 planes, width
32).  With weights carried across (``params_from_jax``) and identical z,
poses, ``noise_mode="const"`` and image batches, the port's two loss closures
(``TrainStep.d_loss_terms``, ``TrainStep.g_loss``) give the losses and
parameter gradients that the same quantities composed from the JAX package's
public functions give: relative 1e-3 of the largest reference gradient (two
fp32 stacks; the fused case also swaps the renderer for the kernels' plain
versions).  Post-Adam state is not compared with optax.  Then the step as a
whole: finite metrics, moving parameters, EMAs and ``w_avg``, determinism,
and every switch the step has.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.core import camera as jcam
from gmpi_tpu.core import poses as jposes
from gmpi_tpu.core.renderer import poison_if_rays_escape as jax_poison_if_rays_escape
from gmpi_tpu.core.renderer import render_mpi as jax_render_mpi
from gmpi_tpu.core.renderer import render_mpi_chunked as jax_render_mpi_chunked
from gmpi_tpu.train import losses as jax_losses
from gmpi_tpu.train.step import flat_pose_from_c2w as jax_flat_pose
from gmpi_tpu.train.step import init_train_state as jax_init_train_state
from gmpi_tpu_torch import config as tcfg
from gmpi_tpu_torch.core.poses import SphereCameraConfig
from gmpi_tpu_torch.models.converter import params_from_jax
from gmpi_tpu_torch.train import TrainState, init_train_state, make_train_step
from tests.test_train import tiny_config as jax_tiny_config

REL = 1e-3
BS = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny ops: with several test workers on one machine, PyTorch's
    per-process thread pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(batch_split=1, lighting=False, **train):
    return tcfg.ExperimentConfig(
        name="tiny", resolution=16, fov_deg=12.6,
        camera=SphereCameraConfig(sphere_center_z=1.0, sphere_r=1.0, yaw_mean=0.0,
                                  yaw_std=0.289, pitch_mean=0.0, pitch_std=0.127),
        planes=tcfg.PlaneConfig(n_planes=4, min_d=0.95, max_d=1.12),
        hparams=tcfg.StepHparams(batch_size=BS, img_size=16, tex_size=16,
                                 batch_split=batch_split, gen_lr=0.002, disc_lr=0.002),
        train=tcfg.TrainHparams(**{**dict(z_dim=32, w_dim=32, n_view_per_z=2,
                                          aug_with_lighting=lighting, lighting_start_iter=0,
                                          total_iters=10), **train}),
        model=tcfg.ModelPreset(channel_base=512, channel_max=32, num_bf16_res=0,
                               conv_clamp=None, gen_alpha_largest_res=16, mbstd_group_size=2))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (BS, 3, 16, 16)).astype(np.float32),
            rng.standard_normal((BS, 16)).astype(np.float32))


def _fresh(cfg, seed=0):
    state = init_train_state(cfg, torch.Generator().manual_seed(seed), device="cpu")
    real, pose = _batch()
    return state, torch.from_numpy(real), torch.from_numpy(pose)


def _snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _moved(before, module):
    now = module.state_dict()
    return max(float((now[k] - v).abs().max()) for k, v in before.items())


# -- parity with the JAX package ---------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    """JAX init with numpy-perturbed constant leaves, as numpy trees."""
    cfg_j = jax_tiny_config()
    st = jax_init_train_state(cfg_j, jax.random.key(0))
    rng = np.random.default_rng(0)

    def perturb(path, x):
        name = str(path[-1].key)
        x = np.asarray(x)
        if name.startswith("bias") or name in ("noise_strength", "w_avg"):
            return (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    trees = [jax.tree_util.tree_map_with_path(perturb, t)
             for t in (st.params_g, st.buffers_g, st.params_d)]
    return (cfg_j,) + tuple(trees)


def _port_state(cfg, carried) -> TrainState:
    _, params_g, buffers_g, params_d = carried
    state = init_train_state(cfg, device="cpu")
    state.G.load_state_dict(params_from_jax(params_g, buffers_g), strict=True)
    state.D.load_state_dict(params_from_jax(params_d), strict=True)
    return state


def _assert_grads_close(module, ref_tree):
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_tree))
    biggest = max(float(v.abs().max()) for v in ref.values())
    assert biggest > 0
    for k, p in module.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert float((got - ref[k]).abs().max()) <= REL * biggest, k


def test_d_loss_terms_and_gradients_match_jax(carried):
    cfg_j, _, _, params_d = carried
    disc = cfg_j.discriminator_cfg()
    real, real_pose = _batch(1)
    fake, fake_pose = _batch(2)
    lam = cfg_j.train.r1_lambda

    def terms(pd):
        lr, lf = jax_losses.d_gan_loss(disc.apply(pd, jnp.asarray(real), jnp.asarray(real_pose)),
                                       disc.apply(pd, jnp.asarray(fake), jnp.asarray(fake_pose)))
        r1 = jax_losses.r1_penalty(lambda im: disc.apply(pd, im, jnp.asarray(real_pose)),
                                   jnp.asarray(real), lam)
        return lr + lf + r1, (lr, lf, r1)

    (_, ref_terms), ref_grads = jax.jit(jax.value_and_grad(terms, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params_d))

    cfg = tiny_config()
    state = _port_state(cfg, carried)
    step = make_train_step(cfg, device="cpu")
    t = torch.from_numpy
    got = step.d_loss_terms(state, t(real), t(real_pose), t(fake), t(fake_pose))
    for a, b in zip(got, ref_terms):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=REL)
    assert float(got[2].detach()) > 0
    sum(got).backward()
    _assert_grads_close(state.D, ref_grads)


@pytest.mark.parametrize("train", [
    dict(use_fused_renderer=False), dict(use_fused_renderer=True),
    dict(renderer_plane_chunk=2), dict(debug_ray_check=True),
], ids=["gather", "fused", "plane_chunk", "debug_ray_check"])
def test_g_loss_and_gradients_match_jax(carried, train):
    """G's loss and parameter gradients on each render route of the step
    against the same route composed from the JAX package's functions (the
    fused route against JAX's gather render)."""
    cfg_j, params_g, buffers_g, params_d = carried
    gen, disc = cfg_j.generator_cfg(), cfg_j.discriminator_cfg()
    geom = cfg_j.plane_geometry()
    xyz = cfg_j.multi_res_xyz(geom)
    intr = jcam.intrinsics_from_fov(cfg_j.fov_deg, 16, 16)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((BS, 32)).astype(np.float32)
    yaws = rng.uniform(-0.5, 0.5, (BS, 1)).astype(np.float32)
    pitches = rng.uniform(-0.2, 0.2, (BS, 1)).astype(np.float32)
    pd = jax.tree_util.tree_map(jnp.asarray, params_d)
    bg = jax.tree_util.tree_map(jnp.asarray, buffers_g)

    def g_loss(pg):
        mpi = gen.apply(pg, bg, jnp.asarray(z), None, xyz, cfg_j.planes.n_planes,
                        truncation_psi=cfg_j.train.truncation_psi, noise_mode="const")
        c2w, _, _ = jposes.sample_sphere_poses(None, BS, cfg_j.camera, given_yaws=yaws,
                                               given_pitches=pitches)
        rays = jcam.generate_rays(intr, c2w)
        if train.get("renderer_plane_chunk"):
            out = jax_render_mpi_chunked(mpi, geom.dhw, *rays, plane_chunk=2,
                                         align_corners=cfg_j.planes.align_corners,
                                         with_disp=False)
        else:
            out = jax_render_mpi(mpi, geom.dhw, *rays, cfg_j.planes.align_corners)
        color = out.color
        if train.get("debug_ray_check"):
            color = jax_poison_if_rays_escape(color, geom.dhw[-1], rays[1], rays[0], rays[2],
                                              cfg_j.planes.align_corners)
        scores = disc.apply(pd, color * 2.0 - 1.0, jax_flat_pose(c2w, 16))
        return jax_losses.g_gan_loss(scores)

    ref, ref_grads = jax.jit(jax.value_and_grad(g_loss))(
        jax.tree_util.tree_map(jnp.asarray, params_g))

    cfg = tiny_config(**train)
    state = _port_state(cfg, carried)
    step = make_train_step(cfg, device="cpu")
    assert step.use_fused is bool(train.get("use_fused_renderer"))
    t = torch.from_numpy
    got = step.g_loss(state, t(z), t(yaws), t(pitches), noise_mode="const")
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=REL)
    got.backward()
    _assert_grads_close(state.G, ref_grads)


# -- the step as a whole -------------------------------------------------------------


def test_train_step_runs_moves_everything_and_is_deterministic():
    cfg = tiny_config()
    step = make_train_step(cfg, device="cpu")
    assert step.use_fused is False  # auto: the gather path on the CPU
    state, real, pose = _fresh(cfg)
    twin = copy.deepcopy(state)
    g0, d0 = _snapshot(state.G), _snapshot(state.D)
    ema0 = {k: v.clone() for k, v in state.ema.items()}
    new_state, metrics = step(state, real, pose, torch.Generator().manual_seed(1))
    assert new_state is state and state.step == 1
    assert set(metrics) == {"d_loss", "d_loss_real", "d_loss_fake", "r1", "g_loss"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["r1"]) > 0
    params_g0 = {k: v for k, v in g0.items() if k in ema0}
    d_par = _moved(params_g0, state.G)
    d_ema = max(float((state.ema[k] - ema0[k]).abs().max()) for k in ema0)
    d_ema2 = max(float((state.ema2[k] - ema0[k]).abs().max()) for k in ema0)
    assert d_par > 0 and _moved(d0, state.D) > 0
    assert 0 < d_ema2 < d_ema < d_par  # decays .9999 and .999
    assert float(state.G.mapping.w_avg.abs().sum()) > 0  # its first update
    # the same state, batch and generator seed give the same step
    _, again = step(twin, real, pose, torch.Generator().manual_seed(1))
    assert float(again["d_loss"]) == float(metrics["d_loss"])
    assert float(again["g_loss"]) == float(metrics["g_loss"])
    assert all(torch.equal(a, b) for a, b in zip(twin.G.parameters(), state.G.parameters()))


def test_batch_split_matches_full_batch_in_loss_and_gradient():
    """``batch_split=2`` accumulates the loss and gradient of the full batch:
    the D phase of a whole step (its fakes are micro-batched, D scores whole
    batches), and G's loss on given z and views.  ``noise_strength`` is 0 at
    init, so per-slice noise draws are inert; the minibatch-stddev group is 1
    here, because a larger group couples the samples of a micro-batch and
    legitimately changes with the split."""
    d_results, g_results = [], []
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.standard_normal((BS, 32)).astype(np.float32))
    yaws = torch.from_numpy(rng.uniform(-0.5, 0.5, (BS, 1)).astype(np.float32))
    pitches = torch.from_numpy(rng.uniform(-0.2, 0.2, (BS, 1)).astype(np.float32))
    for split in (1, 2):
        cfg = tiny_config(batch_split=split)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, mbstd_group_size=1))
        state, real, pose = _fresh(cfg)
        step = make_train_step(cfg, device="cpu", return_grads=True)
        loss = step.g_loss(state, z, yaws, pitches, noise_mode="const")
        loss.backward()
        g_results.append((float(loss.detach()),
                          {k: p.grad.clone() for k, p in state.G.named_parameters()
                           if p.grad is not None}))
        _, metrics, grads = step(state, real, pose, torch.Generator().manual_seed(2))
        d_results.append((metrics, grads["d"]))
    for k in ("d_loss", "d_loss_real", "d_loss_fake", "r1"):
        np.testing.assert_allclose(float(d_results[1][0][k]), float(d_results[0][0][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(g_results[1][0], g_results[0][0], rtol=1e-5)
    for (_, full), (_, split) in ((d_results[0], d_results[1]), (g_results[0], g_results[1])):
        biggest = max(float(v.abs().max()) for v in full.values())
        assert set(full) == set(split) and biggest > 0
        for k, v in full.items():
            assert float((split[k] - v).abs().max()) <= 1e-4 * biggest, k


def test_frozen_d_and_two_g_iters():
    cfg = tiny_config(train_d=False, g_iters=2)
    state, real, pose = _fresh(cfg)
    g0, d0 = _snapshot(state.G), _snapshot(state.D)
    _, metrics = make_train_step(cfg, device="cpu")(state, real, pose,
                                                    torch.Generator().manual_seed(3))
    assert _moved(d0, state.D) == 0.0 and _moved(g0, state.G) > 0
    assert all(np.isfinite(float(v)) for v in metrics.values())
    # two G phases: Adam has taken two steps on G and none on D
    assert {int(s["step"]) for s in state.opt_g.state.values()} == {2}
    assert len(state.opt_d.state) == 0


@pytest.mark.parametrize("train", [
    dict(worst_view_render_res=8),
    dict(use_fused_renderer=True),
    dict(use_fused_renderer=True, fused_remat=True),
    dict(r1_remat=True, d_batch_split=False),
    dict(use_edge_aware_loss=True, edge_aware_loss_w=0.5),
    dict(train_mapping=False, train_trunk=False),
    dict(renderer_plane_chunk=2),
    dict(debug_ray_check=True, worst_view_render_res=8),
], ids=["low_res_worst_views", "fused", "fused_remat", "r1_remat", "edge_aware", "frozen_trunk",
        "plane_chunk", "debug_ray_check"])
def test_train_step_switches_run(train):
    cfg = tiny_config(batch_split=2, lighting=True, **train)
    state, real, pose = _fresh(cfg)
    state.step = 5  # past lighting_start_iter: the lit branch
    g0 = _snapshot(state.G)
    step = make_train_step(cfg, device="cpu", return_grads=True)
    _, metrics, grads = step(state, real, pose, torch.Generator().manual_seed(4))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(torch.isfinite(g).all() for g in grads["g"].values())
    assert _moved(g0, state.G) > 0
    if train.get("train_mapping") is False:
        # frozen mapping and trunk: only the MPI heads receive a gradient
        assert not any(k.startswith("mapping.") for k in grads["g"])
        assert not any(".conv0." in k or ".conv1." in k for k in grads["g"])
        assert any(".toalpha." in k for k in grads["g"])


@pytest.mark.parametrize("train", [
    dict(use_fused_renderer=True, n_view_per_z=3),
    dict(use_fused_renderer=True, fused_remat=True),
    dict(n_view_per_z=3),
    dict(worst_view_render_res=8),
], ids=["fused_grouped_stacks", "fused_remat", "gather", "low_res"])
def test_worst_views_picks_the_views_of_the_repeated_mpi_render(train):
    """Worst-view selection hands the MPIs over once; the fused route reads
    each stack for its group of candidate views, the other routes repeat it.
    Either way the selected cameras are those of rendering
    ``mpi.repeat_interleave(n_view_per_z)``, as before stacks could be grouped."""
    cfg = tiny_config(**train)
    state, _, _ = _fresh(cfg)
    step = make_train_step(cfg, device="cpu")
    z = torch.from_numpy(np.random.default_rng(5).standard_normal((BS, 32)).astype(np.float32))
    yaws, pitches = step.worst_views(state, z, torch.Generator().manual_seed(9))

    gen = torch.Generator().manual_seed(9)
    v = cfg.train.n_view_per_z
    with torch.no_grad():
        mpi = step.synth(state.G, z, gen)
        all_yaws, all_pitches = step.sample_views(gen, BS * v)
        imgs, flat_pose, _ = step.render_views(mpi.repeat_interleave(v, dim=0), all_yaws,
                                               all_pitches, low_res=cfg.train.worst_view_render_res)
        grouped, _, _ = step.render_views(mpi, all_yaws, all_pitches,
                                          low_res=cfg.train.worst_view_render_res)
        sel = torch.argmin(state.D(imgs, flat_pose).reshape(BS, v), dim=1) + torch.arange(BS) * v
    assert torch.equal(grouped, imgs)
    assert torch.equal(yaws, all_yaws[sel]) and torch.equal(pitches, all_pitches[sel])
    assert yaws.shape == (BS, 1)
    with pytest.raises(ValueError, match="multiple"):
        step.render_views(mpi[:3], all_yaws[:4], all_pitches[:4])


def test_lighting_changes_the_fakes_only_past_its_start():
    cfg = tiny_config(lighting=True)
    step = make_train_step(cfg, device="cpu")
    mpi = torch.rand((2, 4, 4, 16, 16), generator=torch.Generator().manual_seed(0))
    assert step.maybe_light(mpi, 0, None) is mpi
    lit = step.maybe_light(mpi, 500, torch.Generator().manual_seed(1))
    assert lit.shape == mpi.shape and not torch.equal(lit, mpi)
    assert torch.equal(lit[:, :, 3], mpi[:, :, 3])


@pytest.mark.parametrize("train,kw,queue", [
    (dict(renderer_plane_chunk=2), {}, None),
    (dict(debug_ray_check=True), {}, None),
    (dict(fused_compute_dtype="bf16"), {}, "A4"),
    ({}, dict(mesh=object()), "A9"),
], ids=["renderer_plane_chunk", "debug_ray_check", "bf16_textures", "mesh"])
def test_switches_not_ported_yet_raise(train, kw, queue):
    """Every switch of the step is ported now: the two ported first
    (``queue`` None) build a non-fused step; bf16 textures (Queue A4) build a
    step whose fused renders read bf16 and raise on any other dtype name; a
    mesh (Queue A9) of one rank builds a step, and one that asks for shards
    without the ranks to hold them raises."""
    if queue is None:
        assert make_train_step(tiny_config(**train), device="cpu", **kw).use_fused is False
    elif queue == "A4":
        step = make_train_step(tiny_config(use_fused_renderer=True, **train), device="cpu")
        assert step.compute_dtype == torch.bfloat16
        with pytest.raises(ValueError, match="fused_compute_dtype"):
            make_train_step(tiny_config(fused_compute_dtype="fp16"), device="cpu")
    else:
        from gmpi_tpu_torch.parallel.mesh import Mesh

        mesh = Mesh([1, 1, 1], ("data", "plane", "tile"), device="cpu")
        step = make_train_step(tiny_config(), device="cpu", mesh=mesh)
        assert not step.sharded and step.n_data == 1 and step.world is None
        with pytest.raises(ValueError, match="needs 2 ranks"):
            Mesh([2], ("plane",), device="cpu")


def test_debug_ray_check_poisons_a_pose_whose_rays_escape():
    mpi = torch.rand((2, 4, 4, 16, 16), generator=torch.Generator().manual_seed(0))
    yaws, pitches = torch.tensor([[0.3], [1.4]]), torch.tensor([[0.1], [0.0]])
    for check in (False, True):
        step = make_train_step(tiny_config(debug_ray_check=check), device="cpu")
        for low_res in (0, 8):
            imgs, _, _ = step.render_views(mpi, yaws, pitches, low_res=low_res)
            assert bool(torch.isnan(imgs).all()) is check
            inside, _, _ = step.render_views(mpi[:1], yaws[:1], pitches[:1], low_res=low_res)
            assert torch.isfinite(inside).all()


def test_non_fused_step_renders_through_tile_bands_at_128():
    """At 128 pixels and above the non-fused routes take the static tile bands
    of ``bands_for_config`` (4 fields here: the tiled adjoint is the warp's
    backward): same images and ``rgba`` gradient as the per-pixel gather
    (5e-4; 1e-3 of max), whole and in plane slabs."""
    from gmpi_tpu_torch.core import camera as cam
    from gmpi_tpu_torch.core import poses
    from gmpi_tpu_torch.core.renderer import render_mpi

    base = tiny_config()
    rng = torch.Generator().manual_seed(0)
    mpi = torch.rand((2, 4, 4, 128, 128), generator=rng)
    cot = torch.randn((2, 3, 128, 128), generator=rng)
    yaws, pitches = torch.tensor([[0.5], [-0.3]]), torch.tensor([[0.2], [-0.1]])
    c2w, _, _ = poses.sample_sphere_poses(None, 2, base.camera, given_yaws=yaws,
                                          given_pitches=pitches, device="cpu")
    rays = cam.generate_rays(cam.intrinsics_from_fov(base.fov_deg, 128, 128), c2w)
    results = []
    for train in (None, dict(), dict(renderer_plane_chunk=2)):
        x = mpi.clone().requires_grad_()
        if train is None:
            geom = base.plane_geometry(device="cpu")
            imgs = render_mpi(x, geom.dhw, *rays).color * 2.0 - 1.0
        else:
            cfg = tiny_config(**train)
            cfg = dataclasses.replace(cfg, resolution=128, hparams=dataclasses.replace(
                cfg.hparams, img_size=128, tex_size=128))
            step = make_train_step(cfg, device="cpu")
            assert len(step.tiled_bands) == 4
            imgs, _, _ = step.render_views(x, yaws, pitches)
        results.append((imgs.detach(), torch.autograd.grad((imgs * cot).sum(), x)[0]))
    (ref, g_ref), rest = results[0], results[1:]
    for imgs, g in rest:
        assert float((imgs - ref).abs().max()) <= 5e-4
        assert float((g - g_ref).abs().max()) <= 1e-3 * float(g_ref.abs().max())


def test_step_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_step(tiny_config())
    with pytest.raises(RuntimeError, match="cuda"):
        init_train_state(tiny_config())
    with pytest.raises(ValueError, match="align_corners"):
        cfg = tiny_config(use_fused_renderer=True)
        make_train_step(dataclasses.replace(
            cfg, planes=dataclasses.replace(cfg.planes, align_corners=False)), device="cpu")
