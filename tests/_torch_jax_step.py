"""The JAX package's train step as the reference of the port's step tests.

A whole step of each package draws its own random numbers (``jax.random``
keys against one ``torch.Generator``), so the two are made to consume the
same ones: :func:`jax_draws` repeats the JAX step's key schedule
(``gmpi_tpu/train/step.py``: ``train_step``, ``d_phase``, ``g_phase``,
``worst_views``) to compute the z, camera and light angles that step draws,
and the port's step is handed them (``tests/_torch_dist_child.py``:
``inject_draws``).  The synthesis noise is not a draw that the two packages
can share, so both generators run with their constant noise buffers
(``noise_mode="const"``) inside the steps.

:func:`jax_state` is the JAX init of a configuration with its constant
leaves (biases, noise strengths, ``w_avg``) moved off their init values by a
seeded numpy draw: at the init values a leaky ReLU sees pre-activations of
exactly 0 in places, where the two packages pick different one-sided
derivatives.  :func:`run_jax_step` steps it with the JAX package's fused
kernels in interpret mode (the CPU has no TPU), and :func:`port_params`
carries the state over to the port's names.
"""

import contextlib
import dataclasses
from unittest import mock

import numpy as np

import jax
import jax.numpy as jnp

from gmpi_tpu.core import poses as jposes
from gmpi_tpu.models import generator as jgen
from gmpi_tpu.ops import pallas_warp as jpw
from gmpi_tpu.core import renderer as jrenderer
from gmpi_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from gmpi_tpu.train.step import init_train_state, make_train_step
from gmpi_tpu_torch.models.converter import params_from_jax
from tests.test_train import tiny_config as _jax_base_config

STEP_KEY = 7


def jax_config(cfg_t):
    """The JAX ``ExperimentConfig`` of a port configuration built by
    ``tests/_torch_dist_child.tiny_config`` (same sizes, batch, minibatch
    std group and train switches)."""
    base = _jax_base_config()
    t = cfg_t.train
    train = dataclasses.replace(
        base.train, train_d=t.train_d, worst_view_render_res=t.worst_view_render_res,
        use_fused_renderer=t.use_fused_renderer, fused_compute_dtype=t.fused_compute_dtype,
        aug_with_lighting=t.aug_with_lighting, lighting_start_iter=t.lighting_start_iter,
        n_view_per_z=t.n_view_per_z)
    h = cfg_t.hparams
    return dataclasses.replace(
        base, resolution=cfg_t.resolution,
        planes=dataclasses.replace(base.planes, n_planes=cfg_t.planes.n_planes),
        hparams=dataclasses.replace(base.hparams, batch_size=h.batch_size, img_size=h.img_size,
                                    tex_size=h.tex_size),
        model=dataclasses.replace(base.model, mbstd_group_size=cfg_t.model.mbstd_group_size,
                                  gen_alpha_largest_res=cfg_t.model.gen_alpha_largest_res),
        train=train)


def jax_state(cfg_j, seed=0):
    """JAX init with numpy-perturbed constant leaves (EMAs = the parameters)."""
    st = init_train_state(cfg_j, jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        x = np.asarray(x)
        name = str(path[-1].key)
        if name.startswith("bias") or name in ("noise_strength", "w_avg"):
            x = (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
        return jnp.asarray(x)

    params_g = jax.tree_util.tree_map_with_path(perturb, st.params_g)
    return st._replace(params_g=params_g,
                       buffers_g=jax.tree_util.tree_map_with_path(perturb, st.buffers_g),
                       params_d=jax.tree_util.tree_map_with_path(perturb, st.params_d),
                       ema=params_g, ema2=params_g)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_params(st):
    """A JAX state's G (with buffers) and D as the port's state dicts."""
    return {"G": params_from_jax(_np(st.params_g), _np(st.buffers_g)),
            "D": params_from_jax(_np(st.params_d))}


def _light_cfg(cfg_j):
    """The camera configuration that ``lighting.light_mpi`` draws the light
    from, for the step's ``LightingConfig``."""
    from gmpi_tpu.core.lighting import LightingConfig

    t = cfg_j.train
    light = LightingConfig(sphere_center_z=cfg_j.camera.sphere_center_z,
                           sphere_r=cfg_j.camera.sphere_r, ka_max=t.lighting_max_ka,
                           kd_max=t.lighting_max_kd, n_grow_iters=t.lighting_grow_n_iters)
    return jposes.SphereCameraConfig(
        sphere_center_z=light.sphere_center_z, sphere_r=light.sphere_r,
        yaw_mean=light.l_h_mean, yaw_std=light.l_h_std, pitch_mean=light.l_v_mean,
        pitch_std=light.l_v_std, n_truncated_stds=2.0, sample_method="truncated_gaussian")


def jax_draws(cfg_j, key=STEP_KEY):
    """The random numbers of one JAX step with ``batch_split`` 1, whole
    batch, in the order the port's step asks for them: ``z`` (D phase, G
    phase) and ``views`` (D cameras, D light, G cameras or worst-view
    candidates, G light; the lights only with the lighting augmentation)."""
    t, bs = cfg_j.train, cfg_j.hparams.batch_size
    assert cfg_j.hparams.batch_split == 1 and t.g_iters == 1
    lit = t.aug_with_lighting
    light_cfg = _light_cfg(cfg_j) if lit else None

    def angles(k, n, cfg):
        return tuple(np.asarray(a) for a in jposes.sample_yaw_pitch(k, n, cfg))

    rng_d, rng_g = jax.random.split(jax.random.key(key))
    z, views = [], []
    k_z, _, k_light, k_pose = jax.random.split(rng_d, 4)
    z.append(np.asarray(jax.random.normal(k_z, (bs, t.z_dim), jnp.float32)))
    views.append(angles(k_pose, bs, cfg_j.camera))
    if lit:
        views.append(angles(jax.random.split(k_light, 1)[0], bs, light_cfg))
    k_z, k_worst, _, k_light, k_pose = jax.random.split(jax.random.fold_in(rng_g, 0), 5)
    z.append(np.asarray(jax.random.normal(k_z, (bs, t.z_dim), jnp.float32)))
    if t.n_view_per_z > 1 and t.select_worst_view:
        views.append(angles(jax.random.split(k_worst)[1], bs * t.n_view_per_z, cfg_j.camera))
    else:
        views.append(angles(k_pose, bs, cfg_j.camera))
    if lit:
        views.append(angles(jax.random.split(k_light, 1)[0], bs, light_cfg))
    return {"z": z, "views": views}


@contextlib.contextmanager
def _reference_mode():
    """The JAX step's fused kernels in interpret mode, its generator on its
    constant noise."""
    render, slab = jrenderer.render_mpi_fused, jpw.make_fused_slab_renderer
    apply = jgen.GeneratorCfg.apply

    def const_apply(self, *a, **kw):
        return apply(self, *a, **{**kw, "noise_mode": "const"})

    with mock.patch.object(jrenderer, "render_mpi_fused",
                           lambda *a, **kw: render(*a, **{**kw, "interpret": True})), \
            mock.patch.object(jpw, "make_fused_slab_renderer",
                              lambda *a, **kw: slab(*a, **{**kw, "interpret": True})), \
            mock.patch.object(jgen.GeneratorCfg, "apply", const_apply):
        yield


def run_jax_step(cfg_j, st, real, pose, axes=None, sizes=None, key=STEP_KEY):
    """One JAX step of ``st`` on ``real``/``pose`` (numpy).  ``axes``: a
    renderer mesh (``("plane",)``, ``("tile",)``, ``("plane", "tile")``)
    passed to the step, or ``("data",)``: the state replicated and the batch
    split over a data mesh, as the JAX training loop lays them out.  Returns
    ``{"metrics", "grads": {"d", "g"}, "G", "ema", "ema2"}`` in the port's
    names."""
    mesh = None
    real, pose = jnp.asarray(real), jnp.asarray(pose)
    if axes is not None:
        n = int(np.prod(sizes))
        mesh = make_mesh(list(sizes), axes, devices=jax.devices()[:n])
        st = replicate(mesh, st)
        if axes == ("data",):
            real, pose = shard_batch(mesh, (real, pose))
            mesh = None
    with _reference_mode():
        step = make_train_step(cfg_j, donate=False, mesh=mesh, return_grads=True)
        new, metrics, grads = step(st, real, pose, jax.random.key(key))
        metrics = {k: float(v) for k, v in metrics.items()}
    return {"metrics": metrics,
            "grads": {ph: params_from_jax(_np(grads[ph])) for ph in ("d", "g")},
            "G": params_from_jax(_np(new.params_g), _np(new.buffers_g)),
            "ema": params_from_jax(_np(new.ema)), "ema2": params_from_jax(_np(new.ema2))}


# fp32 (tiny config, 16^2; measured: metrics <= 2.4e-7, D gradients <= 2.3e-5
# of each tensor's largest entry, G <= 1.2e-4 on a noise strength whose
# gradient is 3.5e-3 of G's largest, a sum over every pixel with
# cancellation, else <= 1.1e-5; G after the update <= 4.1e-5, EMAs <= 4.8e-7):
# 1e-4 relative, the JAX package's own gate for its sharded step, with each
# gradient's scale at least 1e-2 of its phase's largest.  A parameter moves
# by about the learning rate (0.002) in Adam's first step, so a gradient
# sign read differently would show as ~4e-3: G's state within a tenth of it.
FP32_GATES = dict(metric_tol=1e-4, grad_tol={"d": 1e-4, "g": 1e-4}, grad_floor=1e-2,
                  param_tol=2e-4, ema_tol=2e-6)
# bf16 textures (128^2, 2 planes, batch 2).  Rendering in fp32 instead
# moves d_loss_fake by 8e-6, g_loss by 1.9e-6 and G's gradients by 1.9e-3
# of their largest; measured against the JAX step: metrics <= 6e-7, G's
# gradients <= 6.6e-5 of G's largest.  D's gradients come out <= 8.7e-4 of
# D's largest, about the bf16 effect itself (1.0e-3), from the JAX side:
# jit-compiled on the CPU, the JAX bf16 kernel rounds a few of its x-hats
# to the other bf16 neighbour (240 of 98304 values of the D phase's fakes
# differ from the same kernel run op by op, by up to 4.3e-3, and the port
# reproduces the op-by-op kernel within 1.2e-7), and the first layers' D
# gradients sum exactly those pixels.  So the D phase's bf16 render is held
# by its loss (d_loss_fake within 1e-6) and D's gradients within 2e-3.
BF16_GATES = dict(metric_tol=1e-6, grad_tol={"d": 2e-3, "g": 2e-4}, grad_floor=1.0,
                  param_tol=2e-4, ema_tol=2e-6)


def assert_step_matches(ref, got, metric_tol, grad_tol, grad_floor, param_tol, ema_tol):
    """The port's step ``got`` (``tests/_torch_dist_child.step_record``)
    against the JAX step ``ref``: metrics within ``metric_tol * max(1, |m|)``;
    every D and G gradient within ``grad_tol[phase]`` of the larger of its
    own largest entry and ``grad_floor`` times its phase's largest
    (``grad_floor=1``: of the phase's largest); G's parameters and buffers
    after the update within ``param_tol``, both EMAs within ``ema_tol``."""
    assert sorted(ref["metrics"]) == sorted(got["metrics"])
    for k, a in ref["metrics"].items():
        b = got["metrics"][k]
        assert np.isfinite(b) and abs(a - b) <= metric_tol * max(1.0, abs(a)), (k, a, b)
    for ph in ("d", "g"):
        r, g = ref["grads"][ph], got["grads"][ph]
        assert sorted(r) == sorted(g) and r, ph
        biggest = max(float(v.abs().max()) for v in r.values())
        assert biggest > 0, ph
        for k, a in r.items():
            scale = max(float(a.abs().max()), grad_floor * biggest)
            err = float((a - g[k]).abs().max())
            assert err <= grad_tol[ph] * scale, (ph, k, err, scale)
    for part, tol in (("G", param_tol), ("ema", ema_tol), ("ema2", ema_tol)):
        r, g = ref[part], got[part]
        assert sorted(r) == sorted(g), part
        for k, a in r.items():
            assert float((a - g[k]).abs().max()) <= tol, (part, k)
