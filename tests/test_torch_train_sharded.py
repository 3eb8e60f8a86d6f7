"""Port parity: the train step over a mesh of ranks (``make_train_step(cfg,
mesh=...)``), mirroring ``tests/test_train_sharded.py``.

The tiny config (resolution 16, 4 planes, width 32, D frozen, worst views
at 16^2) steps once in ``gloo`` groups of 2 and 4 ranks on the CPU (one
spawn each: ``tests/_torch_dist_child.py``) over ``("plane",)``,
``("tile",)``, ``("plane", "tile")`` and ``("data",)`` meshes, fused (the
kernels' plain versions, bf16 textures in two cases) and not.

* Against the JAX package's step on a mesh of the same axes and sizes over
  the virtual CPU devices of ``tests/conftest.py`` (the data mesh splits the
  batch, as the JAX loop lays it out), from the JAX state on the JAX step's
  draws (``tests/_torch_jax_step.py``): metrics, every D and G gradient, G's
  state and both EMAs after the update, within ``FP32_GATES`` (1e-4
  relative, the JAX package's own gate for its sharded step) and, for bf16
  textures on a plane mesh at 128^2, ``BF16_GATES``; both state what they
  measure.  The fused fp32 layouts at 16^2 are held against the JAX step's
  gather route (the JAX kernels need 128 pixels).
* Against the port's own step in one process, from one seeded state:
  metrics and every gradient within 1e-4 relative (1e-3 with bf16 textures,
  see ``BF16_REL``).

The data mesh splits a global batch of 8 at ``mbstd_group_size`` 4, so each
minibatch std group straddles both ranks; its D loss terms and gradients on
given images are also held against the JAX package's on the whole batch
(1e-3 of the largest gradient), and grouping each rank's samples alone
misses them by far.  After every step the ranks' states are bitwise equal
(``check_replica_consistency(atol=0)``), and a perturbed replica raises on
every rank.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.train import losses as jax_losses
from gmpi_tpu.train.step import init_train_state as jax_init_train_state
from gmpi_tpu_torch.models.converter import params_from_jax
from tests import _torch_dist_child as child
from tests import _torch_jax_step as jax_step
from tests.test_train import tiny_config as jax_tiny_config

REL = 1e-4
CROSS_REL = 1e-3
# bf16 textures: the bilinear weights of the bf16 form do not sum to exactly
# one, so an alpha of 1 samples up to 2^-8 above it and the transmittance
# behind it turns negative; the single process's inference early-out (T <
# 1e-6) stops such a pixel, a plane slab (which cannot know T in front) does
# not, and the two differ there by that 2^-8 times what lies behind
BF16_REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def d_case():
    """JAX D parameters of the tiny config at ``mbstd_group_size`` 4 and a
    global batch of 8 real and fake images with poses."""
    cfg_j = jax_tiny_config()
    cfg_j = dataclasses.replace(cfg_j, model=dataclasses.replace(cfg_j.model,
                                                                 mbstd_group_size=4))
    params_d = jax.tree_util.tree_map(
        np.asarray, jax_init_train_state(cfg_j, jax.random.key(0)).params_d)
    rng = np.random.default_rng(5)
    batch = dict(real=rng.uniform(-1, 1, (8, 3, 16, 16)).astype(np.float32),
                 real_pose=rng.standard_normal((8, 16)).astype(np.float32),
                 fake=rng.uniform(-1, 1, (8, 3, 16, 16)).astype(np.float32),
                 fake_pose=rng.standard_normal((8, 16)).astype(np.float32))
    return cfg_j, params_d, batch


def _jax_case(name, over):
    """The JAX configuration, perturbed init state and draws of a case of
    ``child.JAX_CASES`` (under 128 pixels ``jax_config`` renders through the
    JAX step's gather route)."""
    cfg_j = jax_step.jax_config(child.tiny_config(**over))
    return cfg_j, jax_step.jax_state(cfg_j), jax_step.jax_draws(cfg_j)


@pytest.fixture(scope="module")
def runs_and_refs(d_case, tmp_path_factory):
    """Every rank's results of the step job by world size, and the JAX
    step's of each ``child.JAX_CASES`` case (computed while the children
    run; the fused plane x tile case shares the JAX step of its mesh)."""
    _, params_d, batch = d_case
    out, refs = {}, {}
    for world in (2, 4):
        work = tmp_path_factory.mktemp(f"step{world}")
        np.savez(work / "inputs.npz", **batch)
        torch.save(params_from_jax(params_d), work / "d_params.pt")
        cases = {}
        for name, (axes, sizes, over) in child.JAX_CASES[world].items():
            cfg_j, st, draws = _jax_case(name, over)
            torch.save({"params": jax_step.port_params(st), "draws": draws},
                       work / f"jax_{name}.pt")
            cases[name] = (cfg_j, st, axes, sizes, over)
        procs = child.start("step", world, str(work))
        try:
            done = {}
            for name, (cfg_j, st, axes, sizes, over) in cases.items():
                key = (axes, cfg_j.train.use_fused_renderer, cfg_j.hparams.img_size)
                if key not in done:
                    real, pose = child.step_batch(child.tiny_config(**over))
                    done[key] = jax_step.run_jax_step(cfg_j, st, real, pose, axes, sizes)
                refs[name] = done[key]
        finally:
            out[world] = child.finish(procs, str(work))
    return out, refs


@pytest.fixture(scope="module")
def runs(runs_and_refs):
    return runs_and_refs[0]


def _assert_grads_close(a, b, tol=REL):
    assert sorted(a) == sorted(b) and a
    for k in a:
        x, y = a[k].numpy(), b[k].numpy()
        scale = max(np.abs(x).max(), np.abs(y).max(), 1e-8)
        assert np.abs(x - y).max() / scale < tol, (k, np.abs(x - y).max(), scale)


CASES = [(w, name) for w in sorted(child.STEP_CASES) for name in child.STEP_CASES[w]]


@pytest.mark.parametrize("world,name", CASES, ids=[f"{w}-{n}" for w, n in CASES])
def test_sharded_step_matches_single_process(runs, world, name):
    _, _, over = child.STEP_CASES[world][name]
    tol = BF16_REL if over.get("fused_compute_dtype") else REL
    state_1, metrics_1, grads_1 = child.run_step(child.tiny_config(**over))
    for r, res in enumerate(runs[world]):
        got = res[name]
        assert got["finite"] and got["step"] == 1 and state_1.step == 1
        for k, a in metrics_1.items():
            b = got["metrics"][k]
            assert np.isfinite(a) and np.isfinite(b), (k, a, b)
            assert abs(a - b) < tol * max(1.0, abs(a)), (r, k, a, b)
        _assert_grads_close(grads_1["d"], got["grads"]["d"], tol)
        _assert_grads_close(grads_1["g"], got["grads"]["g"], tol)


def test_replicas_equal_and_perturbation_caught(runs):
    """Every step case already ran ``check_replica_consistency(atol=0)`` on
    the whole state (a divergence fails the child); a replica perturbed by
    1e-3 in one bias raises on every rank, naming it."""
    for world, results in runs.items():
        for r in results:
            assert r["modules"] == []  # the children imported no JAX
            msg = r["perturbed"]
            assert msg.startswith("replica divergence at D.b4.fc.bias"), msg
            assert abs(float(re.search(r"max abs diff (\S+)", msg).group(1)) - 1e-3) < 1e-6


def test_data_parallel_minibatch_std_matches_jax(runs, d_case):
    """D's loss terms and gradients over a 2-rank data mesh, each rank on its
    half of the batch, against the JAX package's D on the whole batch."""
    cfg_j, params_d, batch = d_case
    disc = cfg_j.discriminator_cfg()
    b = {k: jnp.asarray(v) for k, v in batch.items()}

    def terms(pd):
        lr, lf = jax_losses.d_gan_loss(disc.apply(pd, b["real"], b["real_pose"]),
                                       disc.apply(pd, b["fake"], b["fake_pose"]))
        r1 = jax_losses.r1_penalty(lambda im: disc.apply(pd, im, b["real_pose"]), b["real"],
                                   cfg_j.train.r1_lambda)
        return lr + lf + r1, (lr, lf, r1)

    (_, ref_terms), ref_grads = jax.jit(jax.value_and_grad(terms, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params_d))
    ref_terms = [float(x) for x in ref_terms]
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads))
    biggest = max(float(v.abs().max()) for v in ref.values())
    for res in runs[2]:
        got = res["d_terms"]
        np.testing.assert_allclose(got["terms"], ref_terms, rtol=CROSS_REL)
        for k, g in got["grads"].items():
            assert float((g - ref[k]).abs().max()) <= CROSS_REL * biggest, k
        # grouping each rank's samples alone is another D: far outside the gate
        local = res["d_terms_local_mbstd"]
        worst = max(float((local["grads"][k] - ref[k]).abs().max()) for k in ref)
        assert worst > 10 * CROSS_REL * biggest


JAX_CASES = [(w, name) for w in sorted(child.JAX_CASES) for name in child.JAX_CASES[w]]


@pytest.mark.parametrize("world,name", JAX_CASES, ids=[f"{w}-{n}" for w, n in JAX_CASES])
def test_sharded_step_matches_jax(runs_and_refs, world, name):
    """Each rank's step from the JAX package's state on its draws against
    the JAX step on the same mesh: metrics, every D and G gradient, and G's
    state and EMAs after the update (``jax_step.assert_step_matches``)."""
    runs, refs = runs_and_refs
    bf16 = child.JAX_CASES[world][name][2].get("fused_compute_dtype") == "bf16"
    for res in runs[world]:
        if bf16:
            jax_step.assert_step_matches(refs[name], res["jax_" + name], **jax_step.BF16_GATES)
        else:
            jax_step.assert_step_matches(refs[name], res["jax_" + name], **jax_step.FP32_GATES)
