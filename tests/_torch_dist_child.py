"""One rank of the port's multi-process tests: a ``gloo`` process group on the
CPU, its rendezvous a file in the work directory (no port to collide on
under parallel test workers).

    python tests/_torch_dist_child.py <job> <rank> <world> <work_dir>

Imports torch, numpy and ``gmpi_tpu_torch`` only, never JAX or the JAX
package (its result records which of the two were imported).  Each job
reads ``<work_dir>/inputs.npz`` (written by the test) and writes
``<work_dir>/result_<rank>.pt``.  :func:`spawn` runs one job in ``world``
processes and returns every rank's result, raising with the output of a rank
that failed (:func:`start` and :func:`finish` split it, so that the caller
can work while the children run).
"""

import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

GEOM_KW = dict(min_d=0.95, max_d=1.12, distance_sample_method="inverse", fov_deg=12.6,
               sphere_center_z=1.0, sphere_r=1.0, yaw_mean=0.0, yaw_std=0.289,
               pitch_mean=0.0, pitch_std=0.127, n_truncated_stds=2.0, enlarge_factor=1.001,
               confined=True)


def start(job: str, world: int, work_dir: str, env=None):
    """Start ``job`` in ``world`` child processes (their output goes to
    ``<work_dir>/out_<rank>.txt``); :func:`finish` collects them."""
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + env.get("PYTHONPATH", "").split(os.pathsep))
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = []
    for r in range(world):
        with open(os.path.join(work_dir, f"out_{r}.txt"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
                 str(work_dir)], env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def finish(procs, work_dir: str, timeout: float = 300.0):
    """Wait for the children of :func:`start`; every rank's result dict,
    raising with the output of a rank that failed."""
    import torch

    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(work_dir, f"out_{r}.txt")) as log:
                out = log.read()
            raise RuntimeError(f"rank {r} of {len(procs)} exited {p.returncode}\n{out[-6000:]}")
    return [torch.load(os.path.join(work_dir, f"result_{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def spawn(job: str, world: int, work_dir: str, timeout: float = 300.0, env=None):
    """Run ``job`` in ``world`` child processes; every rank's result dict."""
    return finish(start(job, world, work_dir, env), work_dir, timeout)


def _geometry(n_planes):
    from gmpi_tpu_torch.core import geometry as geom_mod

    return geom_mod.build_plane_geometry(n_planes=n_planes, **GEOM_KW, device="cpu")


def _rays(yaws, pitches, res):
    import torch

    from gmpi_tpu_torch.core import camera as cam
    from gmpi_tpu_torch.core import poses

    c2w = poses.c2w_from_yaw_pitch(torch.as_tensor(yaws), torch.as_tensor(pitches), 1.0, 1.0)
    return cam.generate_rays(cam.intrinsics_from_fov(12.6, res, res), c2w)


# -- job: the sharded renderers -------------------------------------------------------


def job_render(rank, world, work, inputs):
    """Every function of ``parallel/render.py`` that the world size affords,
    on the gather, fused and banded routes: outputs and the ``rgba``
    gradient of ``sum(color * cot) + sum(depth * cot_d)``."""
    import torch

    from gmpi_tpu_torch.core.renderer import make_fused_slab_renderer, render_mpi_fused
    from gmpi_tpu_torch.ops.tiled_warp import required_bands
    from gmpi_tpu_torch.core.renderer import homography_grid
    from gmpi_tpu_torch.parallel import make_mesh
    from gmpi_tpu_torch.parallel import render as pr

    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    n_planes = t["rgba"].shape[1]
    geom = _geometry(n_planes)
    rays = _rays(t["yaws"], t["pitches"], t["rgba"].shape[-1])
    fused_fn = lambda r, d, rd, e, z: render_mpi_fused(r, d, rd, e, z, with_disp=True)  # noqa
    cases = {}

    def run(name, fn, rgba, dhw, rays, with_disp, cot, cot_d):
        x = rgba.clone().requires_grad_()
        out = fn(x, dhw, *rays)
        loss = (out.color * cot).sum() + (out.depth * cot_d).sum()
        grad, = torch.autograd.grad(loss, x)
        cases[name] = {"color": out.color.detach(), "depth": out.depth.detach(),
                       "disp": out.disp.detach() if with_disp else None, "grad": grad}

    small = (t["rgba"], geom.dhw, rays)
    cots = (t["cot"], t["cot_d"])
    if world in (2, 4):
        mt = make_mesh([world], ("tile",), device="cpu")
        mp = make_mesh([world], ("plane",), device="cpu")
        for disp in (False, True):
            sfx = "_disp" if disp else ""
            run("tile" + sfx, lambda x, d, *r, disp=disp: pr.render_mpi_tile_sharded(
                mt, x, d, *r, with_disp=disp), *small, disp, *cots)
            run("plane" + sfx, lambda x, d, *r, disp=disp: pr.render_mpi_plane_sharded(
                mp, x, d, *r, with_disp=disp), *small, disp, *cots)
        run("tile_fused", lambda x, d, *r: pr.render_mpi_tile_sharded(
            mt, x, d, *r, render_fn=fused_fn, with_disp=True), *small, True, *cots)
        run("plane_fused", lambda x, d, *r: pr.render_mpi_plane_sharded(
            mp, x, d, *r, slab_fn=make_fused_slab_renderer(with_disp=True), with_disp=True),
            *small, True, *cots)
        run("pipelined", lambda x, d, *r: pr.render_mpi_plane_sharded_pipelined(
            mp, x, d, *r, n_sub=2, with_disp=True), *small, True, *cots)
        run("pipelined_fused", lambda x, d, *r: pr.render_mpi_plane_sharded_pipelined(
            mp, x, d, *r, n_sub=2, slab_fn=make_fused_slab_renderer(with_disp=True),
            with_disp=True), *small, True, *cots)
    if world == 2:  # the banded route at 128^2 (tile bands exist from 128 pixels up)
        big = t["rgba_big"]
        geom_b = _geometry(big.shape[1])
        rays_b = _rays(t["yaws_big"], t["pitches_big"], big.shape[-1])
        v, n_l = big.shape[:2]
        flat = lambda a: a[:, None].expand(v, n_l, *a.shape[1:]).reshape(v * n_l, *a.shape[1:])  # noqa
        grid, _ = homography_grid(geom_b.dhw.repeat(v, 1), flat(rays_b[1]), flat(rays_b[0]),
                                  flat(rays_b[2]))
        bands = tuple(int(b) for b in required_bands(tuple(big.reshape(-1, *big.shape[2:]).shape),
                                                     grid))
        cots_b = (t["cot_big"], t["cot_d_big"])
        run("tile_banded", lambda x, d, *r: pr.render_mpi_tile_sharded(
            mt, x, d, *r, tiled_bands=bands), big, geom_b.dhw, rays_b, False, *cots_b)
        run("plane_banded", lambda x, d, *r: pr.render_mpi_plane_sharded(
            mp, x, d, *r, tiled_bands=bands), big, geom_b.dhw, rays_b, False, *cots_b)
        cases["bands"] = bands
    if world == 3:  # gather-and-fold (a group that is not a power of two)
        mp = make_mesh([3], ("plane",), device="cpu")
        run("plane", lambda x, d, *r: pr.render_mpi_plane_sharded(mp, x, d, *r, with_disp=True),
            t["rgba3"], _geometry(t["rgba3"].shape[1]).dhw, rays, True, *cots)
    if world == 4:
        m2 = make_mesh([2, 2], ("plane", "tile"), device="cpu")
        run("plane_tile", lambda x, d, *r: pr.render_mpi_plane_tile_sharded(
            m2, x, d, *r, with_disp=True), *small, True, *cots)
        run("plane_tile_fused", lambda x, d, *r: pr.render_mpi_plane_tile_sharded(
            m2, x, d, *r, slab_fn=make_fused_slab_renderer(with_disp=True), with_disp=True),
            *small, True, *cots)
    return cases


# -- job: the train step over a mesh ------------------------------------------------


def tiny_config(**train):
    """The tiny configuration of ``tests/test_torch_train_step.py`` (resolution
    16, 4 planes, width 32), with the sharded tests' settings: D frozen (Adam's
    first step is ``lr * sign(g)``, so rounding noise in a near-zero D
    gradient would move D and every later number) and worst views chosen at
    16^2 by the gather path in every layout.  ``resolution`` and ``n_planes``
    resize it (the JAX package's fused kernels need 128 pixels)."""
    import dataclasses

    from gmpi_tpu_torch import config as tcfg
    from gmpi_tpu_torch.core.poses import SphereCameraConfig

    batch = train.pop("batch_size", 4)
    mbstd = train.pop("mbstd_group_size", 2)
    res = train.pop("resolution", 16)
    n_planes = train.pop("n_planes", 4)
    cfg = tcfg.ExperimentConfig(
        name="tiny", resolution=16, fov_deg=12.6,
        camera=SphereCameraConfig(sphere_center_z=1.0, sphere_r=1.0, yaw_mean=0.0,
                                  yaw_std=0.289, pitch_mean=0.0, pitch_std=0.127),
        planes=tcfg.PlaneConfig(n_planes=n_planes, min_d=0.95, max_d=1.12),
        hparams=tcfg.StepHparams(batch_size=batch, img_size=16, tex_size=16, batch_split=1,
                                 gen_lr=0.002, disc_lr=0.002),
        train=tcfg.TrainHparams(**{**dict(z_dim=32, w_dim=32, n_view_per_z=2,
                                          worst_view_render_res=16, train_d=False,
                                          aug_with_lighting=False, lighting_start_iter=0,
                                          total_iters=10), **train}),
        model=tcfg.ModelPreset(channel_base=512, channel_max=32, num_bf16_res=0,
                               conv_clamp=None, gen_alpha_largest_res=16,
                               mbstd_group_size=mbstd))
    return dataclasses.replace(cfg, resolution=res, hparams=dataclasses.replace(
        cfg.hparams, img_size=res, tex_size=res))


# the layouts of the step tests: name -> (mesh axes, sizes, config overrides)
STEP_CASES = {
    2: {"plane": (("plane",), (2,), {}),
        "plane_fused_bf16": (("plane",), (2,), dict(use_fused_renderer=True,
                                                   fused_compute_dtype="bf16")),
        "tile_fused": (("tile",), (2,), dict(use_fused_renderer=True)),
        "data": (("data",), (2,), dict(batch_size=8, mbstd_group_size=4,
                                       aug_with_lighting=True, lighting_start_iter=-1))},
    4: {"plane_tile": (("plane", "tile"), (2, 2), {}),
        "plane_tile_fused": (("plane", "tile"), (2, 2), dict(use_fused_renderer=True))},
}


# the layouts held against the JAX package's step on the same mesh (the
# tests/_torch_jax_step.py reference): name -> (mesh axes, sizes, overrides);
# the fused fp32 layouts at 16^2 against the JAX step's gather route (the
# JAX kernels need 128 pixels), bf16 textures at 128^2 against its fused slab
JAX_CASES = {
    2: {"plane": STEP_CASES[2]["plane"],
        "tile_fused": STEP_CASES[2]["tile_fused"],
        "data": STEP_CASES[2]["data"],
        "plane_fused_bf16_128": (("plane",), (2,), dict(
            use_fused_renderer=True, fused_compute_dtype="bf16", resolution=128, n_planes=2,
            batch_size=2))},
    4: {"plane_tile": STEP_CASES[4]["plane_tile"],
        "plane_tile_fused": STEP_CASES[4]["plane_tile_fused"]},
}


def step_batch(cfg, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    bs, res = cfg.hparams.batch_size, cfg.hparams.img_size
    return (rng.uniform(-1, 1, (bs, 3, res, res)).astype(np.float32),
            rng.standard_normal((bs, 16)).astype(np.float32))


class inject_draws:
    """Hand a train step the random numbers of the JAX step
    (``tests/_torch_jax_step.jax_draws``): its z and camera and light angles
    (whole batch; the step keeps this rank's share), and constant synthesis
    noise.  A context manager; the draws must all be taken."""

    def __init__(self, step, draws):
        import torch

        from gmpi_tpu_torch.core import poses

        self.step, self.poses = step, poses
        self.z = [torch.tensor(np.asarray(z)) for z in draws["z"]]
        self.views = [tuple(torch.tensor(np.asarray(a)) for a in v) for v in draws["views"]]

    def _z(self, generator, n):
        z = self.z.pop(0)
        assert z.shape[0] == n * self.step.n_data, (z.shape, n)
        return z[self.step._data_share(n)] if self.step.n_data > 1 else z

    def _angles(self, generator, n, cfg, device="cuda"):
        yaws, pitches = self.views.pop(0)
        assert yaws.shape[0] == n, (yaws.shape, n)
        return yaws.to(device), pitches.to(device)

    def _synth(self, G, z, generator, noise_mode="random"):
        return self.synth(G, z, generator, "const")

    def __enter__(self):
        self.synth, self.sample = self.step.synth, self.poses.sample_yaw_pitch
        self.step._sample_z, self.step.synth = self._z, self._synth
        self.poses.sample_yaw_pitch = self._angles
        return self

    def __exit__(self, *exc):
        self.poses.sample_yaw_pitch = self.sample
        del self.step._sample_z, self.step.synth
        if exc[0] is None:
            assert not self.z and not self.views, "draws left over"


def run_step(cfg, mesh=None, seed=0, params=None, draws=None):
    """One step of a fresh state (weights from ``seed``, or ``params``: the
    state dicts of G and D, with both EMAs on G's parameters) on
    ``step_batch`` (this rank's share over a data axis), drawing from a
    generator or taking ``draws``: ``(state, metrics, grads)``."""
    import contextlib

    import torch

    from gmpi_tpu_torch.parallel.mesh import batch_share
    from gmpi_tpu_torch.train import init_train_state, make_train_step

    state = init_train_state(cfg, torch.Generator().manual_seed(seed), device="cpu")
    if params is not None:
        state.G.load_state_dict(params["G"], strict=True)
        state.D.load_state_dict(params["D"], strict=True)
        state.ema = {k: p.detach().clone() for k, p in state.G.named_parameters()}
        state.ema2 = {k: v.clone() for k, v in state.ema.items()}
    step = make_train_step(cfg, device="cpu", mesh=mesh, return_grads=True)
    real, pose = step_batch(cfg)
    share = batch_share(mesh, real.shape[0])
    with inject_draws(step, draws) if draws is not None else contextlib.nullcontext():
        _, metrics, grads = step(state, torch.from_numpy(real[share]),
                                 torch.from_numpy(pose[share]),
                                 torch.Generator().manual_seed(seed + 7))
    return state, {k: float(v) for k, v in metrics.items()}, grads


def step_record(state, metrics, grads):
    """What a step test compares: metrics, gradients, G's state and EMAs."""
    return {"metrics": metrics, "grads": grads,
            "G": {k: v.detach().clone() for k, v in state.G.state_dict().items()},
            "ema": dict(state.ema), "ema2": dict(state.ema2)}


def job_step(rank, world, work, inputs):
    """The step in every layout of ``STEP_CASES[world]``, a replica check
    after each (and one on a perturbed replica, which must raise), and over
    a data axis D's loss terms on given images (the minibatch std across
    ranks) with and without the cross-rank groups."""
    import torch

    from gmpi_tpu_torch.parallel.mesh import Mesh, batch_share, average_gradients
    from gmpi_tpu_torch.train import init_train_state, make_train_step
    from gmpi_tpu_torch.train.step import state_tensors
    from gmpi_tpu_torch.utils.inspect import check_replica_consistency

    out = {}
    for name, (axes, sizes, over) in STEP_CASES[world].items():
        cfg = tiny_config(**over)
        mesh = Mesh(sizes, axes, device="cpu")
        state, metrics, grads = run_step(cfg, mesh)
        check_replica_consistency(state_tensors(state), atol=0.0)
        out[name] = {"metrics": metrics, "grads": grads, "step": state.step,
                     "finite": all(bool(torch.isfinite(v).all())
                                   for v in state_tensors(state).values())}
    # from the JAX package's state, on its draws
    for name, (axes, sizes, over) in JAX_CASES[world].items():
        ref = torch.load(os.path.join(work, f"jax_{name}.pt"), weights_only=False)
        mesh = Mesh(sizes, axes, device="cpu")
        state, metrics, grads = run_step(tiny_config(**over), mesh, params=ref["params"],
                                         draws=ref["draws"])
        check_replica_consistency(state_tensors(state), atol=0.0)
        out["jax_" + name] = step_record(state, metrics, grads)
    # a perturbed replica is caught, on every rank
    state = init_train_state(tiny_config(), torch.Generator().manual_seed(0), device="cpu")
    if rank == world - 1:
        with torch.no_grad():
            state.D.b4.fc.bias[3] += 1e-3
    try:
        check_replica_consistency(state_tensors(state), atol=0.0)
        out["perturbed"] = "not caught"
    except AssertionError as e:
        out["perturbed"] = str(e)
    if world == 2:
        # D's loss terms on given global batches, this rank's share each, gradients averaged
        cfg = tiny_config(batch_size=8, mbstd_group_size=4)
        mesh = Mesh([2], ("data",), device="cpu")
        share = batch_share(mesh, 8)
        t = {k: torch.from_numpy(v) for k, v in inputs.items()}
        for name, m in (("d_terms", mesh), ("d_terms_local_mbstd", None)):
            state = init_train_state(cfg, device="cpu")
            state.D.load_state_dict(torch.load(os.path.join(work, "d_params.pt")))
            step = make_train_step(cfg, device="cpu", mesh=m)
            terms = step.d_loss_terms(state, t["real"][share], t["real_pose"][share],
                                      t["fake"][share], t["fake_pose"][share])
            sum(terms).backward()
            average_gradients(list(state.D.parameters()), mesh.world)
            vals = torch.stack([x.detach() for x in terms])
            torch.distributed.all_reduce(vals)
            out[name] = {"terms": (vals / 2).tolist(),
                         "grads": {k: p.grad.clone() for k, p in state.D.named_parameters()}}
    return out


# -- job: train_gmpi_torch.py --multihost ----------------------------------------------


def job_cli(rank, world, work, inputs):
    """``train_gmpi_torch.main --multihost`` on the tiny config: the process
    group's backend, the loader's shard, who wrote checkpoints, the replicas
    after training."""
    import torch
    import torch.distributed as dist

    import train_gmpi_torch
    from gmpi_tpu_torch.train import loop as loop_mod
    from gmpi_tpu_torch.train.step import state_tensors
    from gmpi_tpu_torch.data import loader as loader_mod

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    saves, shards = [], []
    real_save, real_init = loop_mod.save_checkpoint, loader_mod.ShardedLoader.__init__

    def counted_save(*a, **kw):
        saves.append(a[0])
        return real_save(*a, **kw)

    def recorded_init(self, *a, **kw):
        real_init(self, *a, **kw)
        shards.append((self.shard_id, self.num_shards, self.batch_size,
                       [int(i) for i in self._epoch_indices(0)]))

    backends, real_group = [], dist.init_process_group

    def recorded_group(backend=None, **kw):
        backends.append(backend)
        return real_group(backend, **kw)

    loop_mod.save_checkpoint = counted_save
    loader_mod.ShardedLoader.__init__ = recorded_init
    dist.init_process_group = recorded_group
    cfg = tiny_config(batch_size=4, mbstd_group_size=4, train_d=True)
    argv = [str(a) for a in inputs["argv"]]
    state = train_gmpi_torch.main(argv, cfg=cfg)
    dist.init_process_group = real_group
    # main() has closed its group: a fresh one for the replica check
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous_check", rank=rank,
                            world_size=world)
    from gmpi_tpu_torch.utils.inspect import check_replica_consistency

    check_replica_consistency(state_tensors(state), atol=0.0)
    digest = {k: v.detach().clone() for k, v in state.G.state_dict().items()}
    return {"saves": saves, "shards": shards, "step": state.step, "G": digest,
            "backends": backends}


JOBS = {"render": job_render, "step": job_step, "cli": job_cli}


def main() -> None:
    job, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    inputs_path = os.path.join(work, "inputs.npz")
    inputs = dict(np.load(inputs_path, allow_pickle=True)) if os.path.exists(inputs_path) else {}
    if job != "cli":  # main() of the CLI makes its own group from the environment
        dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                                world_size=world)
    try:
        result = JOBS[job](rank, world, work, inputs)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result["modules"] = sorted(m for m in ("jax", "gmpi_tpu") if m in sys.modules)
    torch.save(result, os.path.join(work, f"result_{rank}.pt"))


if __name__ == "__main__":
    main()
