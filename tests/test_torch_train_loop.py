"""Port parity and behaviour: checkpoints, warm start, the training loop and
its CLI (``train_gmpi_torch.py``) of ``gmpi_tpu_torch``.

The tiny config of ``tests/test_train.py`` (resolution 16, 4 planes, width
32) on the CPU.  Against the JAX package: ``.npz`` exports read both ways
(arrays equal; a JAX export loads strictly into the port's G, whose MPI then
matches the JAX generator's within 1e-4 x max|ref|) and the warm start's
partial copy (the same copied and missing keys as JAX's converter; copied
values equal).  The port alone: checkpoint round trips (bitwise), pruning,
the CLI end to end with resume, a two-stage curriculum (batch size and every
Adam group's ``lr`` change at the boundary), snapshots that leave the live G
alone, and the FID hook (equal to ``fid_from_features`` on the same fakes).
No JAX training loop runs here.
"""

import io
import os
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import train_gmpi_torch
from gmpi_tpu.eval.generate import generate_mpi as jax_generate_mpi
from gmpi_tpu.models import converter as jax_converter
from gmpi_tpu.train import checkpoint as jax_checkpoint
from gmpi_tpu_torch.curriculum import Curriculum
from gmpi_tpu_torch.eval.generate import generate_mpi
from gmpi_tpu_torch.eval.harness import FakeImageGenerator
from gmpi_tpu_torch.eval.metrics import fid_from_features
from gmpi_tpu_torch.models import converter
from gmpi_tpu_torch.models.discriminator import Discriminator
from gmpi_tpu_torch.models.generator import Generator
from gmpi_tpu_torch.train import checkpoint, init_train_state, make_train_step
from gmpi_tpu_torch.train import loop as loop_mod
from gmpi_tpu_torch.train.loop import LoopStats, compute_training_fid, save_snapshot_grid, train
from gmpi_tpu_torch.utils.inspect import param_summary
from tests.test_torch_train_step import _batch, tiny_config
from tests.test_train import tiny_config as jax_tiny_config

REL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny ops: with several test workers on one machine, PyTorch's
    per-process thread pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stepped_state(cfg, n_steps=1, seed=0):
    """A tiny state after ``n_steps`` steps (Adam moments and EMAs non-trivial)."""
    state = init_train_state(cfg, torch.Generator().manual_seed(seed), device="cpu")
    step = make_train_step(cfg, device="cpu")
    real, pose = _batch()
    rng = torch.Generator().manual_seed(seed + 1)
    for _ in range(n_steps):
        step(state, torch.from_numpy(real), torch.from_numpy(pose), rng)
    return state


def _assert_tree_equal(a, b, what):
    """Nested dicts/lists of tensors and numbers, bitwise."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, what
        assert torch.equal(a.cpu(), b.cpu()), what
    elif isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


# -- checkpoints ------------------------------------------------------------------------


def test_checkpoint_round_trip_is_bitwise_and_prunes(tmp_path):
    cfg = tiny_config()
    state = _stepped_state(cfg, n_steps=2)
    base = str(tmp_path / "ckpt")
    os.makedirs(base)
    saved = {}
    for _ in range(5):  # steps 2..6; keep_last 3
        path = checkpoint.save_checkpoint(base, state)
        assert os.path.basename(path) == f"step_{state.step:08d}"
        saved[state.step] = torch.load(os.path.join(path, checkpoint.STATE_FILE),
                                       weights_only=True)
        state.step += 1
    assert sorted(d for d in os.listdir(base) if d.startswith("step_")) == [
        "step_00000004", "step_00000005", "step_00000006"]
    assert open(os.path.join(base, "latest")).read() == "step_00000006"

    fresh = init_train_state(cfg, torch.Generator().manual_seed(99), device="cpu")
    loaded = checkpoint.load_checkpoint(base, fresh)
    assert loaded is fresh and loaded.step == 6
    _assert_tree_equal(checkpoint.state_payload(loaded), saved[6], "latest")
    # the loaded optimizers step as a fresh one does: step counts on the host
    for opt in (loaded.opt_g, loaded.opt_d):
        assert all(s["step"].device.type == "cpu" for s in opt.state.values())
    older = checkpoint.load_checkpoint(
        base, init_train_state(cfg, torch.Generator().manual_seed(5), device="cpu"), step=4)
    assert older.step == 4
    # every tensor of the state equals the live one that was saved
    state.step = 6
    _assert_tree_equal(checkpoint.state_payload(loaded), checkpoint.state_payload(state), "live")
    # and the loaded state trains on
    make_train_step(cfg, device="cpu")(loaded, *map(torch.from_numpy, _batch()),
                                       torch.Generator().manual_seed(3))
    assert loaded.step == 7


def test_config_snapshot(tmp_path):
    checkpoint.save_config_snapshot(str(tmp_path), tiny_config())
    text = (tmp_path / "config.json").read_text()
    assert '"name": "tiny"' in text and '"n_planes": 4' in text


# -- .npz exports between the packages ------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tiny_state():
    """JAX-initialized G and D trees of the tiny config, with numpy draws in
    the leaves that init leaves constant."""
    cfg_j = jax_tiny_config()
    params_g, buffers_g = jax.jit(cfg_j.generator_cfg().init)(jax.random.key(0))
    params_d = jax.jit(cfg_j.discriminator_cfg().init)(jax.random.key(1))
    rng = np.random.default_rng(0)

    def perturb(path, x):
        x = np.asarray(x)
        if str(path[-1].key).startswith("bias") or str(path[-1].key) in ("noise_strength",
                                                                          "w_avg"):
            return (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    trees = [jax.tree_util.tree_map_with_path(perturb, t) for t in (params_g, buffers_g, params_d)]
    return (cfg_j, *trees)


def test_port_export_reads_in_jax(tmp_path):
    cfg = tiny_config()
    g = Generator(cfg.generator_cfg(), generator=torch.Generator().manual_seed(1))
    params, buffers = converter.module_trees(g)
    path = str(tmp_path / "g.npz")
    checkpoint.export_torch_style(path, params, buffers)
    params_j, buffers_j = jax_checkpoint.load_torch_style(path)
    sd_j = jax_converter.tree_to_state_dict(params_j, buffers_j)
    assert sorted(sd_j) == sorted(g.state_dict())
    for k, v in g.state_dict().items():
        np.testing.assert_array_equal(sd_j[k], v.numpy())
    # and back through the port
    p2, b2 = checkpoint.load_torch_style(path)
    assert set(p2) == set(params) and set(b2) == set(buffers)
    for k in params:
        assert torch.equal(p2[k], params[k])


def test_jax_export_loads_strictly_and_generates_as_jax(tmp_path, jax_tiny_state):
    cfg_j, params_g, buffers_g, params_d = jax_tiny_state
    cfg = tiny_config()
    path_g, path_d = str(tmp_path / "g.npz"), str(tmp_path / "d.npz")
    jax_checkpoint.export_torch_style(path_g, params_g, buffers_g)
    jax_checkpoint.export_torch_style(path_d, params_d, {})
    params, buffers = checkpoint.load_torch_style(path_g)
    g = Generator(cfg.generator_cfg())
    g.load_state_dict({**params, **buffers}, strict=True)
    d_params, d_buffers = checkpoint.load_torch_style(path_d)
    assert not d_buffers
    Discriminator(cfg.discriminator_cfg()).load_state_dict(d_params, strict=True)

    geom_j = cfg_j.plane_geometry()
    geom_t = cfg.plane_geometry(device="cpu")
    z = np.random.default_rng(3).standard_normal((2, 32)).astype(np.float32)
    n = cfg.planes.n_planes
    ref = np.asarray(jax.jit(lambda p, b, z: jax_generate_mpi(
        cfg_j.generator_cfg(), p, b, z, cfg_j.multi_res_xyz(geom_j), n))(
        params_g, buffers_g, jnp.asarray(z)))
    with torch.no_grad():
        out = generate_mpi(g.eval(), torch.from_numpy(z), cfg.multi_res_xyz(geom_t), n).numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= REL_TOL * np.max(np.abs(ref))
    # the parameter counts the loop prints agree with the JAX summary's
    from gmpi_tpu.utils.inspect import param_summary as jax_param_summary
    assert param_summary(g)[1] == jax_param_summary(params_g)[1]
    rows, _ = param_summary(params)
    assert [r[0] for r in rows] == [r[0] for r in jax_param_summary(params_g)[0]]


# -- warm start ------------------------------------------------------------------------------


def _partial(sd, drop=("toalpha", "mapping.fc1")):
    """A vanilla-StyleGAN2-like state dict: some heads missing, one extra key."""
    out = {k: v for k, v in sd.items() if not any(d in k for d in drop)}
    out["synthesis.b16.torgba.weight"] = np.ones((4, 32, 1, 1), np.float32)
    return out


def test_warm_start_copies_what_matches_like_jax(jax_tiny_state):
    cfg_j, params_g, buffers_g, params_d = jax_tiny_state
    cfg = tiny_config()
    sd = _partial(jax_converter.tree_to_state_dict(params_g, buffers_g))
    params, buffers = converter.convert_generator_checkpoint(
        sd, cfg.generator_cfg(), warm_start=True, generator=torch.Generator().manual_seed(4))
    init_p, init_b = converter.module_trees(
        Generator(cfg.generator_cfg(), generator=torch.Generator().manual_seed(4)))

    # the same missing keys as the JAX package's merge on its own init trees
    p0_j, b0_j = params_g, buffers_g  # JAX init trees: only their keys and shapes matter
    conv_p_j, conv_b_j = jax_converter.convert_state_dict(sd)
    _, miss_p_j = jax_converter.merge_converted(p0_j, conv_p_j, require_all=False)
    _, miss_b_j = jax_converter.merge_converted(b0_j, conv_b_j, require_all=False)
    conv_p, conv_b = converter.convert_state_dict(sd)
    _, miss_p = converter.merge_converted(init_p, conv_p, require_all=False)
    _, miss_b = converter.merge_converted(init_b, conv_b, require_all=False)
    assert sorted(miss_p) == sorted(".".join(p) for p in miss_p_j)
    assert sorted(miss_b) == sorted(".".join(p) for p in miss_b_j)
    assert miss_p and any("toalpha" in k for k in miss_p)
    for k, v in {**params, **buffers}.items():
        want = init_p.get(k, init_b.get(k)) if k in miss_p + miss_b else torch.from_numpy(np.array(sd[k]))
        assert torch.equal(v, want), k
    g = Generator(cfg.generator_cfg())
    g.load_state_dict({**params, **buffers}, strict=True)

    d = converter.convert_discriminator_checkpoint(
        _partial(jax_converter.tree_to_state_dict(params_d), drop=("b4.out",)),
        cfg.discriminator_cfg(), warm_start=True, generator=torch.Generator().manual_seed(5))
    Discriminator(cfg.discriminator_cfg()).load_state_dict(d, strict=True)

    with pytest.raises(KeyError):  # without warm_start every key is required
        converter.convert_generator_checkpoint(sd, cfg.generator_cfg())
    bad = dict(sd)
    bad["mapping.fc0.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="mapping.fc0.weight"):
        converter.convert_generator_checkpoint(bad, cfg.generator_cfg(), warm_start=True)
    merged, _ = converter.merge_converted(init_p, converter.convert_state_dict(bad)[0],
                                          require_all=False, strict_shapes=False)
    assert torch.equal(merged["mapping.fc0.weight"], init_p["mapping.fc0.weight"])


def test_load_torch_checkpoint(tmp_path):
    g = Generator(tiny_config().generator_cfg())
    for obj in (g.state_dict(), {"state_dict": g.state_dict(), "step": 3}):
        torch.save(obj, tmp_path / "g.pth")
        sd = converter.load_torch_checkpoint(str(tmp_path / "g.pth"))
        assert sorted(sd) == sorted(g.state_dict())
        assert all(isinstance(v, np.ndarray) for v in sd.values())


# -- the CLI end to end ----------------------------------------------------------------------


def _ffhq16(root, n=7, seed=0):
    """An FFHQ-style dataset at 16^2: PNGs in a zip, Deep3DFace .mat files,
    one image fail-listed."""
    import scipy.io as sio

    rng = np.random.default_rng(seed)
    os.makedirs(root / "coeffs")
    with zipfile.ZipFile(root / "imgs.zip", "w") as zf:
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
                buf, format="PNG")
            zf.writestr(f"{i:05d}.png", buf.getvalue())
            sio.savemat(root / "coeffs" / f"{i:05d}.mat", {
                "angle": (rng.standard_normal((1, 3)) * 0.2).astype(np.float32),
                "trans": (rng.standard_normal((1, 3)) * 0.1).astype(np.float32)})
    (root / "coeffs" / "fail_list.txt").write_text("00002.png\n")
    return ["--dataset", "FFHQ256", "--data_root", str(root / "imgs.zip"),
            "--pose_root", str(root / "coeffs")]


def test_cli_trains_snapshots_checkpoints_and_resumes(tmp_path):
    from gmpi_tpu_torch.utils.tb_writer import read_events

    data = _ffhq16(tmp_path)
    out = str(tmp_path / "run")
    args = data + ["--output_dir", out, "--device", "cpu", "--seed", "3"]
    stats = LoopStats()
    state = train_gmpi_torch.main(args + ["--total_iters", "3", "--sample_interval", "2",
                                          "--model_save_interval", "2"],
                                  cfg=tiny_config(), stats=stats)
    assert state.step == 3 and stats.start_step == 0 and stats.end_step == 3
    assert len(stats.data_wait_ms) == len(stats.step_ms) == 3
    assert stats.snapshot_steps == [2] and len(stats.save_bytes) == 2  # step 2, final
    assert sorted(os.listdir(out)) == ["checkpoints", "config.json", "metrics.jsonl", "snaps",
                                       "tensorboard"]
    assert sorted(os.listdir(os.path.join(out, "snaps"))) == [
        "mpi_00000002_alpha.png", "mpi_00000002_rgb.png", "snap_00000002_ema.png",
        "snap_00000002_raw.png"]
    lines = open(os.path.join(out, "metrics.jsonl")).read().splitlines()
    assert len(lines) == 1 and '"d_loss"' in lines[0] and '"steps_per_s"' in lines[0]
    tb_dir = os.path.join(out, "tensorboard")
    events = read_events(os.path.join(tb_dir, os.listdir(tb_dir)[0]))
    assert events[0][0] == 0 and "g_loss" in events[0][1]
    assert open(os.path.join(out, "checkpoints", "latest")).read() == "step_00000003"

    stats2 = LoopStats()
    state2 = train_gmpi_torch.main(args + ["--total_iters", "5"], cfg=tiny_config(),
                                   stats=stats2)
    assert stats2.start_step == 3 and state2.step == 5 and len(stats2.step_ms) == 2
    assert stats2.load_bytes == stats.save_bytes[-1] and stats2.load_s > 0
    assert open(os.path.join(out, "checkpoints", "latest")).read() == "step_00000005"
    for p in state2.G.parameters():
        assert torch.isfinite(p).all()


def test_cli_warm_start_and_refusals(tmp_path):
    cfg = tiny_config()
    data = _ffhq16(tmp_path)
    g = Generator(cfg.generator_cfg(), generator=torch.Generator().manual_seed(11))
    d = Discriminator(cfg.discriminator_cfg(), generator=torch.Generator().manual_seed(12))
    checkpoint.export_torch_style(str(tmp_path / "g.npz"), *converter.module_trees(g))
    checkpoint.export_torch_style(str(tmp_path / "d.npz"), *converter.module_trees(d))
    args = data + ["--output_dir", str(tmp_path / "run"), "--device", "cpu"]
    state = train_gmpi_torch.main(args + ["--total_iters", "0", "--warm_start",
                                          str(tmp_path / "g.npz"), "--warm_start_d",
                                          str(tmp_path / "d.npz")], cfg=cfg)
    assert state.step == 0
    for mine, theirs in ((state.G, g), (state.D, d)):
        _assert_tree_equal(mine.state_dict(), theirs.state_dict(), "warm start")
    for ema in (state.ema, state.ema2):
        _assert_tree_equal(ema, dict(g.named_parameters()), "ema")

    with pytest.raises(FileNotFoundError, match="x.npz"):  # --inception_weights is read
        train_gmpi_torch.main(args + ["--inception_weights", "x.npz"], cfg=cfg)
    for extra in (["--multihost"], ["--renderer_plane_shards", "2"]):
        with pytest.raises(NotImplementedError, match="A9"):
            train_gmpi_torch.main(args + extra, cfg=cfg)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            train_gmpi_torch.main(data + ["--output_dir", str(tmp_path / "x")], cfg=cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            train(cfg, iter([]), str(tmp_path / "y"))
        with pytest.raises(RuntimeError, match="cuda"):
            init_train_state(cfg)


# -- curriculum, snapshots, FID ---------------------------------------------------------


def test_curriculum_changes_batch_size_and_every_adam_lr(tmp_path):
    cfg = tiny_config()
    cur = Curriculum(schedule={0: {"batch_size": 4, "gen_lr": 2e-3, "disc_lr": 3e-3},
                               3: {"batch_size": 2, "gen_lr": 1e-3, "disc_lr": 5e-4}})
    sizes, lrs = [], {}

    def make_batches(entry):
        rng = np.random.default_rng(0)
        while True:
            sizes.append(entry["batch_size"])
            b = entry["batch_size"]
            yield (rng.uniform(-1, 1, (b, 3, 16, 16)).astype(np.float32),
                   rng.standard_normal((b, 16)).astype(np.float32))

    def record(out_dir, stage_cfg, state, step):  # runs after each step > 0
        lrs[step] = ([g["lr"] for g in state.opt_g.param_groups],
                     [g["lr"] for g in state.opt_d.param_groups], stage_cfg.hparams.batch_size)

    state = train(cfg, make_batches(cur.at_step(0)), str(tmp_path / "run"), total_iters=5,
                  sample_interval=1, model_save_interval=100, curriculum=cur,
                  rebuild_batches=make_batches, seed=0, snapshot_fn=record, device="cpu")
    assert state.step == 5
    assert sizes == [4, 4, 4, 2, 2]
    mult = cfg.train.mapping_lr_mult
    assert lrs[2] == ([2e-3 * mult, 2e-3], [3e-3], 4)
    assert lrs[3] == lrs[4] == ([1e-3 * mult, 1e-3], [5e-4], 2)


@pytest.mark.parametrize("training", [True, False])
def test_snapshot_leaves_the_live_generator_alone(tmp_path, training):
    cfg = tiny_config()
    state = _stepped_state(cfg)
    state.G.train(training)
    gen = torch.Generator().manual_seed(6)
    state.ema = {k: v + 0.1 * torch.randn(v.shape, generator=gen) for k, v in state.ema.items()}
    before = {k: v.clone() for k, v in state.G.state_dict().items()}
    save_snapshot_grid(str(tmp_path), cfg, state, 7, n_imgs=2)
    assert state.G.training is training
    assert all(m.training is training for m in state.G.modules())
    _assert_tree_equal(state.G.state_dict(), before, "G")
    grid = np.asarray(Image.open(tmp_path / "snap_00000007_ema.png"))
    assert grid.shape == (3 * 16, 2 * 16, 3)
    # the EMA grid renders the (perturbed) EMA weights, the raw one G's
    raw = np.asarray(Image.open(tmp_path / "snap_00000007_raw.png"))
    assert not np.array_equal(grid, raw)


def test_fid_hook_equals_fid_from_features():
    cfg = tiny_config()
    state = _stepped_state(cfg)
    reals = np.random.default_rng(0).uniform(-1, 1, (6, 3, 16, 16)).astype(np.float32)
    seen = []

    def features(images):
        seen.append(images)
        flat = images.reshape(len(images), -1)
        return np.stack([flat.mean(1), flat.std(1), flat[:, ::7].mean(1)], axis=1)

    fid = compute_training_fid(cfg, state, features, reals, batch=4)
    fakes, reals01 = seen
    assert fakes.shape == (6, 3, 16, 16) and fakes.min() >= 0 and fakes.max() <= 1
    np.testing.assert_array_equal(reals01, ((reals + 1) / 2).clip(0, 1))
    # the same fakes, made by hand from the EMA weights
    g = loop_mod._generator_copy(state, state.ema)
    gen = FakeImageGenerator(cfg, g, n_planes=cfg.planes.n_planes, img_size=16, device="cpu")
    want = []
    for i, b in ((0, 4), (4, 2)):
        imgs, _ = gen.render(gen.sample_mpi(seed=i, batch=b), *gen.sample_views(seed=i, n_views=b))
        want.append(((imgs.numpy() + 1) / 2).clip(0, 1))
    np.testing.assert_array_equal(fakes, np.concatenate(want))
    assert fid == fid_from_features(features(fakes), features(reals01))
