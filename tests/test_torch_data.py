"""Port parity: the training data stack of ``gmpi_tpu_torch`` against ``gmpi_tpu``.

The same inputs through both packages' numpy/PIL code: pose conversion
(bitwise), ``yaw_pitch_from_w2c`` (1e-6: the JAX function computes in
float32 through ``jnp``), the three datasets on the fixtures of
``tests/test_data.py`` (images bitwise, poses 1e-6), the loader (the same
batches in the same order, bitwise, over two epochs), the native PNG decoder
(equal to PIL; its library under ``build/``), curriculum, TensorBoard event
bytes (equal), the eval metrics (1e-10) and preprocessing (equal files).
"""

import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from gmpi_tpu import curriculum as jax_curriculum
from gmpi_tpu.core.poses import yaw_pitch_from_w2c as jax_yaw_pitch_from_w2c
from gmpi_tpu.data import datasets as jax_datasets
from gmpi_tpu.data import pose_convert as jax_pose_convert
from gmpi_tpu.data import preprocess as jax_preprocess
from gmpi_tpu.data.loader import ShardedLoader as JaxShardedLoader
from gmpi_tpu.eval import metrics as jax_metrics
from gmpi_tpu.utils import tb_writer as jax_tb
from gmpi_tpu_torch import config as tcfg
from gmpi_tpu_torch import curriculum
from gmpi_tpu_torch.core.poses import yaw_pitch_from_w2c
from gmpi_tpu_torch.data import datasets, fastpng, pose_convert, preprocess
from gmpi_tpu_torch.data.loader import ShardedLoader
from gmpi_tpu_torch.eval import metrics
from gmpi_tpu_torch.utils import tb_writer
from tests.test_data import _write_mat, ffhq_fixture  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny ops: with several test workers on one machine, PyTorch's
    per-process thread pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _angles_trans(seed, n=6):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((n, 3)) * 0.3).astype(np.float32),
            (rng.standard_normal((n, 3)) * 0.1).astype(np.float32))


def _c2w(seed, n=4):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        c2w[i, :3, :3] = Rotation.random(random_state=int(rng.integers(1 << 30))).as_matrix()
        c2w[i, :3, 3] = rng.standard_normal(3) * 2.0 + np.array([0, 0, 3.0])
    return c2w


# -- pose conversion ------------------------------------------------------------------


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("center,radius", [(1.0, 1.0), (2.7, 2.7)])
def test_pose_convert_is_bitwise_the_jax_packages(normalize, center, radius):
    angles, trans = _angles_trans(0)
    np.testing.assert_array_equal(
        pose_convert.w2c_from_deep3dface(angles, trans, center, radius, normalize),
        jax_pose_convert.w2c_from_deep3dface(angles, trans, center, radius, normalize))
    c2w = _c2w(1)
    np.testing.assert_array_equal(
        pose_convert.w2c_from_pnp_c2w(c2w, center, radius, normalize),
        jax_pose_convert.w2c_from_pnp_c2w(c2w, center, radius, normalize))
    for a, b in zip(pose_convert.deep3dface_yaw_pitch(angles),
                    jax_pose_convert.deep3dface_yaw_pitch(angles)):
        np.testing.assert_array_equal(a, b)


def test_yaw_pitch_from_w2c_matches_jax():
    w2c = pose_convert.w2c_from_pnp_c2w(_c2w(2, n=8), 2.7, 2.7)
    center = np.array([0.0, 0.0, 2.7], np.float32)
    yaw, pitch = yaw_pitch_from_w2c(torch.from_numpy(w2c), torch.from_numpy(center))
    yaw_j, pitch_j = jax_yaw_pitch_from_w2c(jnp.asarray(w2c), jnp.asarray(center))
    assert yaw.shape == pitch.shape == (8, 1)
    np.testing.assert_allclose(yaw.numpy(), np.asarray(yaw_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pitch.numpy(), np.asarray(pitch_j), rtol=0, atol=1e-6)


# -- datasets ---------------------------------------------------------------------------


def _assert_samples_equal(ds, ds_j):
    assert len(ds) == len(ds_j)
    for i in range(len(ds)):
        ours, theirs = ds[i], ds_j[i]
        np.testing.assert_array_equal(ours[0], theirs[0])  # image, bitwise
        assert ours[0].dtype == np.float32
        for a, b in zip(ours[1:], theirs[1:]):  # flat pose, yaw, pitch
            assert np.shape(a) == np.shape(b)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("img_size,pose_dim", [(16, 16), (32, 9)])
def test_ffhq_samples_match_jax(ffhq_fixture, img_size, pose_dim):  # noqa: F811
    zpath, pose_dir = ffhq_fixture
    kw = dict(dataset_path=zpath, raw_img_size=32, img_size=img_size, pose_data_path=pose_dir,
              sphere_center=1.0, sphere_r=1.0, flat_pose_dim=pose_dim)
    ds = datasets.get_dataset("FFHQ", **kw)
    assert len(ds) == 5  # 6 minus the fail-listed one
    _assert_samples_equal(ds, jax_datasets.get_dataset("FFHQ", **kw))


def test_metfaces_samples_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    img_dir, pose_dir = tmp_path / "imgs", tmp_path / "poses"
    img_dir.mkdir()
    (pose_dir / "coeffs").mkdir(parents=True)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
            img_dir / f"m{i}.png")
        _write_mat(pose_dir / "coeffs" / f"m{i}.mat", rng)
    (pose_dir / "fail_list.txt").write_text("m1.png\n")
    kw = dict(dataset_path=str(img_dir), raw_img_size=32, img_size=16,
              pose_data_path=str(pose_dir), sphere_center=1.0, flat_pose_dim=9)
    ds = datasets.MetFaces(**kw)
    assert len(ds) == 2
    _assert_samples_equal(ds, jax_datasets.MetFaces(**kw))


def test_afhq_samples_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    img_dir = tmp_path / "afhq"
    img_dir.mkdir()
    labels = []
    for i, c2w in enumerate(_c2w(3, n=4)):
        name = f"cat{i}.png"
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(img_dir / name)
        labels.append([name, list(c2w.reshape(-1).astype(float)) + [0.0] * 9])
    (img_dir / "dataset.json").write_text(json.dumps({"labels": labels}))
    kw = dict(dataset_path=str(img_dir), raw_img_size=32, img_size=32,
              pose_data_path=str(img_dir), sphere_center=2.7, sphere_r=2.7, flat_pose_dim=16)
    _assert_samples_equal(datasets.AFHQCat(**kw), jax_datasets.AFHQCat(**kw))


def test_dataset_rejects_a_wrong_raw_size(ffhq_fixture):  # noqa: F811
    zpath, pose_dir = ffhq_fixture
    ds = datasets.FFHQ(zpath, 64, 16, pose_dir, sphere_center=1.0)
    with pytest.raises(ValueError, match="raw size"):
        ds[0]


# -- loader -----------------------------------------------------------------------------


@pytest.mark.parametrize("num_shards", [1, 2])
def test_loader_yields_the_jax_loaders_batches_in_order(ffhq_fixture, num_shards):  # noqa: F811
    zpath, pose_dir = ffhq_fixture
    kw = dict(dataset_path=zpath, raw_img_size=32, img_size=16, pose_data_path=pose_dir,
              sphere_center=1.0, flat_pose_dim=16)
    ds, ds_j = datasets.FFHQ(**kw), jax_datasets.FFHQ(**kw)
    for shard in range(num_shards):
        lkw = dict(batch_size=2, shard_id=shard, num_shards=num_shards, seed=7, num_workers=2)
        ours, theirs = ShardedLoader(ds, **lkw), JaxShardedLoader(ds_j, **lkw)
        n_per_epoch = len(list(ours.epoch(0)))
        assert n_per_epoch == (5 + num_shards - 1) // num_shards // 2
        stream, stream_j = iter(ours), iter(theirs)
        batches = [next(stream) for _ in range(2 * n_per_epoch)]  # two epochs
        batches_j = [next(stream_j) for _ in range(2 * n_per_epoch)]
        for b, b_j in zip(batches, batches_j):
            assert len(b) == len(b_j) == 4
            for f, f_j in zip(b, b_j):
                np.testing.assert_array_equal(f, f_j)
        # the two epochs are shuffled differently
        assert not np.array_equal(batches[0][0], batches[n_per_epoch][0])
        idx = ours._epoch_indices(1)
        np.testing.assert_array_equal(idx, theirs._epoch_indices(1))


def test_loader_without_drop_last_keeps_the_ragged_batch(ffhq_fixture):  # noqa: F811
    zpath, pose_dir = ffhq_fixture
    ds = datasets.FFHQ(zpath, 32, 16, pose_dir, sphere_center=1.0)
    batches = list(ShardedLoader(ds, batch_size=2, drop_last=False, shuffle=False).epoch(0))
    assert [len(b[0]) for b in batches] == [2, 2, 1]
    with pytest.raises(ValueError):
        ShardedLoader(ds, batch_size=2, shard_id=2, num_shards=2)


# -- native PNG decoder --------------------------------------------------------------------


def test_fastpng_builds_under_build_not_native():
    path = fastpng.library_path()
    assert path.parent == fastpng.BUILD_DIR
    assert os.path.commonpath([str(path), REPO]) == REPO
    assert os.path.relpath(str(path), REPO).split(os.sep)[:2] == ["build", "gmpi_tpu_torch"]
    if not fastpng.available():
        pytest.skip(f"native toolchain unavailable: {fastpng.build_log()}")
    assert path.exists()


def test_fastpng_decode_matches_pil():
    if not fastpng.available():
        pytest.skip(f"native toolchain unavailable: {fastpng.build_log()}")
    rng = np.random.default_rng(0)
    for shape in [(33, 47, 3), (16, 16, 4), (21, 9, 3)]:
        arr = rng.integers(0, 255, shape, dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr, "RGBA" if shape[2] == 4 else "RGB").save(buf, format="PNG")
        out = fastpng.decode(buf.getvalue())
        assert out is not None
        np.testing.assert_array_equal(out, arr)
        np.testing.assert_array_equal(out, np.asarray(Image.open(io.BytesIO(buf.getvalue()))))
    img = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
    want = ((img.reshape(8, 4, 8, 4, 3).astype(np.uint32).sum(axis=(1, 3)) + 8) // 16)
    np.testing.assert_array_equal(fastpng.box_downscale(img, 4), want.astype(np.uint8))
    assert fastpng.box_downscale(img, 5) is None


def test_decodes_are_counted_by_decoder(ffhq_fixture):  # noqa: F811
    zpath, pose_dir = ffhq_fixture
    ds = datasets.FFHQ(zpath, 32, 16, pose_dir, sphere_center=1.0)
    before = dict(datasets.DECODES)
    ds[0]
    ds[1]
    added = {k: datasets.DECODES[k] - before[k] for k in before}
    assert sum(added.values()) == 2
    assert added["fastpng" if fastpng.available() else "pil"] == 2


# -- curriculum ---------------------------------------------------------------------------


SCHEDULE = {0: {"batch_size": 8, "img_size": 64}, 1000: {"batch_size": 4, "gen_lr": 1e-3},
            2500: {"disc_lr": 5e-4}, "lr": 0.002, "r1_lambda": 10.0}


def test_curriculum_matches_jax():
    ours = curriculum.from_reference_style(SCHEDULE)
    theirs = jax_curriculum.from_reference_style(SCHEDULE)
    assert ours.stage_boundaries() == theirs.stage_boundaries() == [0, 1000, 2500]
    for step in (0, 1, 999, 1000, 2499, 2500, 10 ** 6):
        assert ours.at_step(step) == theirs.at_step(step)
        assert ours.next_upsample_step(step) == theirs.next_upsample_step(step)
        assert ours.last_upsample_step(step) == theirs.last_upsample_step(step)


def test_apply_to_config_matches_jax():
    from gmpi_tpu.config import get_config as jax_get_config

    entry = {"batch_size": 4, "batch_split": 2, "gen_lr": 1e-3, "disc_lr": 5e-4, "lr": 1.0}
    ours = curriculum.apply_to_config(tcfg.get_config("FFHQ256"), entry)
    theirs = jax_curriculum.apply_to_config(jax_get_config("FFHQ256"), entry)
    assert ours.hparams == tcfg.StepHparams(**vars(theirs.hparams))
    cfg = tcfg.get_config("FFHQ256")
    assert curriculum.apply_to_config(cfg, {"r1_lambda": 1.0}) is cfg
    with pytest.raises(NotImplementedError):
        curriculum.apply_to_config(cfg, {"img_size": 128})


# -- TensorBoard event files ----------------------------------------------------------------


def test_tb_event_bytes_equal_the_jax_writers():
    scalars = {"d_loss": 1.25, "g_loss": -0.5, "steps_per_s": 3.0e-7, "r1": float("inf")}
    for step, wall in ((0, 1.5e9), (12345, 1.7e9 + 0.125), (2 ** 40, 0.0)):
        ours = tb_writer.encode_scalar_event(step, wall, scalars)
        assert ours == jax_tb.encode_scalar_event(step, wall, scalars)
        assert tb_writer.frame_record(ours) == jax_tb.frame_record(ours)
    assert tb_writer.encode_file_version(1.5e9) == jax_tb.encode_file_version(1.5e9)
    for data in (b"", b"a", b"123456789", bytes(range(256))):
        assert tb_writer.crc32c(data) == jax_tb.crc32c(data)
    assert tb_writer.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def test_tb_files_read_back_in_both_packages(tmp_path):
    w = tb_writer.SummaryWriter(str(tmp_path))
    w.add_scalars_dict({"a": 1.0, "b": 2.5}, 3)
    w.add_scalar("a", -4.0, 7)
    w.close()
    want = [(3, {"a": 1.0, "b": 2.5}), (7, {"a": -4.0})]
    assert tb_writer.read_events(w.path) == jax_tb.read_events(w.path) == want


# -- eval metrics ---------------------------------------------------------------------------


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    f1 = rng.standard_normal((64, 8))
    f2 = rng.standard_normal((48, 8)) * 1.3 + 0.2
    ours, theirs = metrics.fid_from_features(f1, f2), jax_metrics.fid_from_features(f1, f2)
    assert ours > 0
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-10)
    kid = metrics.kid_from_features(f1, f2, subset_size=16, n_subsets=10, seed=3)
    np.testing.assert_allclose(
        kid, jax_metrics.kid_from_features(f1, f2, subset_size=16, n_subsets=10, seed=3),
        rtol=0, atol=1e-10)
    depth = rng.uniform(0.9, 1.2, (16, 16))
    depth[0, :4] = 0.0
    pred, mask = rng.uniform(0.5, 2.0, (16, 16)), (rng.uniform(size=(16, 16)) > 0.3)
    pairs = [
        (metrics.normalized_depth_error(depth, pred, mask.astype(np.int64)),
         jax_metrics.normalized_depth_error(depth, pred, mask.astype(np.int64))),
        (metrics.angle_error(np.array([0.1, -0.2]), np.array([0.12, 0.19, 0.01])),
         jax_metrics.angle_error(np.array([0.1, -0.2]), np.array([0.12, 0.19, 0.01]))),
        (metrics.cosine_similarity(f1[0], f2[0]), jax_metrics.cosine_similarity(f1[0], f2[0])),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


# -- preprocessing --------------------------------------------------------------------------


def _detect(arr):
    """A stub 5-point detector: none on dark images, else fixed landmarks."""
    if arr.mean() < 100:
        return None
    return np.array([[3.0, 4.0], [10.0, 4.5], [7.0, 8.0], [4.0, 12.0], [10.5, 12.25]])


def test_preprocess_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    src = tmp_path / "src"
    src.mkdir()
    for i in range(4):
        lo = 0 if i % 2 else 128
        Image.fromarray(rng.integers(lo, lo + 100, (16, 16, 3), dtype=np.uint8)).save(
            src / f"{i:02d}.png")
    zpath = tmp_path / "src.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        for name in sorted(os.listdir(src)):
            zf.write(src / name, name)
    assert preprocess.xflip_augment_folder(str(src), str(tmp_path / "a")) == \
        jax_preprocess.xflip_augment_folder(str(src), str(tmp_path / "b")) == 8
    for name in sorted(os.listdir(tmp_path / "a")):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a" / name)),
                                      np.asarray(Image.open(tmp_path / "b" / name)))
    for path in (str(src), str(zpath)):
        ours = preprocess.prepare_landmarks(path, str(tmp_path / "la"), detect_fn=_detect)
        theirs = jax_preprocess.prepare_landmarks(path, str(tmp_path / "lb"), detect_fn=_detect)
        assert ours == theirs == (2, 2)
        names = sorted(os.listdir(tmp_path / "la"))
        assert names == sorted(os.listdir(tmp_path / "lb"))
        for name in names:
            assert (tmp_path / "la" / name).read_text() == (tmp_path / "lb" / name).read_text()
    # without mtcnn or facenet_pytorch both packages raise the adapter's ImportError
    for pkg in (preprocess, jax_preprocess):
        with pytest.raises(ImportError, match="mtcnn"):
            pkg.default_detector()
