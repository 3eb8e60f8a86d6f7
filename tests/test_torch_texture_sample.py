"""The tile-banded warp's taps read from the texture itself (``ops/texture_sample.py``, K10).

On the CPU: ``texture_sample_ref``, K10's plain version and what the warp's
taps route runs on CPU tensors, must be bitwise ``patch_taps``, the way the
route computed the same samples before K10 (a zero-padded x-major copy, K7's
patches by ``gather_patches_ref`` and K8's taps by ``sample_patches_ref``):
in every channel count, tiling, step and texture grouping, at the texture's
edges and in its zero padding, with bands too short for the grid (taps
dropped) and with NaN coordinates.  The route itself must match the hats
(the warp under autograd) and ``grid_sample_bilinear`` within the fp32
tolerances of ``tests/test_torch_patch_sample.py``.

On the card (``gpu``; without one these skip): the kernel is bitwise K7 + K8
at both banded cells' shapes and past 2^31 texture elements, and eval's
banded render launches it once a render and launches neither K7 nor K8.
Imports only torch and the port:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_texture_sample.py
"""

import dataclasses
import types

import pytest
import torch

from gmpi_tpu_torch.ops import patch_gather as pg
from gmpi_tpu_torch.ops import patch_sample as ps
from gmpi_tpu_torch.ops import texture_sample as ts
from gmpi_tpu_torch.ops import tiled_warp as tw
from gmpi_tpu_torch.ops.grid_sample import grid_sample_bilinear

TOL = 1e-6  # of max|samples|, the taps against the hats (the same sum in another order)
# absolute, against F.grid_sample, which rounds the texel coordinate its own way: at 200
# texels an ulp of the coordinate is 1.5e-5 of a texel, and a tap pair's values differ by up
# to 1 (the hats sit as far off)
GATHER_TOL = 4e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(n, c, tex_hw, out_hw, seed):
    """Seeded textures ``[n, c, *tex_hw]`` and homography grids ``[n, *out_hw,
    2]``: a perspective warp near the identity per texture, reaching past the
    texture's edge."""
    g = torch.Generator().manual_seed(seed)
    tex = torch.rand((n, c, *tex_hw), generator=g)
    ho, wo = out_hw
    v, u = torch.meshgrid(torch.linspace(-1.1, 1.1, ho), torch.linspace(-1.1, 1.1, wo),
                          indexing="ij")
    pts = torch.stack([u, v, torch.ones_like(u)], -1).reshape(-1, 3)  # [P, 3]
    hom = torch.eye(3) + torch.cat([0.15 * torch.randn((n, 2, 3), generator=g),
                                    0.08 * torch.randn((n, 1, 3), generator=g)], 1)
    hom[:, 2, 2] = 1.0
    xyw = torch.einsum("nij,pj->npi", hom, pts)
    return tex, (xyw[..., :2] / xyw[..., 2:]).reshape(n, ho, wo, 2).contiguous()


def hats(tex, grid, *args, **kw):
    """``tw.grid_sample_tiled`` on its hats route: autograd records through
    the texture."""
    with torch.enable_grad():
        return tw.grid_sample_tiled(tex.detach().requires_grad_(), grid, *args, **kw).detach()


def _inputs(tex, grid, bands, tile=None):
    """K10's inputs as the warp's taps route makes them: the tile, the band
    origins and the coordinates ``[N, Ho, Wo]``."""
    tile = tile or tw.tiling(grid.shape[1], grid.shape[2]).tile
    fx_t, fy_t, nty, ntx = tw._tile_coords(tex.shape, grid, True, tile)
    n = tex.shape[0]
    fx, fy = (f.transpose(2, 3).reshape(n, *grid.shape[1:3]).contiguous() for f in (fx_t, fy_t))
    return tile, ts.band_origins(fx, fy, bands, tile, *tex.shape[2:]), fx, fy


# (output, texture) sizes; the tiling is the warp's rule: 8 x 256, 8 x 128, and the ragged
# fall-back of one row by the width
SHAPES = {"8x256": ((16, 256), (40, 200)), "8x128": ((24, 128), (48, 96)),
          "1xW": ((12, 40), (20, 36))}
# the band cases: the grid's own spans reaching past the texture's edge (taps in the zero
# padding); bands short of them (taps dropped); NaN coordinates; the grid shifted far past
# the texture's edges (every band origin clamped, no tap inside)
CASES = ("edges", "short", "nan", "outside")


def _case(case, c, shape, seed):
    out_hw, tex_hw = SHAPES[shape]
    tex, grid = _scene(3, c, tex_hw, out_hw, seed)
    by, bx = tw.required_bands(tex.shape, grid)
    if case == "outside":  # the same spans, shifted far past each edge
        grid = grid + torch.tensor([[-5.0, -5.0], [5.0, 5.0], [5.0, -5.0]])[:, None, None]
    if case == "short":
        by, bx = max(2, by - 3), max(2, bx - 9)
    if case == "nan":
        grid[1, 5, 9, 0] = float("nan")
        grid[2, 0, :7, 1] = float("nan")
    return tex, grid, (by, bx)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_is_bitwise_the_patches_and_their_taps(shape, c, case):
    """K10's plain version against K7's and K8's plain versions over the
    padded x-major copy: bitwise in one step over all tile rows, in steps of
    one tile row (the row scan), and with the textures in groups."""
    tex, grid, bands = _case(case, c, shape, seed=len(shape) + 7 * c + len(case))
    tile, origins, fx, fy = _inputs(tex, grid, bands)
    got = ts.texture_sample(tex, origins, fx, fy, bands, tile)
    assert got.shape == (3, c, *grid.shape[1:3]) and got.dtype == torch.float32
    nty = grid.shape[1] // tile[0]
    for rows in (nty, 1):
        assert torch.equal(got.nan_to_num(7.0),
                           ts.patch_taps(tex, origins, fx, fy, bands, tile, rows).nan_to_num(7.0))
    groups = torch.cat([ts.patch_taps(tex[i:j], origins[i:j], fx[i:j], fy[i:j], bands, tile, 2)
                        for i, j in ((0, 2), (2, 3))])
    assert torch.equal(got.nan_to_num(7.0), groups.nan_to_num(7.0))
    if case == "nan":
        assert int(torch.isnan(got).sum()) == c * (1 + 7)
    else:
        assert not torch.isnan(got).any()
    largest = float(got.nan_to_num(0.0).abs().max())
    assert largest == 0.0 if case == "outside" else largest > 0.5


@pytest.mark.parametrize("case", CASES)
def test_band_origins_are_the_patch_starts_less_the_padding(case):
    """``band_origins`` over all tiles at once gives, for each tile row, the
    clamped patch starts of the old route's tile-row steps less the padding
    (by a band on each side), NaN tiles included."""
    tex, grid, (by, bx) = _case(case, 4, "8x128", seed=3)
    tile, origins, _, _ = _inputs(tex, grid, (by, bx))
    fx_t, fy_t, nty, ntx = tw._tile_coords(tex.shape, grid, True, tile)
    h, w = tex.shape[2:]
    for r in range(nty):
        fx_r, fy_r = fx_t[:, r], fy_t[:, r]  # [N, ntx, tile_r, tile_c]
        y_lo = torch.floor(fy_r.amin(dim=(2, 3))).to(torch.int32) - 1
        x_lo = torch.floor(fx_r.amin(dim=(2, 3))).to(torch.int32) - 1
        y_c = torch.clamp(y_lo + by, 0, h + 2 * by - by)
        x_c = torch.clamp(x_lo + bx, 0, w + 2 * bx - bx)
        assert torch.equal(origins[:, r * ntx:(r + 1) * ntx], torch.stack([x_c - bx, y_c - by], -1))


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_taps_route_matches_the_hats_and_grid_sample(shape, c, monkeypatch):
    """``grid_sample_tiled`` where autograd records nothing: one call of K10's
    plain version, none of K7's or K8's, within ``TOL`` of max|samples| of
    the hats and within ``GATHER_TOL`` of ``grid_sample_bilinear``, whatever
    the step budget and row scan it is handed (the taps hold no step)."""
    out_hw, tex_hw = SHAPES[shape]
    tex, grid = _scene(3, c, tex_hw, out_hw, seed=11 * c + len(shape))
    by, bx = tw.required_bands(tex.shape, grid)
    calls = {"texture_sample_ref": 0, "gather_patches_ref": 0, "sample_patches_ref": 0}
    for mod, name in ((ts, "texture_sample_ref"), (pg, "gather_patches_ref"),
                      (ps, "sample_patches_ref")):
        monkeypatch.setattr(mod, name, lambda *a, fn=getattr(mod, name), name=name, **k:
                            calls.__setitem__(name, calls[name] + 1) or fn(*a, **k))
    before = dict(ts.LAUNCHES)
    taps = tw.grid_sample_tiled(tex, grid, by, bx)
    assert calls == {"texture_sample_ref": 1, "gather_patches_ref": 0, "sample_patches_ref": 0}
    assert ts.LAUNCHES == before  # CPU tensors launch nothing
    for kw in (dict(row_scan=True, rows_per_step=1), dict(step_bytes=1)):
        assert torch.equal(tw.grid_sample_tiled(tex, grid, by, bx, **kw), taps)
    hats_out = hats(tex, grid, by, bx)
    assert float(hats_out.abs().max()) > 0.5
    assert float((taps - hats_out).abs().max()) <= TOL * float(hats_out.abs().max())
    gather = grid_sample_bilinear(tex, grid)
    assert float((taps - gather).abs().max()) <= GATHER_TOL


def _args():
    tex, grid = _scene(1, 4, (40, 56), (16, 64), seed=3)
    tile, origins, fx, fy = _inputs(tex, grid, (12, 40), (8, 64))
    return dict(tex=tex, origins=origins, fx=fx, fy=fy, bands=(12, 40), tile=(8, 64))


@pytest.mark.parametrize("bad,error,match", [
    (dict(tex=torch.rand((1, 4, 40, 56), requires_grad=True)), RuntimeError, "no gradient"),
    (dict(fx="grad"), RuntimeError, "no gradient"),
    (dict(tex=torch.rand((1, 4, 40, 56), dtype=torch.float64)), TypeError, "float32"),
    (dict(fy=torch.rand((1, 16, 64), dtype=torch.bfloat16)), TypeError, "float32"),
    (dict(origins=torch.zeros((1, 3, 2), dtype=torch.int32)), ValueError, "origins"),
    (dict(origins=torch.zeros((1, 2, 2), dtype=torch.int64)), ValueError, "int32"),
    (dict(fy=torch.rand((1, 16, 32))), ValueError, "do not match"),
    (dict(tile=(8, 48)), ValueError, "multiple of the tile"),
    (dict(bands=(0, 40)), ValueError, "bands"),
    (dict(tex=torch.rand((1, 4, 56, 40)).transpose(2, 3)), ValueError, "contiguous"),
], ids=["texture grad", "coordinate grad", "texture dtype", "coordinate dtype",
        "tile count", "origins dtype", "coordinate shape", "tile", "bands", "strides"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, error, match):
    args = _args()
    if bad.get("fx") == "grad":
        bad = dict(fx=args["fx"].clone().requires_grad_())
    args.update(bad)
    with pytest.raises(error, match=match):
        ts.texture_sample(**args)
    if "grad" in match:
        with torch.no_grad():
            ts.texture_sample(**args)


# --- on the card ----------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_scene(dev, preset, n_planes, res, sigmas, seed, n_tex=None):
    """Textures and the eval grids of ``n_planes`` planes of ``preset`` seen
    from the pose ``sigmas`` standard deviations off the camera's mean (yaw,
    pitch), as the banded render makes them; ``n_tex`` textures repeat the
    planes' grids."""
    from gmpi_tpu_torch.config import get_config
    from gmpi_tpu_torch.core import camera as cam
    from gmpi_tpu_torch.core import poses
    from gmpi_tpu_torch.core.renderer import homography_grid

    cfg = get_config(preset)
    cfg = dataclasses.replace(cfg, planes=dataclasses.replace(cfg.planes, n_planes=n_planes))
    yaw, pitch = (s * d for s, d in zip(sigmas, (cfg.camera.yaw_std, cfg.camera.pitch_std)))
    c2w, _, _ = poses.sample_sphere_poses(None, 1, cfg.camera, given_yaws=[[yaw]],
                                          given_pitches=[[pitch]], device=dev)
    ray_dir, eye, z_dir = cam.generate_rays(cam.intrinsics_from_fov(cfg.fov_deg, res, res), c2w)
    grid, _ = homography_grid(cfg.plane_geometry(device=dev).dhw, eye.expand(n_planes, 3),
                              ray_dir.expand(n_planes, -1, -1, -1), z_dir.expand(n_planes, 3))
    n_tex = n_tex or n_planes
    grid = grid.repeat(-(-n_tex // n_planes), 1, 1, 1)[:n_tex].contiguous()
    tex = torch.rand((n_tex, 4, res, res), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(seed))
    return tex, grid


# the banded cells' shapes: (preset, planes, resolution, bands (y, x)); MetFaces at 1024^2
# with its planned bands, FFHQ256 with its
CARD_SHAPES = {"ffhq256": ("FFHQ256", 96, 256, (96, 376)),
               "metfaces1024": ("MetFaces", 96, 1024, (128, 472))}


@pytest.mark.gpu
@pytest.mark.parametrize("sigmas", [(2.0, 2.0), (-1.0, 0.5)], ids=["corner", "inside"])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_is_bitwise_k7_and_k8_on_the_card(cuda, shape, sigmas):
    """K10 against K7 + K8 (``patch_taps``, two tile rows a step) at the
    banded cells' shapes: bitwise, one launch; and against its plain version
    on the first 4 textures within 1e-4 of max|plain| (FMA contraction)."""
    preset, n_planes, res, bands = CARD_SHAPES[shape]
    tex, grid = _card_scene(cuda, preset, n_planes, res, sigmas, seed=5)
    tile, origins, fx, fy = _inputs(tex, grid, bands)
    before = dict(ts.LAUNCHES)
    got = ts.texture_sample(tex, origins, fx, fy, bands, tile)
    torch.cuda.synchronize()
    assert ts.LAUNCHES["texture_sample"] == before["texture_sample"] + 1
    want = ts.patch_taps(tex, origins, fx, fy, bands, tile, 2)
    torch.cuda.synchronize()
    assert ts.LAUNCHES["patch_gather"] > before["patch_gather"]  # the yardstick ran the kernels
    assert torch.equal(got, want)
    plain = ts.texture_sample_ref(tex[:4], origins[:4], fx[:4], fy[:4], bands, tile)
    assert float((got[:4] - plain).abs().max()) <= 1e-4 * float(plain.abs().max())


@pytest.mark.gpu
def test_kernel_is_bitwise_k7_and_k8_on_the_card_at_the_edges(cuda):
    """The CPU cases on the card: C of 1, 3 and 4, the ragged tiles, short
    bands, NaN coordinates and a grid far outside, bitwise K7 + K8 (NaN where
    they give NaN)."""
    for shape in SHAPES:
        for c in (1, 3, 4):
            for case in CASES:
                tex, grid, bands = _case(case, c, shape, seed=len(shape) + 7 * c + len(case))
                tex, grid = tex.to(cuda), grid.to(cuda)
                tile, origins, fx, fy = _inputs(tex, grid, bands)
                got = ts.texture_sample(tex, origins, fx, fy, bands, tile)
                want = ts.patch_taps(tex, origins, fx, fy, bands, tile, 1)
                assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0)), (shape, c, case)
                assert torch.equal(torch.isnan(got), torch.isnan(want))


@pytest.mark.gpu
def test_kernel_past_two_to_the_31_elements(cuda):
    """512 textures of 1024^2 (2^31 elements; FFHQ1024's worst-view
    candidates) in one launch: the last 8 textures, whose elements lie past
    2^31, bitwise K7 + K8 on those textures alone, as are the first 8."""
    tex, grid = _card_scene(cuda, "FFHQ1024", 96, 1024, (2.0, 2.0), seed=9, n_tex=512)
    assert tex.numel() >= 2 ** 31
    bands = (128, 472)
    tile, origins, fx, fy = _inputs(tex, grid, bands)
    del grid
    got = ts.texture_sample(tex, origins, fx, fy, bands, tile)
    for part in (slice(0, 8), slice(504, 512)):
        want = ts.patch_taps(tex[part], origins[part].contiguous(), fx[part], fy[part], bands,
                             tile, 2)
        assert torch.equal(got[part], want)


@pytest.mark.gpu
@pytest.mark.parametrize("preset,res", [("FFHQ256", 256), ("MetFaces", 1024)])
def test_eval_banded_render_launches_k10_alone(cuda, preset, res):
    """``FakeImageGenerator.render`` on eval's default (banded) route, 96
    planes, one view: one K10 launch a render (its one texture group), no K7
    or K8; within 5e-4 of the gather renderer; ``render_mpi_chunked`` in 4
    slabs launches K10 once a slab."""
    from gmpi_tpu_torch.config import get_config
    from gmpi_tpu_torch.core import camera as cam
    from gmpi_tpu_torch.core.bands import bands_for_config
    from gmpi_tpu_torch.core.renderer import render_mpi, render_mpi_chunked
    from gmpi_tpu_torch.eval.harness import FakeImageGenerator

    cfg = get_config(preset)
    eval_cfg = dataclasses.replace(cfg, planes=dataclasses.replace(cfg.planes, n_planes=96))
    gen = types.SimpleNamespace(
        cfg=cfg, device=cuda, geom=eval_cfg.plane_geometry(device=cuda), use_fused=False,
        intr=cam.intrinsics_from_fov(cfg.fov_deg, res, res),
        tiled_bands=bands_for_config(cfg, img_size=res, n_planes=96, device=cuda))
    mpi = torch.rand((1, 96, 4, res, res), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(2))
    yaws, pitches = [[2 * cfg.camera.yaw_std]], [[-cfg.camera.pitch_std]]
    before = dict(ts.LAUNCHES)
    color, _ = FakeImageGenerator.render(gen, mpi, yaws, pitches)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in ts.LAUNCHES.items() if v != before[k]} == {
        "texture_sample": 1}
    gen.tiled_bands = None
    gather, _ = FakeImageGenerator.render(gen, mpi, yaws, pitches)
    assert float((color - gather).abs().max()) <= 5e-4
    from gmpi_tpu_torch.core import poses
    c2w, _, _ = poses.sample_sphere_poses(None, 1, cfg.camera, given_yaws=yaws,
                                          given_pitches=pitches, device=cuda)
    rays = cam.generate_rays(gen.intr, c2w)
    bands = bands_for_config(cfg, img_size=res, n_planes=96, device=cuda)
    before = dict(ts.LAUNCHES)
    chunked = render_mpi_chunked(mpi, gen.geom.dhw, *rays, 24, tiled_bands=bands)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in ts.LAUNCHES.items() if v != before[k]} == {
        "texture_sample": 4}
    whole = render_mpi(mpi, gen.geom.dhw, *rays, tiled_bands=bands)
    assert float((chunked.color - whole.color).abs().max()) <= 5e-4
