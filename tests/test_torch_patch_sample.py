"""The tap sampler of the tile-banded warp (``ops/patch_sample.py``, K8), on the CPU.

``csrc/patch_sample.cu`` cannot run here; its plain version
``sample_patches_ref`` repeats the kernel's arithmetic and is what the tiled
warp's taps route runs on CPU tensors, where autograd records nothing through
the warp.  After ``gather_patches_ref`` it must give the hats route's samples
(the warp under autograd, :func:`hats`) within 1e-6 of max|samples|: both are
the same bilinear sum in fp32, the hats with two nonzeros per row, summed in
another order.  Bands too small for the grid drop the same taps on both
routes (exactly zero where no tap is left), and ``check=True`` still poisons
such a render.  The kernel itself is held against this plain version at the
serving shapes by the ``gpu`` tests of ``tests/test_torch_cuda.py``; the JAX
package's tiled warp holds the taps in ``tests/test_torch_tiled_warp.py``.
"""

import pytest
import torch

from gmpi_tpu_torch.ops import patch_sample as ps
from gmpi_tpu_torch.ops import tiled_warp as tw
from gmpi_tpu_torch.ops.patch_gather import gather_patches_ref

TOL = 1e-6  # of max|samples|


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
    """``tw.grid_sample_tiled`` on its hats route, reached as a caller reaches
    it: autograd records through the texture."""
    with torch.enable_grad():
        return tw.grid_sample_tiled(tex.detach().requires_grad_(), grid, *args, **kw).detach()


def _count_ref(monkeypatch):
    """Count the plain tap sampler's calls (the kernel route on CPU tensors)."""
    calls, ref = [], ps.sample_patches_ref
    monkeypatch.setattr(ps, "sample_patches_ref",
                        lambda *a, **k: calls.append(a[0].shape) or ref(*a, **k))
    return calls


@pytest.mark.parametrize("row_scan", [False, True], ids=["one_step", "row_scan"])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("tile,out_hw,tex_hw", [((8, 64), (32, 64), (40, 56)),
                                                ((8, 128), (24, 128), (48, 96)),
                                                ((1, 40), (12, 40), (20, 36))],
                         ids=["8x64", "8x128", "1xW"])
def test_taps_from_plain_patches_equal_the_hat_contractions(monkeypatch, tile, out_hw, tex_hw,
                                                            c, row_scan):
    tex, grid = _scene(3, c, tex_hw, out_hw, seed=sum(out_hw) + c)
    by, bx = tw.required_bands(tex.shape, grid, tile=tile)
    calls = _count_ref(monkeypatch)
    kw = dict(tile=tile, row_scan=row_scan, rows_per_step=2)
    taps = tw.grid_sample_tiled(tex, grid, by, bx, **kw)
    nty, g = out_hw[0] // tile[0], 2
    while nty % g:
        g -= 1
    steps = nty // g if row_scan else 1
    assert len(calls) == steps and ps.LAUNCHES["patch_sample"] == 0
    hats_out = hats(tex, grid, by, bx, **kw)
    assert len(calls) == steps  # no tap on the hats
    assert taps.shape == hats_out.shape == (3, c, *out_hw) and taps.dtype == torch.float32
    assert float(hats_out.abs().max()) > 0.5
    assert float((taps - hats_out).abs().max()) <= TOL * float(hats_out.abs().max())


ROUTE_CASES = {"plain": "taps", "no_grad": "taps", "texture": "hats", "grid": "hats",
               "bf16": "hats", "adjoint": "taps"}


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_the_warp_picks_its_route(monkeypatch, case):
    """The taps where autograd records nothing through the warp and no
    ``compute_dtype`` is asked for (a plain call; a texture that requires a
    gradient under ``torch.no_grad()``; the forward of the warp with the
    tiled adjoint, whatever its inputs); the hats where autograd records
    through the texture or the grid, or in bf16.  Each route is called once,
    and the other not at all."""
    from gmpi_tpu_torch.ops import tiled_warp_adjoint as ta

    tex, grid = _scene(2, 4, (40, 56), (32, 64), seed=17)
    by, bx = tw.required_bands(tex.shape, grid)
    taken = []
    for name in ("_sample_taps", "_sample_hats"):
        monkeypatch.setattr(tw, name, lambda *a, fn=getattr(tw, name), name=name, **k:
                            taken.append(name[len("_sample_"):]) or fn(*a, **k))
    ref = hats(tex, grid, by, bx)
    del taken[:]
    if case == "no_grad":
        with torch.no_grad():
            out = tw.grid_sample_tiled(tex.requires_grad_(), grid, by, bx)
    elif case in ("texture", "grid"):
        (tex if case == "texture" else grid).requires_grad_()
        out = tw.grid_sample_tiled(tex, grid, by, bx)
        assert out.requires_grad
    elif case == "adjoint":
        adj = ta.required_output_bands(tex.shape, grid, tile=tw.tiling(40, 56).adjoint_tile)
        out = tw.make_tiled_warp_with_adjoint(by, bx, adj)(tex.requires_grad_(), grid)
        (d_tex,) = torch.autograd.grad(out.sum(), tex)
        assert float(d_tex.abs().max()) > 0
    else:
        dtype = torch.bfloat16 if case == "bf16" else None
        out = tw.grid_sample_tiled(tex, grid, by, bx, compute_dtype=dtype)
    assert taken == [ROUTE_CASES[case]]
    tol = 2e-2 if case == "bf16" else TOL * float(ref.abs().max())
    assert float((out.detach() - ref).abs().max()) <= tol


def test_sample_patches_ref_writes_its_tiles_only():
    """Straight after ``gather_patches_ref``, a call for tiles 3..6 of a 4 x 2
    tiling writes those tiles' pixels (equal to the hats' there) and leaves
    every other pixel as it was."""
    tex, grid = _scene(2, 4, (40, 56), (32, 64), seed=11)
    tile = (8, 32)
    by, bx = tw.required_bands(tex.shape, grid, tile=tile)
    hats_out = hats(tex, grid, by, bx, tile=tile)
    fx_t, fy_t, nty, ntx = tw._tile_coords(tex.shape, grid, True, tile)
    texl = torch.nn.functional.pad(tex.permute(0, 3, 2, 1), (0, 0, by, by, bx, bx)).reshape(
        2, 56 + 2 * bx, (40 + 2 * by) * 4)
    fx_g = fx_t.reshape(2, nty * ntx, *tile)[:, 3:7]
    fy_g = fy_t.reshape(2, nty * ntx, *tile)[:, 3:7]
    x_lo = torch.clamp(torch.floor(fx_g.amin(dim=(2, 3))).int() - 1 + bx, 0, 56 + bx)
    y_lo = torch.clamp(torch.floor(fy_g.amin(dim=(2, 3))).int() - 1 + by, 0, 40 + by)
    offs = torch.stack([x_lo, y_lo * 4], -1)
    pm = gather_patches_ref(texl, offs, bx, by * 4)
    fx, fy = (f.transpose(2, 3).reshape(2, 32, 64) for f in (fx_t, fy_t))
    out = torch.full((2, 4, 32, 64), float("nan"))
    assert ps.sample_patches(pm, offs, fx, fy, (by, bx), tile, out, first_tile=3) is out
    written = torch.zeros((4, 2), dtype=torch.bool)
    written.view(-1)[3:7] = True
    written = written.repeat_interleave(8, 0).repeat_interleave(32, 1)  # [32, 64]
    assert not torch.isnan(out[..., written]).any() and torch.isnan(out[..., ~written]).all()
    assert float((out - hats_out)[..., written].abs().max()) <= TOL * float(hats_out.abs().max())


@pytest.mark.parametrize("short", [(2, 0), (0, 20), (4, 30)], ids=["rows", "columns", "both"])
def test_bands_too_small_give_the_hats_result_and_check_poisons(short):
    """With bands short of the grid's spans (``check=False``) both routes drop
    the same taps: the same samples, exactly zero where every tap is dropped;
    ``check=True`` NaN-poisons the whole render on both."""
    tex, grid = _scene(3, 4, (40, 56), (32, 64), seed=5)
    by, bx = tw.required_bands(tex.shape, grid, tile=(8, 64))
    bands = (by - short[0], bx - short[1])
    taps = tw.grid_sample_tiled(tex, grid, *bands, tile=(8, 64))
    hats_out = hats(tex, grid, *bands, tile=(8, 64))
    full = hats(tex, grid, by, bx, tile=(8, 64))
    assert not torch.equal(hats_out, full)  # taps were dropped
    assert float((taps - hats_out).abs().max()) <= TOL * float(hats_out.abs().max())
    assert torch.equal(taps[hats_out == 0], torch.zeros_like(taps[hats_out == 0]))
    for route in (tw.grid_sample_tiled, hats):
        out = route(tex, grid, *bands, tile=(8, 64), check=True)
        assert torch.isnan(out).all()
    ok = tw.grid_sample_tiled(tex, grid, by, bx, tile=(8, 64), check=True)
    assert float((ok - full).abs().max()) <= TOL * float(full.abs().max())


@pytest.mark.parametrize("budget,groups", [(6, [(6, 4)]), (2, [(2, 4)] * 3), (0, [(1, 1)] * 6)],
                         ids=["one group", "three groups", "one row a step"])
def test_tap_route_steps_hold_patches_and_padded_copies_under_step_bytes(monkeypatch, budget,
                                                                          groups):
    """On the taps route a step's budget counts each texture's padded
    copy and its tile rows' patches (no hats): ``budget`` textures' worth a
    step gives equal groups of at most that many (0: one byte, so one
    texture and one tile row a step), each bitwise the ungrouped warp."""
    tex, grid = _scene(6, 4, (40, 56), (32, 64), seed=13)
    by, bx = tw.required_bands(tex.shape, grid, tile=(8, 64))
    whole = tw.grid_sample_tiled(tex, grid, by, bx, tile=(8, 64))
    per_texture = 4 * 4 * (bx * by * 4) + 4 * (56 + 2 * bx) * (40 + 2 * by) * 4
    seen, warp = [], tw._warp_textures
    monkeypatch.setattr(tw, "_warp_textures",
                        lambda tx, *a: seen.append((len(tx), a[4])) or warp(tx, *a))
    out = tw.grid_sample_tiled(tex, grid, by, bx, tile=(8, 64),
                               step_bytes=max(1, budget * per_texture))
    assert seen == groups
    assert torch.equal(out, whole)


def test_a_nan_coordinate_samples_nan_as_through_the_hats():
    tex, grid = _scene(2, 4, (40, 56), (32, 64), seed=7)
    by, bx = tw.required_bands(tex.shape, grid, tile=(8, 64))
    grid[1, 5, 9, 0] = float("nan")
    taps = tw.grid_sample_tiled(tex, grid, by, bx, tile=(8, 64))
    nan = torch.isnan(taps)
    assert nan[1, :, 5, 9].all() and int(nan.sum()) == 4
    assert torch.equal(nan, torch.isnan(hats(tex, grid, by, bx, tile=(8, 64))))


def _args():
    tex, grid = _scene(1, 4, (40, 56), (16, 64), seed=3)
    fx_t, fy_t, nty, ntx = tw._tile_coords(tex.shape, grid, True, (8, 64))
    fx, fy = (f.transpose(2, 3).reshape(1, 16, 64) for f in (fx_t, fy_t))
    pm = torch.rand((1, 2, 12, 40))
    offs = torch.zeros((1, 2, 2), dtype=torch.int32)
    return dict(patches=pm, offs=offs, fx=fx, fy=fy, pad=(4, 4), tile=(8, 64),
                out=torch.empty((1, 4, 16, 64)))


@pytest.mark.parametrize("bad,error,match", [
    (dict(patches=torch.rand((1, 2, 12, 40), requires_grad=True)), RuntimeError, "no gradient"),
    (dict(fx="grad"), RuntimeError, "no gradient"),
    (dict(patches=torch.rand((1, 2, 12, 40), dtype=torch.float64)), TypeError, "float32"),
    (dict(out=torch.empty((1, 4, 16, 64), dtype=torch.bfloat16)), TypeError, "float32"),
    (dict(patches=torch.rand((1, 3, 12, 40))), ValueError, "offs"),
    (dict(patches=torch.rand((1, 2, 12, 42))), ValueError, "do not fit"),
    (dict(out=torch.empty((1, 4, 16, 32))), ValueError, "do not match"),
    (dict(offs=torch.zeros((1, 2, 2), dtype=torch.int64)), ValueError, "int32"),
    (dict(tile=(8, 48)), ValueError, "do not fit"),
    (dict(first_tile=1), ValueError, "tiling"),
    (dict(patches=torch.rand((1, 2, 40, 12)).transpose(2, 3)), ValueError, "contiguous"),
], ids=["patch grad", "coordinate grad", "patch dtype", "out dtype", "patch count",
        "channels", "output shape", "offs dtype", "tile", "tile range", "strides"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, error, match):
    args = _args()
    if bad.get("fx") == "grad":
        bad = dict(fx=args["fx"].clone().requires_grad_())
    args.update(bad)
    with pytest.raises(error, match=match):
        ps.sample_patches(**args)
    if "grad" in match:
        with torch.no_grad():
            ps.sample_patches(**args)
