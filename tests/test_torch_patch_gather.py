"""The patch-gather kernel's launch geometry and copy schedule, on the CPU.

``csrc/patch_gather.cu`` cannot run here, so what surrounds its copy is held
in Python: :func:`launch_geometry` (the row chunks, the boxes across a row,
the TMA or loop path by shape), the jobs the kernel walks and the copy each
job makes (a box loaded with zeros past the texture, stored clipped at the
patch's edge).  The copy repeated job by job must equal
``gather_patches_ref`` and the JAX package's Pallas kernel in interpret mode
bitwise (it is a copy): fp32 and bf16, 16-byte aligned and unaligned starts,
rows wider than one TMA box, chunks that do not divide the band, bands of one
row, one patch, and pitches that send a shape to the loop path.  Keep the
Python repeat in step with the kernel; the kernel itself is held at these
edges and at its extreme geometries by the ``gpu`` tests of
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmpi_tpu.ops.pallas_patch import gather_patches as jax_gather_patches
from gmpi_tpu_torch.ops import patch_gather as pg

# (n, t, wp, hpc, band_x, band_yc, dtype, start step in elements)
CASES = {
    "f32 aligned": (2, 6, 48, 640, 20, 128, "float32", 4),
    "f32 unaligned": (2, 6, 48, 640, 20, 128, "float32", 1),
    "f32 row of two boxes": (2, 4, 40, 1200, 29, 416, "float32", 4),
    "f32 row of three boxes": (2, 3, 20, 1200, 7, 600, "float32", 4),
    "f32 ragged chunks": (1, 5, 90, 264, 67, 260, "float32", 1),
    "f32 bands of one row": (2, 4, 10, 640, 1, 128, "float32", 1),
    "bf16 aligned": (2, 6, 48, 640, 20, 128, "bfloat16", 8),
    "bf16 odd start": (2, 6, 40, 1200, 29, 416, "bfloat16", 4),
    "bf16 unaligned": (2, 6, 40, 1200, 29, 416, "bfloat16", 1),
    "bf16 row of three boxes": (2, 3, 20, 1400, 7, 640, "bfloat16", 4),
    "bf16 ragged chunks": (1, 5, 90, 264, 67, 264, "bfloat16", 1),
    "one patch": (1, 1, 30, 520, 30, 520, "float32", 1),
    "loop, f32 odd pitch": (2, 5, 37, 91, 7, 13, "float32", 1),
    "loop, bf16 odd padded height": (2, 5, 30, 4 * 35, 9, 4 * 12, "bfloat16", 4),
    "loop, bf16 odd band": (2, 5, 30, 4 * 36, 9, 4 * 13, "bfloat16", 4),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed=0):
    n, t, wp, hpc, band_x, band_yc, dtype, step = CASES[case]
    rng = np.random.default_rng(seed)
    texf = rng.standard_normal((n, wp, hpc)).astype(np.float32)
    offs = np.stack([rng.integers(0, wp - band_x + 1, (n, t)),
                     rng.integers(0, (hpc - band_yc) // step + 1, (n, t)) * step], -1)
    offs[0, 0] = (0, 0)  # both corners of the texture
    offs[-1, -1] = (wp - band_x, (hpc - band_yc) // step * step)
    return texf, offs.astype(np.int32), band_x, band_yc, dtype


def _geometry(texf, band_x, band_yc, dtype, **kw):
    return pg.launch_geometry(texf.shape[2], band_x, band_yc, 4 if dtype == "float32" else 2, **kw)


def _with_rows(geo, band_x, rows, stages, lag):
    """``geo`` with jobs of ``rows`` rows, ``stages`` stages and ``lag``."""
    return geo._replace(rows=rows, chunks=-(-band_x // rows), stages=stages, lag=lag)


def _jobs(n_patches, geo):
    """The kernel's jobs in its order: ``(patch, first row, first column)``."""
    per_patch = geo.chunks * geo.boxes
    for j in range(n_patches * per_patch):
        patch = j // per_patch
        rem = j - patch * per_patch
        chunk = rem // geo.boxes
        yield patch, chunk * geo.rows, (rem - chunk * geo.boxes) * geo.box_cols


def _copy_in_python(texf, offs, band_x, band_yc, geo):
    """The kernel's copy job by job.  TMA path: a ``rows`` x ``box_cols`` box
    of the texture at the clamped start plus the job's corner (zeros past the
    texture); from a start that is not on 16 bytes, a box one 16-byte word
    wider from the boundary below it, then shifted onto the stored box; the
    store clipped at the patch's edge.  Loop path: the rows of the chunk, the
    patch's width.  Elements no job writes stay NaN."""
    n, wp, hpc = texf.shape
    t = offs.shape[1]
    vec = 16 // texf.element_size()
    out = torch.full((n, t, band_x, band_yc), float("nan"), dtype=texf.dtype)
    for patch, row0, col0 in _jobs(n * t, geo):
        tex, tile = divmod(patch, t)
        x_lo = min(max(int(offs[tex, tile, 0]), 0), wp - band_x)
        y_lo = min(max(int(offs[tex, tile, 1]), 0), hpc - band_yc)
        y = y_lo + col0
        m = y % vec if geo.path == "tma" else 0
        width = geo.box_cols + (vec if m else 0)
        box = torch.zeros((geo.rows, width), dtype=texf.dtype)
        src = texf[tex, x_lo + row0:x_lo + row0 + geo.rows, y - m:y - m + width]
        box[:src.shape[0], :src.shape[1]] = src
        box = box[:, m:m + geo.box_cols]
        keep_r, keep_c = min(geo.rows, band_x - row0), min(geo.box_cols, band_yc - col0)
        out[tex, tile, row0:row0 + keep_r, col0:col0 + keep_c] = box[:keep_r, :keep_c]
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_launch_geometry_covers_each_patch_element_once(case):
    texf, offs, band_x, band_yc, dtype = _inputs(case)
    geo = _geometry(texf, band_x, band_yc, dtype)
    es = 4 if dtype == "float32" else 2
    want_loop = case.startswith("loop")
    assert geo.path == ("loop" if want_loop else "tma")
    if geo.path == "tma":  # the TMA's rules, as the kernel checks them
        assert 1 <= geo.box_cols and geo.box_cols * es + 16 <= pg.TMA_BOX * es
        assert geo.box_cols * es % 16 == 0
        assert 1 <= geo.rows <= pg.TMA_BOX and geo.rows * geo.box_cols * es <= max(
            pg.TMA_GEOMETRY[es][0], geo.box_cols * es)
        assert (geo.stages, geo.lag) == pg.TMA_GEOMETRY[es][1:]
        assert 0 <= geo.lag <= geo.stages - 2
        assert geo.boxes == -(-band_yc // (pg.TMA_BOX - 16 // es))
    else:
        assert (geo.boxes, geo.box_cols, geo.stages, geo.lag) == (1, band_yc, 0, 0)
        assert geo.rows <= pg.LOOP_ROWS
    count = torch.zeros((band_x, band_yc), dtype=torch.int32)
    for patch, row0, col0 in _jobs(1, geo):
        count[row0:row0 + geo.rows, col0:col0 + geo.box_cols] += 1
    assert int(count.min()) == 1 and int(count.max()) == 1
    # no job lies wholly past the patch, and the chunks are as even as they can be
    assert (geo.chunks - 1) * geo.rows < band_x and (geo.boxes - 1) * geo.box_cols < band_yc
    assert geo.chunks * geo.rows - band_x < geo.chunks


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_copy_equals_plain_version_and_jax_interpret(case):
    texf, offs, band_x, band_yc, dtype = _inputs(case, seed=1)
    tt = torch.from_numpy(texf).to(getattr(torch, dtype))
    to = torch.from_numpy(offs)
    geo = _geometry(texf, band_x, band_yc, dtype)
    copy = _copy_in_python(tt, to, band_x, band_yc, geo)
    ref = pg.gather_patches_ref(tt, to, band_x, band_yc)
    assert torch.equal(copy, ref)
    assert torch.equal(pg.gather_patches(tt, to, band_x, band_yc), ref)
    jax_out = jax_gather_patches(jnp.asarray(texf, dtype=getattr(jnp, dtype)), jnp.asarray(offs),
                                 band_x, band_yc, k_tiles=1, interpret=True)
    assert np.array_equal(copy.float().numpy(), np.asarray(jax_out.astype(jnp.float32)))


@pytest.mark.parametrize("geometry", ["loop", "tma, rows of 1, 2 stages", "tma, 7 rows, 8 stages"])
def test_chunked_copy_clamps_its_starts(geometry):
    """Starts outside the texture (the wrapper's ``validate=False``) are
    clamped inside the kernel, in every geometry."""
    texf, offs, band_x, band_yc, dtype = _inputs("f32 row of three boxes", seed=2)
    offs[0, 1] = (texf.shape[1] + 5, -7)
    offs[1, 2] = (-100, texf.shape[2])
    geo = _geometry(texf, band_x, band_yc, dtype, base_aligned=geometry != "loop")
    if geometry.startswith("tma, rows of 1"):
        geo = _with_rows(geo, band_x, 1, 2, 0)
    elif geometry.startswith("tma, 7 rows"):
        geo = _with_rows(geo, band_x, 7, 8, 6)
    assert geo.path == geometry.split(",")[0]
    tt, to = torch.from_numpy(texf), torch.from_numpy(offs)
    clamped = to.clone()
    clamped[..., 0].clamp_(0, texf.shape[1] - band_x)
    clamped[..., 1].clamp_(0, texf.shape[2] - band_yc)
    assert torch.equal(_copy_in_python(tt, to, band_x, band_yc, geo),
                       pg.gather_patches_ref(tt, clamped, band_x, band_yc))
    with pytest.raises(ValueError, match="leaves the texture"):
        pg.gather_patches(tt, to, band_x, band_yc)


def test_wrapper_takes_the_loop_path_for_an_unaligned_texture():
    """The path follows the layout the kernel is handed: a texture that does
    not start on 16 bytes goes to the loop, as do pitches of another size."""
    hpc, band_x, band_yc = 512, 20, 256
    assert pg.launch_geometry(hpc, band_x, band_yc, 4).path == "tma"
    assert pg.launch_geometry(hpc, band_x, band_yc, 4, base_aligned=False).path == "loop"
    assert pg.launch_geometry(hpc + 1, band_x, band_yc, 4).path == "loop"
    assert pg.launch_geometry(hpc, band_x, band_yc + 2, 2).path == "loop"
    assert pg.launch_geometry(hpc + 8, band_x, band_yc + 8, 2).path == "tma"
