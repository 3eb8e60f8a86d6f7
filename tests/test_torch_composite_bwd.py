"""Port parity: the composite backward of ``gmpi_tpu_torch``.

On the CPU ``composite_bwd`` runs its plain PyTorch version.  It is held
against the JAX package's XLA oracle ``composite_bwd`` (1e-4 abs/rel, the
gate of ``tests/test_pallas_warp.py``) and against both Pallas kernels that
the one CUDA kernel replaces, run by the interpreter: ``_composite_bwd_fat_kernel``
(``_COMP_BACKEND="fat"``) and ``_composite_bwd_kernel`` (``"block"``), with
``grad_tau`` and an ``n_live`` mask (2e-5 abs/rel: the same fp32 recurrence in
the same order).  The CUDA kernel itself is compared with the plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmpi_tpu.ops import pallas_warp as pw
from gmpi_tpu_torch.ops import fused_render as fr


def _stack(seed, v=2, n_l=7, h=8, w=16, opaque=(2,)):
    rng = np.random.default_rng(seed)
    warped = rng.random((v, n_l, 4, h, w)).astype(np.float32)
    for l in opaque:  # exactly opaque planes mid-stack: the factor is eps = 1e-10
        warped[:, l, 3] = 1.0
    scal = np.zeros((v, n_l, 6), np.float32)
    scal[:, :, 4] = rng.random((v, n_l)).astype(np.float32) + 0.5
    q = rng.random((v, h, w)).astype(np.float32) + 0.9
    cot = [rng.standard_normal((v, 3, h, w)).astype(np.float32)] + [
        rng.standard_normal((v, h, w)).astype(np.float32) for _ in range(3)]
    return warped, q, scal, cot


@pytest.mark.parametrize("with_gd,with_gp,with_gt", [(True, True, True), (False, False, False),
                                                     (True, False, True), (False, True, False)])
def test_composite_bwd_matches_jax_xla_oracle(with_gd, with_gp, with_gt):
    """Every combination of optional cotangents, with an exactly opaque mid
    plane (its alpha gradient is amplified by 1/eps)."""
    warped, q, scal, (gc, gd, gp, gt) = _stack(1)
    gd, gp, gt = (g if on else None for g, on in ((gd, with_gd), (gp, with_gp), (gt, with_gt)))
    dsc = scal[:, :, 4][:, :, None, None]
    ref = pw.composite_bwd(
        jnp.asarray(warped), jnp.asarray(dsc * q[:, None]), jnp.asarray(gc),
        None if gd is None else jnp.asarray(gd), None if gt is None else jnp.asarray(gt),
        g_disp=None if gp is None else jnp.asarray(gp),
        delta_disp=jnp.asarray((1.0 / dsc) / q[:, None]))
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    out = fr.composite_bwd(t(warped), t(q), t(scal), t(gc), t(gd), t(gp), t(gt))
    assert out.shape == (2, 7, 4, 8, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def _strip_major(x, ns, r8):
    """[V, (L, C,) NS*R8, 128] row-major pixels -> the Pallas strip-major
    [V, NS, (L, C,) R8, 128]."""
    lead = x.shape[1:-2]
    y = x.reshape(x.shape[0], *lead, ns, r8, 128)
    return np.moveaxis(y, -3, 1)


@pytest.mark.parametrize("backend", ["fat", "block"])
def test_composite_bwd_matches_jax_pallas_kernels(monkeypatch, backend):
    """Against each Pallas backend in interpret mode at v=1, L=5, ns=2,
    r8=32, all cotangents on, ``grad_tau`` and an ``n_live`` mask.  Strip 0
    sits behind two opaque planes, so the forward would have reached 2 planes
    there; the port's dead slots hold NaN (unwritten), JAX's finite garbage."""
    monkeypatch.setattr(pw, "_COMP_BACKEND", backend)
    v, n_l, ns, r8 = 1, 5, 2, 32
    warped, q, scal, (gc, gd, gp, gt) = _stack(0, v, n_l, ns * r8, 128, opaque=())
    warped[:, 0:2, 3, :r8] = 1.0
    n_live = np.array([[2, n_l]], np.int32)
    got = pw.composite_bwd_pallas(
        jnp.asarray(_strip_major(warped, ns, r8)), jnp.asarray(scal),
        jnp.asarray(_strip_major(q, ns, r8)),
        jnp.asarray(np.moveaxis(_strip_major(gc, ns, r8), 1, 2)),
        jnp.asarray(_strip_major(gd, ns, r8)), jnp.asarray(_strip_major(gt, ns, r8)),
        interpret=True, grad_tau=pw.GRAD_TAU, gp=jnp.asarray(_strip_major(gp, ns, r8)),
        n_live=jnp.asarray(n_live))
    if isinstance(got, tuple):
        got = got[0]
    ref = np.moveaxis(np.asarray(got), 1, 3).reshape(v, n_l, 4, ns * r8, 128)

    poisoned = warped.copy()
    poisoned[:, 2:, :, :r8] = np.nan
    n_live_px = np.repeat(n_live, r8, axis=1)[:, :, None].repeat(128, axis=2)
    t = torch.from_numpy
    out = fr.composite_bwd(t(poisoned), t(q), t(scal), t(gc), t(gd), t(gp), t(gt),
                           n_live=t(n_live_px), grad_tau=fr.GRAD_TAU).numpy()
    assert np.isfinite(out).all()
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)
    assert np.all(out[:, 2:, :, :r8] == 0.0) and np.all(ref[:, 2:, :, :r8] == 0.0)


def test_exact_zeros_behind_two_opaque_planes_and_not_behind_one():
    """S = T / M collapses to ~eps behind TWO opaque planes: exact zeros
    there; behind ONE it stays 1 and the planes behind keep their O(1)
    cotangents (they feed the occluder's alpha gradient)."""
    warped, q, scal, (gc, _, _, _) = _stack(3, v=1, n_l=5, opaque=(0, 1))
    t = torch.from_numpy
    d = fr.composite_bwd(t(warped), t(q), t(scal), t(gc), grad_tau=fr.GRAD_TAU)
    assert float(d[:, 2:].abs().max()) == 0.0
    assert float(d[:, 0].abs().max()) > 0.0
    warped[:, 1, 3] = 0.5
    d = fr.composite_bwd(t(warped), t(q), t(scal), t(gc), grad_tau=fr.GRAD_TAU)
    assert float(d[:, 1, 3].abs().min()) > 0.0
    # the occluder's alpha gradient carries the composite behind it at O(1)
    assert float(d[:, 0, 3].abs().max()) > 1e-2


def test_n_live_needs_grad_tau_and_cpu_launches_nothing():
    warped, q, scal, (gc, _, _, _) = _stack(4, v=1, n_l=3)
    t = torch.from_numpy
    before = dict(fr.LAUNCHES)
    with pytest.raises(ValueError, match="grad_tau"):
        fr.composite_bwd(t(warped), t(q), t(scal), t(gc),
                         n_live=torch.full((1, 8, 16), 3, dtype=torch.int32))
    a = fr.composite_bwd(t(warped), t(q), t(scal), t(gc))
    b = fr.composite_bwd_ref(t(warped), t(q), t(scal), t(gc))
    assert torch.equal(a, b) and fr.LAUNCHES == before


# -- the CUDA kernel's loop, repeated in Python -------------------------------------
# csrc/composite_bwd.cu cannot run here.  Its two passes (checkpoints of the
# transmittance every S planes, pass 2 chunk by chunk back to front with T
# rebuilt forward from the checkpoint) are repeated below, vectorised over the
# pixels, and must reproduce the plain version.  Keep the two in step.

def _kernel_constants():
    src = (Path(fr.__file__).resolve().parent.parent / "csrc" / "composite_bwd.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for name in ("kG", "kSlots")}


def _checkpoint_spacing(n_l, chunk, slots):
    """S of the kernel's entry point: the smallest multiple of the chunk that
    keeps a pixel's checkpoints within ``slots``."""
    chunks = -(-n_l // chunk)
    return chunk * -(-chunks // slots)


def _kernel_loop_in_python(warped, q, scal, gc, gd=None, gp=None, gt=None, n_live=None,
                           grad_tau=None, eps=fr.EPS, chunk=4, slots=32):
    """The kernel's arithmetic in its order: returns d_samp and the planes at
    which pass 2 rebuilt T forward from a checkpoint past the chunk start."""
    v, n_l, _, h, w = warped.shape
    s = _checkpoint_spacing(n_l, chunk, slots)
    assert -(-n_l // s) <= slots
    alpha = warped[:, :, 3]
    factor = lambda a: torch.clamp(1.0 - a, min=0.0) + eps  # noqa: E731
    limit = torch.full((v, h, w), n_l) if n_live is None else n_live.long().clamp(0, n_l)
    t, m = torch.ones((v, h, w)), torch.ones((v, h, w))
    live, run = limit.clone(), limit > 0
    ck = {}
    for c0 in range(0, n_l, chunk):  # pass 1
        if c0 % s == 0:
            ck[c0 // s] = t.clone()
        for l in range(c0, min(c0 + chunk, n_l)):
            run = run & (l < limit)
            if grad_tau is not None:
                cut = run & (live == limit) & (t / m < grad_tau)
                live = torch.where(cut, l, live)
                if gt is None:
                    run = run & ~cut
            one_m = factor(alpha[:, l])
            t, m = torch.where(run, t * one_m, t), torch.where(run, torch.minimum(m, one_m), m)
    out = torch.zeros_like(warped)
    qinv = None if gp is None else 1.0 / q
    gt_term = None if gt is None else gt * t
    u = torch.zeros((v, h, w))
    rebuilt = []
    live_max = int(live.max())
    for c0 in range(((live_max - 1) // chunk) * chunk if live_max else -1, -1, -chunk):  # pass 2
        k0 = c0 // s
        tc = ck[k0]
        for l in range(k0 * s, c0):
            rebuilt.append(l)
            tc = torch.where(l < live, tc * factor(alpha[:, l]), tc)
        tl = []
        for l in range(c0, min(c0 + chunk, n_l)):
            tl.append(tc)
            tc = torch.where(l < live, tc * factor(alpha[:, l]), tc)
        for l in range(min(c0 + chunk, n_l) - 1, c0 - 1, -1):
            r = warped[:, l]
            dsc = scal[:, l, 4, None, None]
            e = gc[:, 0] * r[:, 0] + gc[:, 1] * r[:, 1] + gc[:, 2] * r[:, 2]
            if gd is not None:
                e = e + gd * (dsc * q)
            if gp is not None:
                e = e + gp * ((1.0 / dsc) * qinv)
            one_m = factor(r[:, 3])
            wgt = r[:, 3] * tl[l - c0]
            d_alpha = tl[l - c0] * e - u / one_m
            if gt is not None:
                d_alpha = d_alpha - gt_term / one_m
            ok = l < live
            res = torch.cat([wgt[:, None] * gc, d_alpha[:, None]], dim=1)
            out[:, l] = torch.where(ok[:, None], res, 0.0)
            u = torch.where(ok, u + wgt * e, u)
    return out, rebuilt


def test_python_repeat_uses_the_kernels_constants():
    assert _kernel_constants() == {"kG": 4, "kSlots": 32}
    # every plane count the wrapper admits fits the checkpoint slots
    for n_l in (1, 3, 4, 5, 96, 127, 128, 129, 600, 2047, 2048):
        s = _checkpoint_spacing(n_l, 4, 32)
        assert s % 4 == 0 and -(-n_l // s) <= 32
    assert _checkpoint_spacing(600, 4, 32) == 20 and _checkpoint_spacing(96, 4, 32) == 4


@pytest.mark.parametrize("n_l,chunk,slots,opaque,optional", [
    (1, 4, 32, (), True),
    (3, 4, 32, (1,), False),
    (5, 4, 32, (1, 3), True),
    (9, 8, 32, (2, 5), True),
    (33, 8, 32, (7, 8), True),
    (33, 4, 2, (7, 8), False),       # S = 20: pass 2 rebuilds T past checkpoints
    (40, 8, 2, (20,), True),         # S = 24
    (96, 8, 32, (40,), False),
    (75, 2, 3, (), True),            # S = 26
], ids=lambda x: str(x).replace(" ", ""))
def test_kernel_loop_matches_plain_version(n_l, chunk, slots, opaque, optional):
    """The checkpointed loop against ``composite_bwd_ref`` with ``grad_tau`` and
    random ``n_live`` (NaN in dead slots), and without masks: the transmittance
    rebuilt from checkpoints is the plain version's, bitwise, so every output
    agrees to the last bits (1e-6 of max per field)."""
    warped, q, scal, (gc, gd, gp, gt) = _stack(n_l, v=2, n_l=n_l, opaque=opaque)
    warped[:, :, 3] *= 0.2
    for l in opaque:
        warped[:, l, 3] = 1.0
    t = torch.from_numpy
    args = [t(warped), t(q), t(scal), t(gc)] + [t(x) if optional else None for x in (gd, gp, gt)]
    rng = np.random.default_rng(n_l)
    n_live = t(rng.integers(0, n_l + 1, (2, 8, 16)).astype(np.int32))
    planes = torch.arange(n_l).reshape(1, n_l, 1, 1, 1)
    poisoned = torch.where(planes < n_live[:, None, None], args[0], float("nan"))
    rebuilt_any = False
    for x, kw in ((poisoned, dict(n_live=n_live, grad_tau=fr.GRAD_TAU)),
                  (args[0], dict(grad_tau=fr.GRAD_TAU)), (args[0], {})):
        out, rebuilt = _kernel_loop_in_python(x, *args[1:], chunk=chunk, slots=slots, **kw)
        ref = fr.composite_bwd_ref(x, *args[1:], **kw)
        assert torch.isfinite(out).all()
        for sl in (slice(0, 3), slice(3, 4)):
            scale = float(ref[:, :, sl].abs().max())
            assert float((out[:, :, sl] - ref[:, :, sl]).abs().max()) <= 1e-6 * scale
        rebuilt_any |= bool(rebuilt)
    assert rebuilt_any == (_checkpoint_spacing(n_l, chunk, slots) > chunk)


@pytest.mark.parametrize("opaque", [(2,), (3, 4), (9, 10)], ids=["one", "two_in_a_chunk", "two_across"])
def test_kernel_loop_matches_jax_xla_oracle_with_a_cut_inside_a_chunk(opaque):
    """With every cotangent and ``grad_tau``: behind two opaque planes the cut
    falls inside a chunk (planes 5 and 11 of chunks of 4); against the JAX
    oracle (1e-4, the gate of ``tests/test_pallas_warp.py``) wherever no plane
    is cut, and exact zeros behind the cut."""
    warped, q, scal, (gc, gd, gp, gt) = _stack(7, v=1, n_l=16, opaque=opaque)
    t = torch.from_numpy
    out, _ = _kernel_loop_in_python(t(warped), t(q), t(scal), t(gc), t(gd), t(gp), t(gt),
                                    grad_tau=fr.GRAD_TAU)
    if len(opaque) == 2:
        assert float(out[:, opaque[1] + 1:].abs().max()) == 0.0
        assert float(out[:, :opaque[1] + 1].abs().max()) > 0.0
    dsc = scal[:, :, 4][:, :, None, None]
    ref = np.asarray(pw.composite_bwd(
        jnp.asarray(warped), jnp.asarray(dsc * q[:, None]), jnp.asarray(gc), jnp.asarray(gd),
        jnp.asarray(gt), g_disp=jnp.asarray(gp), delta_disp=jnp.asarray((1.0 / dsc) / q[:, None])))
    keep = slice(0, opaque[1] + 1) if len(opaque) == 2 else slice(None)
    np.testing.assert_allclose(out.numpy()[:, keep], ref[:, keep], atol=1e-4, rtol=1e-4)
